"""The port's main path end to end, and its independence from JAX and CUDA.

``Scene.render()`` of the port against the JAX package's ``Scene.render()``
(jnp backend) on a phong1080-shaped scene cut to 128×96 — a UV sphere, two
cubes, three checker textures, three draws — within the golden budget: at
most 1% of pixels beyond 2 u8 (tests/test_render.py:64-68).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu.camera import Camera as JaxCamera
from f_renderer_tpu.math import set_rotate
from f_renderer_tpu.scene import (
    make_checker_texture,
    make_cube,
    make_phong_scene,
    make_uv_sphere,
)
from f_renderer_tpu_torch import convert
from f_renderer_tpu_torch import scene as port_scene

W, H = 128, 96
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def phong_scene_pair(shader, angle):
    sphere = make_uv_sphere(12, 24)
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.6, 0.0, 0.0], np.float32)
    cube2 = make_cube(0.8)
    cube2["pos"] = cube2["pos"] + np.array([-1.6, 0.0, 0.0], np.float32)
    cam = JaxCamera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    js = make_phong_scene(
        W, H, clip_cap=64, meshes=[sphere, cube, cube2],
        textures=[make_checker_texture(64, 8), make_checker_texture(64, 4), make_checker_texture(48, 6)],
        camera=cam, shader=shader,
    )
    js = dataclasses.replace(
        js, vs_uniform=dict(js.vs_uniform, model=set_rotate(np.array([0.0, 1.0, 0.0]), angle))
    )
    stack = js.ps_uniform["textures"]
    ps = convert.scene_from_arrays(
        [{k: np.asarray(v) for k, v in d.items()} for d in js.draws],
        {k: np.asarray(v) for k, v in js.vs_uniform.items()},
        {
            "view_pos": np.asarray(js.ps_uniform["view_pos"]),
            "textures": {"data": np.asarray(stack.data), "dims": np.asarray(stack.dims)},
        },
        shader,
        dict(width=W, height=H, background=(30, 30, 30, 255), clip_cap=64),
    )
    return js, ps


@pytest.mark.parametrize("shader, angle", [("phong", 0.1), ("gouraud", 0.7)])
def test_scene_render_matches_jax(shader, angle):
    js, ps = phong_scene_pair(shader, angle)
    frame_j, depth_j, stats_j = js.render()
    frame_p, depth_p, stats_p = ps.render()
    frame_j, depth_j = np.asarray(frame_j), np.asarray(depth_j)
    frame_p, depth_p = frame_p.numpy(), depth_p.numpy()
    assert frame_p.shape == (H, W, 4) and frame_p.dtype == np.uint8
    assert int(stats_p["num_clipped"]) == int(stats_j["num_clipped"])
    diff = np.abs(frame_p.astype(np.int32) - frame_j.astype(np.int32)).max(axis=-1)
    assert (diff > 2).mean() <= 0.01, f"{(diff > 2).mean():.2%} pixels beyond 2 u8"
    both = (depth_p > 0) & (depth_j > 0)
    assert both.sum() > 1500
    np.testing.assert_allclose(depth_p[both], depth_j[both], rtol=1e-5)


def test_package_imports_without_jax():
    """The port must import and render with JAX unavailable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['f_renderer_tpu'] = None\n"
        "import f_renderer_tpu_torch as p\n"
        "from f_renderer_tpu_torch import convert, kernels\n"
        "frame, depth, _ = p.make_phong_scene(64, 48, clip_cap=16).render()\n"
        "assert frame.shape == (48, 64, 4)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'f_renderer_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=300)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_scene.make_phong_scene(W, H, device="cuda")
    scene = port_scene.make_phong_scene(W, H, clip_cap=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dataclasses.replace(scene, device="cuda")


def test_cpu_render_launches_no_kernel():
    from f_renderer_tpu_torch import kernels

    before = kernels.fused_raster.launches
    port_scene.make_phong_scene(W, H, clip_cap=16).render()
    assert kernels.fused_raster.launches == before == 0
