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

pytest.importorskip("jax", reason="compares the port with the JAX package")

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
        device="cpu",
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
    """The port must import and render with JAX unavailable: every module,
    the scene, pipeline, framebuffer, display, utility and io layers
    among them."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['f_renderer_tpu'] = None\n"
        "import f_renderer_tpu_torch as p\n"
        "import importlib, pkgutil\n"
        "for m in pkgutil.walk_packages(p.__path__, 'f_renderer_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for name in ('voxel.raycast', 'pipeline.raster_portable', 'framebuffer', 'display', 'bench_scenes', "
        "'utils.metrics', 'io.obj', 'io.image', 'io.scene_io'):\n"
        "    assert 'f_renderer_tpu_torch.' + name in sys.modules, name\n"
        "frame, depth, _ = p.make_phong_scene(64, 48, clip_cap=16, device='cpu').render()\n"
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
    scene = port_scene.make_phong_scene(W, H, clip_cap=16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dataclasses.replace(scene, device="cuda")


def _default_device_calls():
    from f_renderer_tpu_torch.camera import Camera
    from f_renderer_tpu_torch.shaders.texture import TextureStack
    from f_renderer_tpu_torch.voxel import VoxelRenderConfig, render_voxel_frame

    tex = np.zeros((1, 4, 4, 4), np.float32)
    return {
        "make_phong_scene": lambda: port_scene.make_phong_scene(W, H),
        "Camera.create": lambda: Camera.create([0.0, 0.0, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        "TextureStack.create": lambda: TextureStack.create([tex[0]]),
        "TextureStack.from_data": lambda: TextureStack.from_data(tex, np.array([[4, 4]])),
        "TextureStack.dummy": lambda: TextureStack.dummy(),
        "scene_from_arrays": lambda: convert.scene_from_arrays(
            [], {}, {"view_pos": np.zeros(3, np.float32)}, "flat", dict(width=W, height=H)
        ),
        "triangles_from_arrays": lambda: convert.triangles_from_arrays({}),
        "render_voxel_frame": lambda: render_voxel_frame(
            np.zeros((2, 2, 2, 4), np.uint8), np.zeros((2, 2, 2), bool), np.zeros(3, np.float32),
            np.eye(4, dtype=np.float32), VoxelRenderConfig(width=8, height=8, level=0),
        ),
    }


@pytest.mark.parametrize(
    "name",
    ["make_phong_scene", "Camera.create", "TextureStack.create", "TextureStack.from_data",
     "TextureStack.dummy", "scene_from_arrays", "triangles_from_arrays", "render_voxel_frame"],
)
def test_default_device_constructor_raises_without_cuda(monkeypatch, name):
    """Every public constructor defaults to the card: without one it raises
    and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _default_device_calls()[name]()


def test_cpu_render_launches_no_kernel():
    """CPU tensors take the plain versions on both render paths: no wrapper
    counts a launch."""
    from f_renderer_tpu_torch import kernels

    wrappers = (kernels.fused_raster, kernels.raster_planes, kernels.sample_bilinear, kernels.voxel_march)
    scene = port_scene.make_phong_scene(W, H, clip_cap=16, device="cpu")
    scene.render()
    dataclasses.replace(scene, config=dataclasses.replace(scene.config, fused_shade=False)).render()
    assert [k.launches for k in wrappers] == [0, 0, 0, 0]
