"""The port's portable rasterizer and backend against the JAX package's jnp
path, and per-pixel shading (``shade_vectorized=False``).

- ``rasterize_portable`` on the JAX package's TriangleBuffer of the
  test_torch_geometry scene (clipped faces included) against
  ``rasterize_jnp``: winner ids bit-equal, depth within rtol 2.4e-7; a
  sub-rectangle (``origin`` / ``full_size``) against the crop of the full
  frame and against JAX's sub-rectangle.
- ``render_frame`` with ``backend="portable"`` (the port's own geometry,
  ``rasterize_portable``, ``shade_deferred``) against the JAX package's jnp
  pipeline: colour within 2 u8 with at most 0.2% of pixels at 2, depth
  within rtol 2.4e-7.
- ``shade_vectorized=False`` with a one-pixel custom shader against the
  vectorised builtin (equal) and JAX's ``shade_vectorized=False`` with the
  same one-pixel shader (the colour bar).

The JAX side runs in a subprocess with ``--xla_cpu_max_isa=AVX`` so XLA
makes no fused multiply-adds (see test_torch_fused.py). This file is that
subprocess's script too.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import convert, kernels
from f_renderer_tpu_torch.pipeline.raster_portable import rasterize_portable
from f_renderer_tpu_torch.scene import make_checker_texture, make_cube, make_uv_sphere
from test_torch_fused import frame_bar

W, H = 128, 96
TRI_FIELDS = ("spi", "spf", "rhw", "ctx", "top_left", "valid", "order", "ps_index")
SUB = dict(origin=(30, 40), size=(50, 60))  # rows [30, 80) x columns [40, 100)
BACKGROUND = (30, 30, 30, 255)


def geometry_scene():
    """test_torch_geometry's scene: two cubes and a soup that crosses the
    frustum planes (clipped faces in path B)."""
    from f_renderer_tpu.camera import Camera
    from f_renderer_tpu.scene import make_phong_scene

    rng = np.random.default_rng(7)
    cube2 = make_cube(0.7)
    cube2["pos"] = cube2["pos"] + np.array([0.9, 0.2, 0.0], np.float32)
    n = 30
    centers = rng.uniform([-2.0, -1.5, -1.0], [2.0, 2.5, 3.5], (n, 3))
    soup = {
        "pos": (centers[:, None, :] + rng.uniform(-0.6, 0.6, (n, 3, 3))).astype(np.float32),
        "uv": rng.random((n, 3, 2)).astype(np.float32),
        "normal": rng.standard_normal((n, 3, 3)).astype(np.float32),
    }
    cam = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    return make_phong_scene(W, H, meshes=[make_cube(), cube2, soup], camera=cam, clip_cap=24)


def meshes(shader):
    """A sphere and a cube (two cubes for the flat shader, which reads a
    per-face colour the sphere lacks); no face is clipped."""
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.4, 0.0, 0.0], np.float32)
    return [make_cube(1.2) if shader == "flat" else make_uv_sphere(10, 20), cube]


def render_scene(shader, make_phong_scene, camera):
    return make_phong_scene(
        W, H, meshes=meshes(shader), textures=[make_checker_texture(64, 8), make_checker_texture(48, 6)],
        camera=camera, clip_cap=16, shader=shader,
    )


def write_reference(path):
    from f_renderer_tpu.camera import Camera
    from f_renderer_tpu.pipeline.raster_jnp import rasterize_jnp
    from f_renderer_tpu.pipeline.render import build_triangles
    from f_renderer_tpu.scene import make_phong_scene

    out = {}
    scene = geometry_scene()
    tri, stats = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    out.update({f"tri/{f}": np.asarray(getattr(tri, f)) for f in TRI_FIELDS})
    out["num_clipped"] = np.asarray(stats["num_clipped"])
    out["winner"], out["depth"] = (np.asarray(a) for a in rasterize_jnp(tri, W, H))
    (y0, x0), (h, w) = SUB["origin"], SUB["size"]
    out["winner_sub"], out["depth_sub"] = (
        np.asarray(a) for a in rasterize_jnp(tri, w, h, tile=(16, 32), origin=(y0, x0), full_size=(H, W))
    )
    cam = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    for shader in ("phong", "gouraud", "flat"):
        s = render_scene(shader, make_phong_scene, cam)
        frame, depth, _ = s.render()
        out[f"{shader}/frame"], out[f"{shader}/depth"] = np.asarray(frame), np.asarray(depth)
        stack = s.ps_uniform["textures"]
        out[f"{shader}/tex_data"], out[f"{shader}/tex_dims"] = np.asarray(stack.data), np.asarray(stack.dims)
        out[f"{shader}/view_pos"] = np.asarray(s.ps_uniform["view_pos"])
        for i, d in enumerate(s.draws):
            for k, v in d.items():
                out[f"{shader}/draw{i}/{k}"] = np.asarray(v)
        for k, v in s.vs_uniform.items():
            out[f"{shader}/vs/{k}"] = np.asarray(v)
        if shader != "phong":
            one = dataclasses.replace(
                s, pixel_shader=ONE_PIXEL_JAX[shader],
                config=dataclasses.replace(s.config, shade_vectorized=False),
            )
            out[f"{shader}/frame_one_pixel"] = np.asarray(one.render()[0])
    np.savez(path, **out)


# One-pixel shaders (a pixel's varyings in, its rgba out), scalar-style: they
# do not broadcast over the frame. The same code for both packages' tensors.
def _gouraud_one_jax(u, ctx, ps_index):
    import jax.numpy as jnp

    return jnp.concatenate([ctx["color"], jnp.ones((1,), jnp.float32)])


ONE_PIXEL_JAX = {"gouraud": _gouraud_one_jax, "flat": lambda u, ctx, ps_index: ctx["color"]}
ONE_PIXEL = {
    "gouraud": lambda u, ctx, ps_index: torch.cat([ctx["color"], torch.ones(1)]),
    "flat": lambda u, ctx, ps_index: ctx["color"],
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_portable") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env, check=True, timeout=600)
    with np.load(path) as data:
        return dict(data)


def jax_tri(ref):
    return convert.triangles_from_arrays({f: ref[f"tri/{f}"] for f in TRI_FIELDS}, device="cpu")


def port_scene(ref, shader, **config):
    n_draws = len(meshes(shader))
    keys = ("pos", "color") if shader == "flat" else ("pos", "uv", "normal")
    return convert.scene_from_arrays(
        [{k: ref[f"{shader}/draw{i}/{k}"] for k in keys} for i in range(n_draws)],
        {k: ref[f"{shader}/vs/{k}"] for k in ("model", "view", "proj")}
        | ({"view_pos": ref[f"{shader}/vs/view_pos"]} if shader == "gouraud" else {}),
        {"view_pos": ref[f"{shader}/view_pos"],
         "textures": {"data": ref[f"{shader}/tex_data"], "dims": ref[f"{shader}/tex_dims"]}},
        shader, dict(width=W, height=H, background=BACKGROUND, clip_cap=16, **config), device="cpu",
    )


def test_portable_matches_rasterize_jnp(ref):
    assert int(ref["num_clipped"]) > 0
    winner, depth = rasterize_portable(jax_tri(ref), W, H)
    assert winner.dtype == torch.int32 and winner.shape == (H, W)
    np.testing.assert_array_equal(winner.numpy(), ref["winner"])
    np.testing.assert_allclose(depth.numpy(), ref["depth"], rtol=2.4e-7, atol=0)
    assert (ref["winner"] >= 0).sum() > 1000


def test_portable_sub_rectangle_is_the_crop(ref):
    tri = jax_tri(ref)
    (y0, x0), (h, w) = SUB["origin"], SUB["size"]
    full_w, full_d = rasterize_portable(tri, W, H, tile=(16, 32))
    sub_w, sub_d = rasterize_portable(tri, w, h, tile=(16, 32), origin=(y0, x0), full_size=(H, W))
    assert torch.equal(sub_w, full_w[y0 : y0 + h, x0 : x0 + w])
    assert torch.equal(sub_d, full_d[y0 : y0 + h, x0 : x0 + w])
    np.testing.assert_array_equal(sub_w.numpy(), ref["winner_sub"])
    np.testing.assert_allclose(sub_d.numpy(), ref["depth_sub"], rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("shader", ["phong", "gouraud", "flat"])
def test_portable_backend_matches_jax_jnp_pipeline(ref, shader):
    """The port's portable backend end to end (its own geometry) against
    the JAX package's jnp pipeline, launching no kernel."""
    scene = port_scene(ref, shader, backend="portable")
    before = [k.launches for k in (kernels.fused_raster, kernels.raster_planes, kernels.sample_bilinear)]
    frame, depth, _ = scene.render()
    assert [k.launches for k in (kernels.fused_raster, kernels.raster_planes, kernels.sample_bilinear)] == before
    frame_bar(frame.numpy(), ref[f"{shader}/frame"])
    np.testing.assert_allclose(depth.numpy(), ref[f"{shader}/depth"], rtol=2.4e-7, atol=0)
    assert (depth.numpy() > 0).sum() > 1000


def test_portable_backend_matches_kernel_path(ref):
    """Both backends of the port give the same frame on the CPU."""
    scene = port_scene(ref, "phong")
    frame_k, depth_k, _ = scene.render()
    frame_p, depth_p, _ = dataclasses.replace(
        scene, config=dataclasses.replace(scene.config, backend="portable")).render()
    frame_bar(frame_p.numpy(), frame_k.numpy())
    assert torch.equal(depth_p, depth_k)


@pytest.mark.parametrize("shader", ["gouraud", "flat"])
@pytest.mark.parametrize("backend", ["portable", "kernels"])
def test_one_pixel_shader_matches_vectorized_builtin(ref, shader, backend):
    """``shade_vectorized=False`` calls a scalar-style shader once a pixel;
    it gives the builtin's vectorised frame, and JAX's per-pixel frame."""
    vectorized = port_scene(ref, shader, backend=backend, fused_shade=False)
    want, _, _ = vectorized.render()
    one = dataclasses.replace(
        vectorized, pixel_shader=ONE_PIXEL[shader],
        config=dataclasses.replace(vectorized.config, shade_vectorized=False),
    )
    got, _, _ = one.render()
    assert torch.equal(got, want)
    frame_bar(got.numpy(), ref[f"{shader}/frame_one_pixel"])
    if shader == "gouraud":
        with pytest.raises(RuntimeError):  # the scalar-style shader cannot take the whole frame
            dataclasses.replace(one, config=vectorized.config).render()


if __name__ == "__main__":
    write_reference(sys.argv[1])
