"""Plain fused kernel (K1 with the K2 sampler) vs the JAX package's kernel.

The port's ``render_fused_plain`` runs on the JAX package's own
TriangleBuffer (carried across with ``convert``) and is held to the bar of
tests/test_fused.py:15-55 against both JAX ``render_fused_pallas``
(interpret mode) and ``rasterize_jnp`` + the jnp pipeline: winner ids
bit-equal, depth within rtol 2.4e-7, colour within 2 u8 with at most 0.2%
of pixels at 2.

The JAX side runs in a subprocess with ``--xla_cpu_max_isa=AVX``. Under jit
XLA's CPU backend contracts ``a*b + c`` into fused multiply-adds where the
instruction set has them; the port, like its CUDA kernel (built with
``--fmad=false``), rounds every multiply and add. Capping the ISA below
FMA makes the reference round as the port does, so near-tie pixels compare
like with like. This file is that subprocess's script too.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import convert
from f_renderer_tpu_torch.pipeline import fused
from f_renderer_tpu_torch.pipeline.render import RenderConfig, build_triangles
from f_renderer_tpu_torch.scene import make_checker_texture, make_cube
from f_renderer_tpu_torch.scene import make_phong_scene as make_port_scene

W, H = 128, 96
TRI_FIELDS = ("spi", "spf", "rhw", "ctx", "top_left", "valid", "order", "ps_index")

# name → (shader, meshes, wide texture, config overrides). Together: all four
# epilogue kinds, the (16, 128) tile, the coarse/spill ranges (bin_k=1), the
# tiny-scene th=128 default tile, and a 192-px texture (two TPU lane pages).
CASES = {
    "phong_two_cubes_wide_texture": ("phong", 2, True, dict(tile=(16, 128))),
    "gouraud": ("gouraud", 1, False, dict(tile=(16, 128))),
    "textured_default_tile": ("textured", 1, False, {}),
    "flat_bin_k1": ("flat", 2, False, dict(tile=(16, 128), bin_k=1)),
}


def case_scene(name, make_phong_scene, **kw):
    """Case ``name`` built by either package's ``make_phong_scene`` (the mesh
    and texture builders are numpy and identical in both)."""
    shader, n_meshes, wide, over = CASES[name]
    meshes = [make_cube()]
    if n_meshes == 2:
        cube2 = make_cube(0.7)
        cube2["pos"] = cube2["pos"] + np.array([0.9, 0.2, 0.0], np.float32)
        meshes.append(cube2)
    textures = [make_checker_texture(192, 12)] * n_meshes if wide else None
    scene = make_phong_scene(W, H, meshes=meshes, textures=textures, clip_cap=32, shader=shader, **kw)
    return dataclasses.replace(scene, config=dataclasses.replace(scene.config, **over))


def write_reference(path):
    """Run every case through the JAX package and save what the tests read."""
    from f_renderer_tpu.pipeline.fused import render_fused_pallas
    from f_renderer_tpu.pipeline.raster_jnp import rasterize_jnp
    from f_renderer_tpu.pipeline.render import build_triangles
    from f_renderer_tpu.scene import make_phong_scene

    out = {}
    for name in CASES:
        scene = case_scene(name, make_phong_scene)
        cfg = scene.config
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, cfg)
        for f in TRI_FIELDS:
            out[f"{name}/tri/{f}"] = np.asarray(getattr(tri, f))
        winner_j, depth_j = rasterize_jnp(tri, W, H, tile=cfg.tile)
        frame_f, depth_f, winner_f = render_fused_pallas(
            tri, scene.pixel_shader, scene.ps_uniform, cfg, interpret=True
        )
        frame_j, _, _ = scene.render()  # the jnp pipeline, end to end
        stack = scene.ps_uniform["textures"]
        out.update(
            {
                f"{name}/winner_jnp": np.asarray(winner_j),
                f"{name}/depth_jnp": np.asarray(depth_j),
                f"{name}/frame_fused": np.asarray(frame_f),
                f"{name}/depth_fused": np.asarray(depth_f),
                f"{name}/winner_fused": np.asarray(winner_f),
                f"{name}/frame_jnp": np.asarray(frame_j),
                f"{name}/tex_data": np.asarray(stack.data),
                f"{name}/tex_dims": np.asarray(stack.dims),
                f"{name}/view_pos": np.asarray(scene.ps_uniform["view_pos"]),
            }
        )
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_reference") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(path)],
        env=env, check=True, timeout=600,
    )
    with np.load(path) as data:
        return dict(data)


def frame_bar(got, want, edge_budget=0.002):
    """≤ 2 u8 everywhere, 2-u8 differences on at most ``edge_budget`` pixels."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    assert diff.max() <= 2, f"max u8 diff {diff.max()}"
    assert (diff > 1).mean() <= edge_budget, f"{(diff > 1).mean():.2%} pixels at 2 u8"


def port_inputs(name, ref):
    shader, _, _, over = CASES[name]
    tri = convert.triangles_from_arrays({f: ref[f"{name}/tri/{f}"] for f in TRI_FIELDS}, device="cpu")
    scene = convert.scene_from_arrays(
        draws=[],
        vs_uniform={},
        ps_uniform={
            "view_pos": ref[f"{name}/view_pos"],
            "textures": {"data": ref[f"{name}/tex_data"], "dims": ref[f"{name}/tex_dims"]},
        },
        shader_kind=shader,
        config=dict(width=W, height=H, background=(30, 30, 30, 255), clip_cap=32, **over),
        device="cpu",
    )
    return tri, scene


@pytest.mark.parametrize("name", list(CASES))
def test_plain_fused_matches_jax(name, ref):
    tri, scene = port_inputs(name, ref)
    frame, depth, winner = fused.render_fused(
        tri, scene.pixel_shader, scene.ps_uniform, scene.config
    )
    frame, depth, winner = frame.numpy(), depth.numpy(), winner.numpy()
    assert frame.shape == (H, W, 4) and frame.dtype == np.uint8
    np.testing.assert_array_equal(winner, ref[f"{name}/winner_fused"])
    np.testing.assert_array_equal(winner, ref[f"{name}/winner_jnp"])
    np.testing.assert_allclose(depth, ref[f"{name}/depth_fused"], rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(depth, ref[f"{name}/depth_jnp"], rtol=2.4e-7, atol=0)
    frame_bar(frame, ref[f"{name}/frame_fused"])
    frame_bar(frame, ref[f"{name}/frame_jnp"])
    assert (frame[..., 0] != 30).sum() > 300  # real coverage


def test_prep_heuristics(ref):
    """The default tile becomes (128, 128) for a tiny scene; an explicit
    (32, 128) is honoured (the JAX package overrides it, ROADMAP faults);
    bin_k=1 fills the coarse and spill ranges."""
    tri, _ = port_inputs("textured_default_tile", ref)
    cfg = RenderConfig(width=W, height=H)
    assert fused.prep_fused(tri, cfg).th == 128
    assert fused.prep_fused(tri, dataclasses.replace(cfg, tile=(32, 128))).th == 32
    tri, _ = port_inputs("flat_bin_k1", ref)
    prep = fused.prep_fused(tri, RenderConfig(width=W, height=H, tile=(16, 128), bin_k=1))
    off = prep.off.tolist()
    ntiles = 6
    assert off[-1] > off[ntiles], "bin_k=1 put no pair in the coarse or spill ranges"


def test_cpu_tensors_take_plain_version_without_launch(ref):
    """On CPU tensors the wrapper runs the plain version: no kernel launch."""
    from f_renderer_tpu_torch import kernels

    tri, scene = port_inputs("gouraud", ref)
    before = kernels.fused_raster.launches
    prep = fused.prep_fused(tri, scene.config)
    got = fused.render_fused_prepared(prep, scene.pixel_shader, scene.ps_uniform, scene.config)
    want = fused.render_fused_plain(prep, scene.pixel_shader, scene.ps_uniform, scene.config)
    assert kernels.fused_raster.launches == before == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_custom_or_oversized_shading_raises(monkeypatch):
    """Where the JAX package leaves the fused path (a shader without
    ``fused_kind``, a texture stack past the budget) the port now routes to
    ``rasterize_interp`` + ``shade_from_planes`` too, and renders; within
    the budget the builtin shader stays on the fused path."""
    from f_renderer_tpu_torch.pipeline import render as render_mod

    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)

        monkeypatch.setattr(render_mod, name, wrapped)

    spy("render_fused", render_mod.render_fused)
    spy("rasterize_interp", render_mod.rasterize_interp)
    scene = make_port_scene(W, H, clip_cap=16, device="cpu")

    def custom(u, ctx, ps_index):
        uv = ctx["uv"]
        return torch.stack([uv[0], uv[1], torch.zeros_like(uv[0]), torch.ones_like(uv[0])])

    assert fused.fused_path_ok(scene.pixel_shader, scene.ps_uniform)
    fused_frame, _, _ = scene.render()  # within the budget: the fused path
    assert calls == ["render_fused"]
    frame, _, _ = dataclasses.replace(scene, pixel_shader=custom).render()
    assert calls[1:] == ["rasterize_interp"]
    assert frame.shape == (H, W, 4) and (frame[..., 2] == 0).sum() > 300  # shaded by `custom`
    monkeypatch.setattr(fused, "PACKED_VMEM_BUDGET", 1024)
    assert scene.ps_uniform["textures"].packed_nbytes > 1024
    assert not fused.fused_path_ok(scene.pixel_shader, scene.ps_uniform)
    big_frame, _, _ = scene.render()
    assert calls[2:] == ["rasterize_interp"]
    # The builtin phong shader on the interpolated planes gives the fused frame.
    frame_bar(big_frame.numpy(), fused_frame.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(name):
    """The CUDA kernel against its plain version on the same card, and
    ``Scene.render()`` on the card launching it once. Needs no JAX: run it
    on the card with ``python -m pytest --noconftest -m cuda
    tests/test_torch_fused.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from f_renderer_tpu_torch import kernels

    scene = case_scene(name, make_port_scene, device="cuda")
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    prep = fused.prep_fused(tri, scene.config)
    args = (prep, scene.pixel_shader, scene.ps_uniform, scene.config)
    before = kernels.fused_raster.launches
    got = [t.cpu().numpy() for t in fused.render_fused_prepared(*args)]
    assert kernels.fused_raster.launches == before + 1
    want = [t.cpu().numpy() for t in fused.render_fused_plain(*args)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=2.4e-7, atol=0)
    frame_bar(got[0], want[0])
    frame, _, _ = scene.render()
    assert kernels.fused_raster.launches == before + 2
    np.testing.assert_array_equal(frame.cpu().numpy(), got[0])


if __name__ == "__main__":
    write_reference(sys.argv[1])
