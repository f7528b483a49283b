"""Port geometry stage, pack_setup and bin_pairs vs the JAX package.

One seeded scene of three draws (two cubes and a random soup that crosses
the frustum planes), through both packages' ``build_triangles``:

- faces inside the frustum (path A): ``spi``, ``valid``, ``order``,
  ``ps_index`` and ``top_left`` exact; ``spf``, ``rhw`` and ``ctx`` within
  rtol 1e-6;
- clipped faces (path B): ``atan2`` and XLA's fused multiply-adds move a
  clipped vertex by ulps, which can reorder the angle sort and so the fan
  (SURVEY.md §7.3.5). They get the golden budget: the same slots valid, in
  the same order, and both buffers render (through the port's plain fused
  path) to frames with at most 1% of pixels beyond 2 u8
  (tests/test_render.py:64-68).

``pack_setup`` and ``bin_pairs`` are integer work and must match exactly.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax", reason="compares the port with the JAX package")

from f_renderer_tpu.camera import Camera
from f_renderer_tpu.pipeline import raster_pallas as jraster
from f_renderer_tpu.pipeline.render import build_triangles as jax_build
from f_renderer_tpu.scene import make_cube, make_phong_scene
from f_renderer_tpu_torch import convert
from f_renderer_tpu_torch.pipeline import fused, raster
from f_renderer_tpu_torch.pipeline.geometry import MAX_FAN
from f_renderer_tpu_torch.pipeline.render import build_triangles as port_build

W, H = 128, 96
CLIP_CAP = 24


def scene_state():
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
    js = make_phong_scene(W, H, meshes=[make_cube(), cube2, soup], camera=cam, clip_cap=CLIP_CAP)
    stack = js.ps_uniform["textures"]
    ps = convert.scene_from_arrays(
        [{k: np.asarray(v) for k, v in d.items()} for d in js.draws],
        {k: np.asarray(v) for k, v in js.vs_uniform.items()},
        {
            "view_pos": np.asarray(js.ps_uniform["view_pos"]),
            "textures": {"data": np.asarray(stack.data), "dims": np.asarray(stack.dims)},
        },
        "phong",
        dict(width=W, height=H, background=(30, 30, 30, 255), clip_cap=CLIP_CAP),
        device="cpu",
    )
    return js, ps


@pytest.fixture(scope="module")
def built():
    js, ps = scene_state()
    jt, jstats = jax_build(js.draws, js.vertex_shader, js.vs_uniform, js.config)
    pt, pstats = port_build(ps.draws, ps.vertex_shader, ps.vs_uniform, ps.config)
    faces = [int(d["pos"].shape[0]) for d in js.draws]
    return jt, jstats, pt, pstats, faces


def slot_paths(faces):
    """Boolean (M,) masks of the path-A and path-B slots, draw by draw."""
    a, b = [], []
    for f in faces:
        a += [True] * f + [False] * (CLIP_CAP * MAX_FAN)
        b += [False] * f + [True] * (CLIP_CAP * MAX_FAN)
    return np.array(a), np.array(b)


def fields(tri):
    return {f.name: np.asarray(getattr(tri, f.name)) for f in dataclasses.fields(tri)}


def test_build_triangles_matches_jax(built):
    jt, jstats, pt, pstats, faces = built
    j, p = fields(jt), fields(pt)
    assert int(pstats["num_clipped"]) == int(jstats["num_clipped"]) > 0
    assert {k: v.shape for k, v in p.items()} == {k: v.shape for k, v in j.items()}
    path_a, path_b = slot_paths(faces)
    np.testing.assert_array_equal(p["valid"], j["valid"])
    np.testing.assert_array_equal(p["order"], j["order"])
    np.testing.assert_array_equal(p["ps_index"], j["ps_index"])
    a = path_a & j["valid"]
    b = path_b & j["valid"]
    assert a.sum() > 20 and b.sum() > 20, (a.sum(), b.sum())
    for k in ("spi", "top_left"):
        np.testing.assert_array_equal(p[k][..., a], j[k][..., a])
    for k in ("spf", "rhw", "ctx"):
        np.testing.assert_allclose(p[k][..., a], j[k][..., a], rtol=1e-6, atol=0)


def test_clipped_faces_render_within_golden_budget(built):
    jt, _, pt, _, _ = built
    _, scene = scene_state()
    args = (scene.pixel_shader, scene.ps_uniform, scene.config)
    frame_p = fused.render_fused(pt, *args)[0].numpy()
    frame_j = fused.render_fused(convert.triangles_from_arrays(fields(jt), device="cpu"), *args)[0].numpy()
    diff = np.abs(frame_p.astype(np.int32) - frame_j.astype(np.int32)).max(axis=-1)
    assert (diff > 2).mean() <= 0.01
    assert (frame_p[..., 0] != 30).sum() > 1000


def test_ps_boundary_quirk_is_live(built):
    """Three draws: the first emitted triangle of draws 1 and 2 moves to the
    earlier draw, as the reference's inclusive range checks put it."""
    jt, _, pt, _, faces = built
    ps = pt.ps_index.numpy()
    base = np.cumsum([0] + [f + CLIP_CAP * MAX_FAN for f in faces])
    for d in (1, 2):
        seg = ps[base[d] : base[d + 1]][pt.valid.numpy()[base[d] : base[d + 1]]]
        assert (seg != d).sum() == 1


@pytest.mark.parametrize("tile, k", [((16, 128), 4), ((16, 128), 1), ((32, 128), 2)])
def test_pack_and_bin_exact(built, tile, k):
    jt = built[0]
    pt = convert.triangles_from_arrays(fields(jt), device="cpu")
    m_pad = 128 * -(-(pt.num_slots + 1) // 128)
    ji, jf = jraster.pack_setup(jt, W, H, m_pad, with_ctx=True)
    pi, pf = raster.pack_setup(pt, W, H, m_pad)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji)[: raster.NF_I])
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf)[: pf.shape[0]])
    grid = (-(-H // tile[0]), 1)
    jp, joff = jraster.bin_pairs(ji, tile, grid, k, 128, m_dummy=pt.num_slots, kc=k)
    pp, poff = raster.bin_pairs(pi, tile, grid, k, 128, m_dummy=pt.num_slots, kc=k)
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))


def test_wrapped_edge_coefficients():
    """Off-screen garbage vertices overflow int32 in the edge coefficients;
    the port wraps exactly as the JAX package's int32 arithmetic does."""
    import jax.numpy as jnp
    import torch

    from f_renderer_tpu.pipeline.types import TriangleBuffer as JaxTri

    rng = np.random.default_rng(11)
    m = 64
    spi = rng.integers(-(2**31), 2**31 - 1, (3, 2, m), dtype=np.int64).astype(np.int32)
    spi[..., :8] = rng.integers(0, 100, (3, 2, 8))
    state = dict(
        spi=spi,
        spf=rng.random((3, 2, m)).astype(np.float32),
        rhw=rng.random((3, m)).astype(np.float32),
        ctx=np.zeros((0, m), np.float32),
        top_left=rng.random((3, m)) < 0.5,
        valid=rng.random(m) < 0.8,
        order=np.arange(m, dtype=np.int32),
        ps_index=np.zeros(m, np.int32),
    )
    ji, _ = jraster.pack_setup(JaxTri(**{k: jnp.asarray(v) for k, v in state.items()}), W, H, 128)
    pi, _ = raster.pack_setup(convert.triangles_from_arrays(state, device="cpu"), W, H, 128)
    assert pi.dtype == torch.int32
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji)[: raster.NF_I])
