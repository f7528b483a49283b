"""The port's non-fused raster (plain K4) and shade path vs the JAX package.

On the JAX package's own TriangleBuffer (carried across with ``convert``),
the port's plain ``rasterize`` / ``rasterize_interp`` are held against
``rasterize_pallas`` / ``rasterize_interp_pallas(interpret=True)``: winner
ids bit-equal, depth within rtol 2.4e-7, and the varying planes and texture
ids bit-equal where a triangle won (both interpolate the winner with the
same expressions, and neither makes fused multiply-adds here). One case is
a custom shader with 12 varyings, past the fused kernel's cap of 8.

End to end, the port's ``Scene.render()`` with ``fused_shade=False`` (its
own geometry, K4, then the pixel shader on the planes) is held against the
JAX package's ``render_frame(backend="pallas", fused_shade=False)`` under
the colour bar of tests/test_fused.py: at most 2 u8 everywhere, with at
most 0.2% of pixels at 2.

The JAX side runs in a subprocess with ``--xla_cpu_max_isa=AVX`` so that
XLA's CPU backend makes no fused multiply-adds (see test_torch_fused.py).
This file is that subprocess's script too.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import convert
from f_renderer_tpu_torch.pipeline import raster, shade
from f_renderer_tpu_torch.scene import make_checker_texture, make_cube, make_uv_sphere
from f_renderer_tpu_torch.shaders.api import ContextCodec

W, H = 128, 96
TRI_FIELDS = ("spi", "spf", "rhw", "ctx", "top_left", "valid", "order", "ps_index")
# name → (custom 12-varying shader?, bin tile, model rotation angle)
CASES = {"phong": (False, (32, 128), 0.3), "custom12": (True, (16, 128), 0.8)}
BACKGROUND = (30, 30, 30, 255)


def meshes():
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.4, 0.0, 0.0], np.float32)
    cube2 = make_cube(0.8)
    cube2["pos"] = cube2["pos"] + np.array([-1.4, 0.2, 0.0], np.float32)
    return [make_uv_sphere(10, 20), cube, cube2]


TEXTURES = [(64, 8), (64, 4), (48, 6)]


def jax_custom_shaders():
    """12 varyings (color 4, normal 3, pos 3, uv 2), per vertex and per
    pixel as the JAX package's shader contract has them."""
    import jax.numpy as jnp

    from f_renderer_tpu.shaders.builtin import _mat_vec4, _mvp_transform

    def vertex(u, vin):
        clip, p = _mvp_transform(u, vin["pos"])
        world = _mat_vec4(u["model"], p)
        uv = jnp.asarray(vin["uv"], jnp.float32)
        n = jnp.asarray(vin["normal"], jnp.float32)
        color = jnp.concatenate([uv, n[:1] * 0.5 + 0.5, jnp.ones((1,), jnp.float32)])
        return clip, {"uv": uv, "normal": n, "pos": world[:3], "color": color}

    def pixel(u, ctx, ps_index):
        c, n, p, uv = ctx["color"], ctx["normal"], ctx["pos"], ctx["uv"]
        return jnp.stack(
            [
                0.5 * c[..., 0] + 0.25 * (n[..., 0] * n[..., 0]) + 0.25 * uv[..., 1],
                0.5 * c[..., 1] + 0.25 * (n[..., 1] * n[..., 1]) + 0.1 * jnp.abs(p[..., 0]),
                0.5 * c[..., 2] + 0.25 * (n[..., 2] * n[..., 2]) + 0.1 * jnp.abs(p[..., 1]),
                c[..., 3],
            ],
            axis=-1,
        )

    return vertex, pixel


def port_custom_shaders():
    """The same shader in the port's planar contract."""
    from f_renderer_tpu_torch.math import mat_vec4
    from f_renderer_tpu_torch.shaders.builtin import _mvp_transform

    def vertex(u, vin):
        clip, p = _mvp_transform(u, vin["pos"])
        world = mat_vec4(u["model"], p)
        uv, n = vin["uv"].float(), vin["normal"].float()
        color = torch.cat([uv, n[:, :1] * 0.5 + 0.5, torch.ones_like(uv[:, :1])], dim=1)
        return clip, {"uv": uv, "normal": n, "pos": world[:3].T, "color": color}

    def pixel(u, ctx, ps_index):
        c, n, p, uv = ctx["color"], ctx["normal"], ctx["pos"], ctx["uv"]
        return torch.stack(
            [
                0.5 * c[0] + 0.25 * (n[0] * n[0]) + 0.25 * uv[1],
                0.5 * c[1] + 0.25 * (n[1] * n[1]) + 0.1 * torch.abs(p[0]),
                0.5 * c[2] + 0.25 * (n[2] * n[2]) + 0.1 * torch.abs(p[1]),
                c[3],
            ]
        )

    return vertex, pixel


def write_reference(path):
    """Run every case through the JAX package and save what the tests read."""
    from f_renderer_tpu.camera import Camera
    from f_renderer_tpu.math import set_rotate
    from f_renderer_tpu.pipeline.raster_pallas import rasterize_interp_pallas, rasterize_pallas
    from f_renderer_tpu.pipeline.render import build_triangles
    from f_renderer_tpu.scene import make_phong_scene

    out = {}
    for name, (custom, tile, angle) in CASES.items():
        cam = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
        js = make_phong_scene(
            W, H, meshes=meshes(), camera=cam, clip_cap=64, backend="pallas",
            textures=[make_checker_texture(*t) for t in TEXTURES],
        )
        js = dataclasses.replace(
            js,
            vs_uniform=dict(js.vs_uniform, model=set_rotate(np.array([0.0, 1.0, 0.0]), angle)),
            config=dataclasses.replace(js.config, fused_shade=False, tile=tile),
        )
        if custom:
            vs, ps = jax_custom_shaders()
            js = dataclasses.replace(js, vertex_shader=vs, pixel_shader=ps)
        tri, _ = build_triangles(js.draws, js.vertex_shader, js.vs_uniform, js.config)
        for f in TRI_FIELDS:
            out[f"{name}/tri/{f}"] = np.asarray(getattr(tri, f))
        winner, depth = rasterize_pallas(tri, W, H, tile=tile, interpret=True)
        ctx, ps_i, winner_i, depth_i = rasterize_interp_pallas(tri, W, H, tile=tile, interpret=True)
        frame, depth_f, _ = js.render()
        stack = js.ps_uniform["textures"]
        results = dict(
            winner=winner, depth=depth, ctx=ctx, ps_i=ps_i, winner_i=winner_i, depth_i=depth_i,
            frame=frame, depth_f=depth_f, tex_data=stack.data, tex_dims=stack.dims,
            view_pos=js.ps_uniform["view_pos"],
        )
        results.update({f"vs/{k}": v for k, v in js.vs_uniform.items()})
        for d, draw in enumerate(js.draws):
            results.update({f"draw{d}/{k}": v for k, v in draw.items()})
        out.update({f"{name}/{k}": np.asarray(v) for k, v in results.items()})
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_raster") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(path)], env=env, check=True, timeout=600
    )
    with np.load(path) as data:
        return dict(data)


def port_tri(name, ref):
    return convert.triangles_from_arrays({f: ref[f"{name}/tri/{f}"] for f in TRI_FIELDS}, device="cpu")


def port_scene(name, ref):
    custom, tile, _ = CASES[name]
    draws = [
        {k.split("/")[-1]: ref[k] for k in ref if k.startswith(f"{name}/draw{d}/")}
        for d in range(len(TEXTURES))
    ]
    scene = convert.scene_from_arrays(
        draws,
        {k.split("/")[-1]: ref[k] for k in ref if k.startswith(f"{name}/vs/")},
        {
            "view_pos": ref[f"{name}/view_pos"],
            "textures": {"data": ref[f"{name}/tex_data"], "dims": ref[f"{name}/tex_dims"]},
        },
        "phong",
        dict(width=W, height=H, background=BACKGROUND, clip_cap=64, tile=tile, fused_shade=False),
        device="cpu",
    )
    if custom:
        vs, ps = port_custom_shaders()
        scene = dataclasses.replace(scene, vertex_shader=vs, pixel_shader=ps)
    return scene


def frame_bar(got, want, edge_budget=0.002):
    """≤ 2 u8 everywhere, 2-u8 differences on at most ``edge_budget`` pixels."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    assert diff.max() <= 2, f"max u8 diff {diff.max()}"
    assert (diff > 1).mean() <= edge_budget, f"{(diff > 1).mean():.2%} pixels at 2 u8"


@pytest.mark.parametrize("name", list(CASES))
def test_rasterize_matches_jax(name, ref):
    winner, depth = raster.rasterize(port_tri(name, ref), W, H, tile=CASES[name][1])
    assert winner.dtype == torch.int32 and tuple(winner.shape) == (H, W)
    np.testing.assert_array_equal(winner.numpy(), ref[f"{name}/winner"])
    np.testing.assert_allclose(depth.numpy(), ref[f"{name}/depth"], rtol=2.4e-7, atol=0)
    assert (winner.numpy() >= 0).mean() > 0.1


@pytest.mark.parametrize("name", list(CASES))
def test_rasterize_interp_matches_jax(name, ref):
    tri = port_tri(name, ref)
    ctx, ps, winner, depth = raster.rasterize_interp(tri, W, H, tile=CASES[name][1])
    n_ctx = 12 if CASES[name][0] else 8
    assert tuple(ctx.shape) == (n_ctx, H, W) and tri.num_channels == n_ctx
    np.testing.assert_array_equal(winner.numpy(), ref[f"{name}/winner_i"])
    np.testing.assert_allclose(depth.numpy(), ref[f"{name}/depth_i"], rtol=2.4e-7, atol=0)
    won = winner.numpy() >= 0
    np.testing.assert_array_equal(ps.numpy()[won], ref[f"{name}/ps_i"][won])
    want = np.moveaxis(ref[f"{name}/ctx"], -1, 0)
    np.testing.assert_array_equal(ctx.numpy()[:, won], want[:, won])
    assert (ctx.numpy()[:, ~won] == 0).all() and (ps.numpy()[~won] == 0).all()
    assert len(np.unique(ps.numpy()[won])) == 3  # all three draws' textures


@pytest.mark.parametrize("name", list(CASES))
def test_non_fused_frame_matches_jax(name, ref):
    frame, depth, _ = port_scene(name, ref).render()
    frame, depth = frame.numpy(), depth.numpy()
    assert frame.shape == (H, W, 4) and frame.dtype == np.uint8
    frame_bar(frame, ref[f"{name}/frame"])
    want = ref[f"{name}/depth_f"]
    both = (depth > 0) & (want > 0)
    assert both.mean() > 0.1
    np.testing.assert_allclose(depth[both], want[both], rtol=2.4e-7)
    assert (frame[..., :3] != 30).any(-1).mean() > 0.1


def test_nan_colour_packs_to_zero():
    """``shade_from_planes`` packs a NaN colour channel to 0, as the JAX
    package's ``clip(color · 255).astype(u8)`` does (XLA's conversion)."""
    import jax.numpy as jnp

    from f_renderer_tpu.pipeline.shade import shade_from_planes as jax_shade
    from f_renderer_tpu.shaders.api import make_context_codec

    rng = np.random.default_rng(2)
    planes = rng.uniform(-0.5, 1.5, (4, 6, 10)).astype(np.float32)
    planes[:, rng.random((6, 10)) < 0.3] = np.nan
    planes[1, 0, :3] = [np.inf, -np.inf, 0.9999]
    winner = rng.integers(-1, 5, (6, 10)).astype(np.int32)
    ps = np.zeros((6, 10), np.int32)
    got = shade.shade_from_planes(
        torch.from_numpy(planes), torch.from_numpy(ps), torch.from_numpy(winner),
        lambda u, ctx, i: ctx["rgba"], {}, ContextCodec((("rgba", 4),)), background=BACKGROUND,
    )
    want = jax_shade(
        jnp.asarray(np.moveaxis(planes, 0, -1)), jnp.asarray(ps), jnp.asarray(winner),
        lambda u, ctx, i: ctx["rgba"], {}, make_context_codec(lambda u, v: (v, {"rgba": v}), {}, jnp.zeros(4)), background=BACKGROUND,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[np.isnan(planes).any(0) & (winner >= 0)] == 0).any()


def test_shade_deferred_matches_rasterize_interp(ref):
    """``shade_deferred`` (gather the winner's fields after ``rasterize``)
    gives what ``rasterize_interp`` + ``shade_from_planes`` give."""
    scene = port_scene("custom12", ref)
    tri = port_tri("custom12", ref)
    codec = ContextCodec.of(scene.vertex_shader(scene.vs_uniform, {
        k: v[:1, 0] for k, v in scene.draws[0].items()})[1])
    winner, _ = raster.rasterize(tri, W, H)
    got = shade.shade_deferred(tri, winner, scene.pixel_shader, {}, codec, background=BACKGROUND)
    ctx, ps, winner_i, _ = raster.rasterize_interp(tri, W, H)
    want = shade.shade_from_planes(ctx, ps, winner_i, scene.pixel_shader, {}, codec, background=BACKGROUND)
    frame_bar(got.numpy(), want.numpy())


def bbox_scene(name, width=128, height=128):
    """The phong1080 shapes (a 40x80 sphere and two 0.8 cubes, bench
    camera and angle) at 128x128, or the sliver scene, on the CPU."""
    from f_renderer_tpu_torch import Camera, make_phong_scene
    from f_renderer_tpu_torch.math import set_rotate
    from f_renderer_tpu_torch.scene import make_sliver_scene

    if name == "sliver":
        return make_sliver_scene(width, height, device="cpu")
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.6, 0.0, 0.0], np.float32)
    cube2 = make_cube(0.8)
    cube2["pos"] = cube2["pos"] + np.array([-1.6, 0.0, 0.0], np.float32)
    cam = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], "cpu")
    scene = make_phong_scene(
        width, height, meshes=[make_uv_sphere(40, 80), cube, cube2], camera=cam, clip_cap=64, device="cpu",
        textures=[make_checker_texture(*t) for t in TEXTURES],
    )
    scene.vs_uniform = dict(scene.vs_uniform, model=set_rotate([0.0, 1.0, 0.0], 0.10, "cpu"))
    return scene


@pytest.mark.parametrize("name", ["phong1080_128", "sliver"])
def test_covered_pixels_lie_in_bbox(name):
    """The precondition of the raster kernels' bbox gate
    (csrc/raster_loop.cuh): every (pair, pixel) that the cover test of
    ``raster_tiles_plain`` accepts, over each tile's fine, coarse and spill
    ranges, lies inside the pair's [MINXY, MAXXY)."""
    from f_renderer_tpu_torch.pipeline import fused
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    scene = bbox_scene(name)
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    prep = fused.prep_fused(tri, scene.config)
    th, ntx, nty = prep.th, prep.w_pad // raster.LANES, prep.h_pad // prep.th
    off = prep.off.tolist()
    minx, miny = raster.unpack_xy(prep.tri_i32[raster.MINXY].long())
    maxx, maxy = raster.unpack_xy(prep.tri_i32[raster.MAXXY].long())
    covered, ranges = 0, set()
    for ty in range(nty):
        for tx in range(ntx):
            lists = raster.tile_lists(prep, ty, tx)
            idx = torch.cat([torch.arange(off[r], off[r + 1]) for r in lists])
            ranges.update(k for k, r in enumerate(lists) if off[r + 1] > off[r])
            if idx.numel() == 0:
                continue
            cy = ty * th + torch.arange(th)[:, None]
            cx = tx * raster.LANES + torch.arange(raster.LANES)[None, :]
            cover = raster.cover_plain(prep.tri_i32, idx, cx, cy)
            inside = ((cx >= minx[idx, None, None]) & (cx < maxx[idx, None, None])
                      & (cy >= miny[idx, None, None]) & (cy < maxy[idx, None, None]))
            assert not (cover & ~inside).any(), f"tile ({ty}, {tx}): a covered pixel outside its pair's bbox"
            covered += int(cover.sum())
    assert covered > (2000 if name == "sliver" else 5000)
    assert ranges >= ({0, 1} if name == "sliver" else {0})


def untouched_tiles(prep, scan=32):
    """The raster kernels' order pass (csrc/raster_loop.cuh, tile_desc): a
    tile with no fine pairs and at most ``scan`` coarse and spill pairs,
    none of whose bboxes reaches the tile's pixels, gets an empty list →
    [(ty, tx, pairs skipped)]."""
    th, ntx, nty = prep.th, prep.w_pad // raster.LANES, prep.h_pad // prep.th
    off = prep.off.tolist()
    minx, miny = raster.unpack_xy(prep.tri_i32[raster.MINXY].long())
    maxx, maxy = raster.unpack_xy(prep.tri_i32[raster.MAXXY].long())
    out = []
    for ty in range(nty):
        for tx in range(ntx):
            fine, coarse, spill = raster.tile_lists(prep, ty, tx)
            idx = torch.cat([torch.arange(off[r], off[r + 1]) for r in (coarse, spill)])
            if off[fine + 1] > off[fine] or idx.numel() > scan:
                continue
            x0, y0 = tx * raster.LANES, ty * th
            reach = ((minx[idx] < x0 + raster.LANES) & (maxx[idx] > x0)
                     & (miny[idx] < y0 + th) & (maxy[idx] > y0))
            if not reach.any():
                out.append((ty, tx, idx.numel()))
    return out


def slot_pixels(th, patch, patch_w=8):
    """The raster kernels' pixel layout (csrc/raster_loop.cuh, tile_slot and
    the warp rects of raster_tile) for a (th, 128) tile at the origin →
    {(block, warp, row step): (pixels of the lanes, the warp's rect)}."""
    tw, ty = raster.LANES, 4
    rt = 1 if th < 8 else 2
    blocks = th // (ty * rt)
    rows_w = 32 // patch_w
    out = {}
    for s in range(blocks):
        for tid in range(tw * ty):
            lane, warp = tid % 32, tid // 32
            if patch:
                across = tw // patch_w
                cx = patch_w * (warp % across) + lane % patch_w
                row0 = s * ty * rt + (warp // across) * rows_w * rt + lane // patch_w
                step, wx0, wcols = rows_w, cx - lane % patch_w, patch_w
                wrow0, wspan = row0 - lane // patch_w, rows_w
            else:
                cx, row0, step = tid % tw, s + blocks * (tid // tw), ty * blocks
                wx0, wcols, wrow0, wspan = cx - lane, 32, row0, 1
            for r in range(rt):
                pix, rect = out.setdefault((s, warp, r), (set(), set()))
                pix.add((row0 + step * r, cx))
                rect.add((wx0, wcols, wrow0 + step * r, wspan))
    return out


@pytest.mark.parametrize("th", [4, 8, 16, 32, 64, 128])
def test_warp_layouts_tile_the_tile(th):
    """Both pixel layouts of the raster kernels give every pixel of a tile
    to exactly one (block, thread, row step), and each warp's rect, which
    its ballot tests the staged bboxes against, is warp-uniform and holds
    every pixel its lanes own in that row step (so the culling is exact)."""
    for patch in (True, False):
        owned = []
        for (s, warp, r), (pix, rect) in slot_pixels(th, patch).items():
            assert len(pix) == 32 and len(rect) == 1
            (wx0, wcols, wy0, wspan), = rect
            assert all(wx0 <= x < wx0 + wcols and wy0 <= y < wy0 + wspan for y, x in pix)
            assert wcols * wspan == 32  # the rect is the lanes' pixels, no more
            owned += pix
        assert len(owned) == len(set(owned)) == th * raster.LANES


@pytest.mark.parametrize("size", [(640, 360), (384, 256)])
def test_untouched_tiles_are_background(size):
    """A tile that the order pass empties is background in the plain raster
    (no winner, depth 0): its blocks may skip the walk. The phong1080
    shapes in (16, 128) tiles have such tiles with coarse and spill pairs to
    skip."""
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    scene = bbox_scene("phong", *size)
    scene.config = dataclasses.replace(scene.config, tile=(16, 128))
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    prep = raster.prep_binned(tri, scene.config.width, scene.config.height, scene.config.tile,
                              bin_k=scene.config.bin_k)
    empty = untouched_tiles(prep)
    assert len(empty) >= 3 and sum(n for _, _, n in empty) > 0
    depth, wpair = raster.raster_tiles_plain(prep)
    th = prep.th
    for ty, tx, _ in empty:
        rows, cols = slice(ty * th, (ty + 1) * th), slice(tx * raster.LANES, (tx + 1) * raster.LANES)
        assert (wpair[rows, cols] == -1).all() and (depth[rows, cols] == 0.0).all(), (ty, tx)
    assert (wpair >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(name):
    """K4 against its plain version on the card, both entry points, and the
    non-fused ``Scene.render()`` launching K4 once. Run on the card with
    ``python -m pytest --noconftest -m cuda tests/test_torch_raster.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from f_renderer_tpu_torch import Camera, kernels, make_phong_scene
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    custom, tile, _ = CASES[name]
    cam = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    scene = make_phong_scene(
        640, 360, meshes=meshes(), camera=cam, clip_cap=64,
        textures=[make_checker_texture(*t) for t in TEXTURES],
    )
    scene.config = dataclasses.replace(scene.config, fused_shade=False, tile=tile)
    if custom:
        scene.vertex_shader, scene.pixel_shader = port_custom_shaders()
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    prep = raster.prep_binned(tri, 640, 360, tile)
    for interp in (False, True):
        before = kernels.raster_planes.launches
        got = raster.raster_planes(prep, interp)
        assert kernels.raster_planes.launches == before + 1
        want = raster.raster_planes_plain(prep, interp)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=2.4e-7, atol=0)
        if interp:
            assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    before = kernels.raster_planes.launches
    scene.render()
    assert kernels.raster_planes.launches == before + 1


if __name__ == "__main__":
    write_reference(sys.argv[1])
