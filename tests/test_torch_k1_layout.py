"""The raster kernels' tile plan (csrc/raster_loop.cuh), through its plain
mirror ``raster.tile_plan_plain``: the culled coarse and spill lists and the
per-tile pixel layout.

The cull keeps, after a tile's fine range, the coarse and spill pairs whose
bbox meets the tile; a tile whose kept pairs pass the cap keeps both ranges
whole. It is exact because every pixel the cover test accepts lies inside
its pair's bbox: the culled-out pairs cover no pixel of their tile, and the
plain raster over the culled lists equals the raster over the whole lists
bit for bit. The scene has all three ranges: a 20,000-triangle soup at
1024 x 256 seen from stress4k's camera, (16, 128) tiles, at most two fine
tiles a triangle.

The layout: rows interleaved only in an outlier tile whose blocks would
bound the kernel (phong1080's two pole tiles), 8 x 8 patches in every tile
of a soup of small triangles. The layouts themselves (each warp's pixels
and rect) are pinned by tests/test_torch_raster.py::test_warp_layouts_tile_the_tile.

On the card (``cuda`` marker) the kernels' own plan, read back from their
scratch, equals the mirror's, and a cap small enough to overflow most tiles
gives the same frame.
"""

import functools

import pytest
import torch

from f_renderer_tpu_torch.pipeline import raster

from _torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread: see that file)

W, H, TILE, BIN_K = 1024, 256, (16, 128), 2


def soup_scene(device="cpu"):
    from f_renderer_tpu_torch import Camera, make_phong_scene
    from f_renderer_tpu_torch.scene import make_instanced_soup

    cam = Camera.create([0.0, 0.0, -12.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device=device)
    return make_phong_scene(W, H, meshes=[make_instanced_soup(20_000, box=3.2, size=0.2)], camera=cam,
                            clip_cap=512, device=device)


@functools.lru_cache(maxsize=None)
def soup_prep():
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    scene = soup_scene()
    tri, stats = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    assert int(stats["num_clipped"]) <= scene.config.clip_cap
    return raster.prep_binned(tri, W, H, TILE, bin_k=BIN_K)


@functools.lru_cache(maxsize=None)
def whole_raster():
    """The plain raster of the soup over each tile's whole ranges."""
    return raster.raster_tiles_plain(soup_prep())


def ranges(prep):
    """(fine, coarse, spill) pairs of the prep's three kinds of ranges."""
    _, ntiles, spill = raster.tile_lists(prep, 0, 0)
    off = prep.off.tolist()
    return off[ntiles], off[spill] - off[ntiles], off[spill + 1] - off[spill]


def whole_lists(prep):
    """Each tile's fine, coarse and spill pairs, t = ty · ntx + tx."""
    nty, ntx = prep.h_pad // prep.th, prep.w_pad // raster.LANES
    off = prep.off.tolist()
    return [torch.cat([torch.arange(off[r], off[r + 1]) for r in raster.tile_lists(prep, t // ntx, t % ntx)])
            for t in range(nty * ntx)]


def test_soup_has_every_range():
    fine, coarse, spill = ranges(soup_prep())
    assert fine > 20_000 and coarse > 1_000 and spill > 100, (fine, coarse, spill)


def test_culled_out_pairs_cover_nothing():
    """No pair the cull leaves out covers a pixel of its tile (the kernels'
    cover test, ``cover_plain``), and the cull leaves out most of the coarse
    and spill entries."""
    prep = soup_prep()
    plan = raster.tile_plan_plain(prep)
    ntx = prep.w_pad // raster.LANES
    dropped = 0
    for t, (whole, kept) in enumerate(zip(whole_lists(prep), plan.lists)):
        assert plan.flags[t] & raster.TILE_CULLED
        out = whole[~torch.isin(whole, kept)]
        dropped += out.numel()
        if out.numel() == 0:
            continue
        cy = (t // ntx) * prep.th + torch.arange(prep.th)[:, None]
        cx = (t % ntx) * raster.LANES + torch.arange(raster.LANES)[None, :]
        assert not raster.cover_plain(prep.tri_i32, out, cx, cy).any(), f"tile {t}: a culled-out pair covers a pixel"
    _, coarse, spill = ranges(prep)
    entries = sum(v.numel() for v in whole_lists(prep)) - ranges(prep)[0]
    assert dropped > 0.8 * entries and sum(plan.counts) == entries - dropped, (dropped, entries, coarse, spill)


@pytest.mark.parametrize("cap", [None, 16])
def test_culled_raster_equals_whole(cap):
    """The plain raster over the plan's lists equals the raster over each
    tile's whole fine, coarse and spill ranges, bit for bit; with a cap of
    16 most tiles overflow and keep their whole ranges."""
    prep = soup_prep()
    plan = raster.tile_plan_plain(prep, cap=cap)
    overflow = sum(bool(f & raster.TILE_OVERFLOW) for f in plan.flags)
    assert (overflow > 10) if cap else (overflow == 0)
    want = whole_raster()
    got = raster.raster_tiles_plain(prep, plan=plan)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert int((want[1] >= 0).sum()) > 40_000


def test_tile_past_the_cap_keeps_its_whole_range():
    """A tile whose kept pairs pass the cap stages its whole coarse and spill
    ranges (TILE_OVERFLOW); one within it stages its fine range and the kept
    pairs in list order (TILE_CULLED)."""
    prep = soup_prep()
    counts = raster.tile_plan_plain(prep).counts
    cap = sorted(counts)[len(counts) // 2]  # about half the tiles past it
    plan = raster.tile_plan_plain(prep, cap=cap)
    assert plan.counts == counts
    whole = whole_lists(prep)
    n_fine = [int(prep.off[t + 1] - prep.off[t]) for t in range(len(whole))]
    kinds = set()
    for t, (f, n, lst) in enumerate(zip(plan.flags, plan.counts, plan.lists)):
        if n > cap:
            assert f & raster.TILE_OVERFLOW and not f & raster.TILE_CULLED
            assert torch.equal(lst, whole[t])
        else:
            assert f & raster.TILE_CULLED and not f & raster.TILE_OVERFLOW
            assert lst.numel() == n_fine[t] + n and torch.equal(lst[:n_fine[t]], whole[t][:n_fine[t]])
            assert bool((lst[n_fine[t]:].diff() > 0).all())  # list order
        kinds.add(f & (raster.TILE_OVERFLOW | raster.TILE_CULLED))
    assert kinds == {raster.TILE_OVERFLOW, raster.TILE_CULLED}


@pytest.mark.parametrize("th", [4, 8, 16, 32, 64, 128])
def test_block_of_patches_is_one_band_of_rows(th):
    """In the patch layout (csrc/raster_loop.cuh, tile_slot) block s owns
    every column of the tile's rows [s TY RT, (s + 1) TY RT) and nothing
    else: the band that its row selection (select_rows) tests the bboxes
    against."""
    tw, ty = raster.LANES, 4
    rt = 1 if th < 8 else 2
    for s in range(raster.blocks_per_tile(th)):
        pixels = set()
        for tid in range(tw * ty):
            lane, warp = tid % 32, tid // 32
            cx = 8 * (warp % (tw // 8)) + lane % 8
            row0 = s * ty * rt + (warp // (tw // 8)) * 4 * rt + lane // 8
            pixels |= {(row0 + 4 * r, cx) for r in range(rt)}
        assert pixels == {(y, x) for y in range(s * ty * rt, (s + 1) * ty * rt) for x in range(tw)}


def test_row_selection_is_exact():
    """A block of patches in a tile longer than a chunk walks only the pairs
    whose bbox rows meet its band (select_rows): no other pair of the tile's
    list covers a pixel of the band, and the selection keeps well under half
    the list."""
    prep = soup_prep()
    plan = raster.tile_plan_plain(prep)
    th, ntx = prep.th, prep.w_pad // raster.LANES
    miny = prep.tri_i32[raster.MINXY].long() >> 16
    maxy = prep.tri_i32[raster.MAXXY].long() >> 16
    band = 8 if th >= 8 else 4
    walked = listed = 0
    for t, (flags, lst) in enumerate(zip(plan.flags, plan.lists)):
        if flags & raster.TILE_ROWS or lst.numel() <= 128:
            continue
        x0, y0 = (t % ntx) * raster.LANES, (t // ntx) * th
        for s in range(th // band):
            b0 = y0 + s * band
            keep = (miny[lst] < b0 + band) & (maxy[lst] > b0)
            walked, listed = walked + int(keep.sum()), listed + lst.numel()
            cy = b0 + torch.arange(band)[:, None]
            cx = x0 + torch.arange(raster.LANES)[None, :]
            assert not raster.cover_plain(prep.tri_i32, lst[~keep], cx, cy).any(), (t, s)
    assert listed > 10_000 and walked < 0.75 * listed, (walked, listed)


def test_soup_tiles_take_patches():
    """A soup of small triangles has no outlier tile: every tile takes
    patches, also the tiles heavy enough to bound the kernel on a small
    frame."""
    prep = soup_prep()
    plan = raster.tile_plan_plain(prep)
    bound = 2 * raster.blocks_per_tile(prep.th) * sum(plan.weights)
    assert sum(w * raster.H100_SLOTS >= bound for w in plan.weights) > 10  # the bound alone would take these
    assert not any(f & raster.TILE_ROWS for f in plan.flags)


@pytest.mark.parametrize("angle", [0.10, 0.20])
def test_phong1080_pole_tiles_take_rows(angle):
    """At phong1080 the two tiles at the sphere's poles, its heaviest, keep
    their rows interleaved, as a fixed threshold of 256 pairs would; every
    other tile takes patches."""
    from f_renderer_tpu_torch import bench_scenes
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    scene = bench_scenes.build_scene("phong1080", "cpu")
    bench_scenes.set_angle(scene, angle)
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    prep = raster.prep_binned(tri, scene.config.width, scene.config.height, scene.config.tile,
                              bin_k=scene.config.bin_k)
    plan = raster.tile_plan_plain(prep)
    w = plan.weights
    heaviest = sorted(range(len(w)), key=lambda t: -w[t])[:2]
    rows = [t for t, f in enumerate(plan.flags) if f & raster.TILE_ROWS]
    assert sorted(rows) == sorted(heaviest) and min(w[t] for t in rows) >= 256, (rows, [w[t] for t in rows])
    assert all(f & raster.TILE_CULLED for f in plan.flags)


@pytest.mark.cuda
def test_kernel_plan_matches_mirror_on_card(monkeypatch):
    """The raster kernels' plan, read back from their scratch, is the
    mirror's (the tiles' order, each tile's flags, total and culled pairs),
    and a cap of 16 gives K1 the same frame. Run on the card with
    ``python -m pytest --noconftest -m cuda tests/test_torch_k1_layout.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import fused
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    dev = torch.device("cuda", 0)
    scene = soup_scene(dev)
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    prep = raster.prep_binned(tri, W, H, TILE, bin_k=BIN_K)
    slots = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    ntiles = (prep.h_pad // prep.th) * (prep.w_pad // raster.LANES)
    args = (prep, scene.pixel_shader, scene.ps_uniform, scene.config)
    launch, frames = kernels.fused_raster, {}
    for cap in (kernels.CULL_CAP, 16):
        scratch = torch.empty((kernels.plan_words(ntiles, cap),), dtype=torch.int32, device=dev)

        def with_plan(*a, **kw):
            return launch(*a, **kw, cull_cap=cap, scratch=scratch)

        with_plan.launches = launch.launches  # the wrapper counts on its module's name
        monkeypatch.setattr(kernels, "fused_raster", with_plan)
        frames[cap] = fused.render_fused_prepared(*args)
        desc, counts, pairs = kernels.read_plan(scratch, ntiles, cap)
        plan = raster.tile_plan_plain(prep, cap=cap, slots=slots)
        desc = desc.cpu()
        assert desc[:, 0].tolist() == plan.order
        for d in desc.tolist():
            t = d[0]
            assert d[7] == plan.flags[t] and d[3] == plan.lists[t].numel(), (t, d)
            assert int(counts[t]) == plan.counts[t]
            if d[7] & raster.TILE_CULLED:
                kept = pairs[t, :plan.counts[t]].cpu().long()
                assert torch.equal(kept, plan.lists[t][d[1]:].cpu())
    for a, b in zip(frames[kernels.CULL_CAP], frames[16]):
        assert torch.equal(a, b)
