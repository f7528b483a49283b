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

K1's early depth test (a pair's reach against the pixels' depths, in the
warps' ballot and at each pixel): a numpy emulation of K1's warp walks with
it equals the plain raster bit for bit on the soup and at phong1080, and
the reach bounds every covered pixel's rhw, on both scenes and on crafted
values.

On the card (``cuda`` marker) the kernels' own plan, read back from their
scratch, equals the mirror's, a cap small enough to overflow most tiles
gives the same frame, and K1 equals its plain version on the soup.
"""

import functools

import numpy as np
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


# K1's warp walks with the early depth test (csrc/raster_loop.cuh:
# walk_tile, walk_items with kDepthTest), emulated in numpy with the
# kernel's own math: each block's warps and their pixels in the tile's
# layout (patches, or rows interleaved), its items (the whole list within a
# chunk or in rows, else each segment of SELECT positions cut to the pairs
# whose bbox rows meet the block's band), 32 at a time: the ballot against
# the warp's columns and rows, each row step's rows dropped where the least
# depth of the warp's pixels there passes the pair's reach, then each pair
# of the ballot in order at each pixel of its warp: the row inside the bbox,
# the pixel's depth not past the reach, the cover test, depth_of, merge().
CHUNK, SELECT, TW, TY = 128, 2048, 128, 4
RHW_SLACK, RHW_FLOOR = np.float32(1.000001), np.float32(1.17549435e-38)


def reach_of(f):
    """The reach of pairs whose float rows are ``f`` (9, ...): reach_of."""
    return np.fmax(np.fmax(np.fmax(f[raster.RHW0], f[raster.RHW1]), f[raster.RHW2]), np.float32(0)) * RHW_SLACK + RHW_FLOOR


def depth_of(f, pcx, pcy):
    """depth_of's rhw and its s != 0, float32 op by op."""
    s0x, s0y = f[raster.S0X] - pcx, f[raster.S0Y] - pcy
    s1x, s1y = f[raster.S1X] - pcx, f[raster.S1Y] - pcy
    s2x, s2y = f[raster.S2X] - pcx, f[raster.S2Y] - pcy
    a = np.abs(s1x * s2y - s1y * s2x)
    b = np.abs(s2x * s0y - s2y * s0x)
    c = np.abs(s0x * s1y - s0y * s1x)
    s = (a + b) + c
    inv_s = np.float32(1.0) / s
    rhw = (f[raster.RHW0] * (a * inv_s) + f[raster.RHW1] * (b * inv_s)) + f[raster.RHW2] * (c * inv_s)
    return rhw, s != 0


def covers(u, x, cy):
    """The kernel's cover test (covers()) in wrapped int32: the edges and x <
    max_x, for int rows ``u`` (12, ...) int64."""
    e01 = raster._w(u[raster.A01] * x + u[raster.C01] + u[raster.B01] * cy)
    e20 = raster._w(u[raster.A20] * x + u[raster.C20] + u[raster.B20] * cy)
    e12 = raster._w(u[raster.AREA2] - e01 - e20)
    return (e01 >= 0) & (e20 >= 0) & (e12 >= 0) & (x < (u[raster.MAXXY] & 0xFFFF))


def block_pixels(th, s, patch):
    """Block s's threads' pixels in its tile (tile_slot) → (x, y) (16 warps,
    32 lanes, R) and each warp's rect (x0, cols, row0, step, span)."""
    rt = 1 if th < 8 else 2
    n_s = raster.blocks_per_tile(th)
    tid = np.arange(TW * TY).reshape(16, 32)
    lane, warp = tid % 32, tid // 32
    r = np.arange(rt)
    if patch:
        x = 8 * (warp % 16) + lane % 8
        row0 = s * TY * rt + (warp // 16) * 4 * rt + lane // 8
        step = 4
        rect = (8 * (warp[:, 0] % 16), 8, row0[:, 0], 4, 4)
    else:
        x = tid % TW
        row0 = s + n_s * (tid // TW)
        step = TY * n_s
        rect = (32 * (warp[:, 0] % 4), 32, row0[:, 0], step, 1)
    return np.broadcast_to(x[..., None], (16, 32, rt)), row0[..., None] + step * r, rect


def warp_walk_plain(prep, plan):
    """Every tile of ``plan`` (``tile_plan_plain``) rastered by K1's warp
    walks with the early depth test → padded (depth, pair or -1), as
    ``raster.raster_tiles_plain``."""
    ti, tf = prep.tri_i32.numpy(), prep.tri_f32.numpy()
    th, (oy, ox) = prep.th, prep.origin
    ntx = prep.w_pad // raster.LANES
    depth = np.zeros((prep.h_pad, prep.w_pad), np.float32)
    wpair = np.full((prep.h_pad, prep.w_pad), -1, np.int64)
    miny, maxy = ti[raster.MINXY] >> 16, ti[raster.MAXXY] >> 16
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for t, lst in enumerate(plan.lists):
            lst = lst.numpy()
            if lst.size == 0:
                continue
            ty, tx = divmod(t, ntx)
            patch = not plan.flags[t] & raster.TILE_ROWS
            for s in range(raster.blocks_per_tile(th)):
                px, py, (rx0, cols, rrow0, step, span) = block_pixels(th, s, patch)
                fx, fy = ox + tx * TW + px, oy + ty * th + py  # frame pixels
                wx0, wrow0 = ox + tx * TW + rx0, oy + ty * th + rrow0
                rt = px.shape[-1]
                band0 = oy + ty * th + s * TY * rt
                if patch and lst.size > CHUNK:
                    items = [seg[(miny[seg] < band0 + 4 * rt) & (maxy[seg] > band0)]
                             for seg in (lst[i:i + SELECT] for i in range(0, lst.size, SELECT))]
                    items = np.concatenate(items)
                else:
                    items = lst
                dep = np.zeros(px.shape, np.float32)
                wp = np.full(px.shape, -1, np.int64)
                for j0 in range(0, items.size, 32):  # a ballot (chunks of CHUNK hold whole ones)
                    grp = items[j0:j0 + 32]
                    least = np.abs(dep).min(1)  # (16, R)
                    mn, mx = ti[raster.MINXY, grp].astype(np.int64), ti[raster.MAXXY, grp].astype(np.int64)
                    reach = reach_of(tf[:9, grp])
                    rows_at = wrow0[:, None, None] + step * np.arange(rt)[None, None, :]  # (16, 1, R)
                    rows = ((rows_at < (mx >> 16)[None, :, None]) & (rows_at + span > (mn >> 16)[None, :, None])
                            & ~(least[:, None, :] > reach[None, :, None])).any(-1)
                    touch = rows & ((mn & 0xFFFF)[None, :] < (wx0 + cols)[:, None]) & ((mx & 0xFFFF)[None, :] > wx0[:, None])
                    for k in range(grp.size):
                        w = np.nonzero(touch[:, k])[0]
                        if w.size == 0:
                            continue
                        pair = grp[k]
                        u = ti[:, pair].astype(np.int64)[:, None, None, None]
                        cx, cy, d = fx[w], fy[w], dep[w]
                        inside = (cy >= miny[pair]) & (cy < maxy[pair]) & ~(d > reach[k])
                        rhw, ok = depth_of(tf[:9, pair][:, None, None, None], cx.astype(np.float32) + np.float32(0.5),
                                           cy.astype(np.float32) + np.float32(0.5))
                        cur = np.where(wp[w] >= 0, ti[raster.ORDER, np.maximum(wp[w], 0)], raster.ORDER_NONE)
                        take = inside & covers(u, cx, cy) & ok & (
                            (rhw > d) | ((rhw == d) & (ti[raster.ORDER, pair] > cur)))
                        dep[w] = np.where(take, rhw, d)
                        wp[w] = np.where(take, pair, wp[w])
                ry, rx = (fy - oy).ravel(), (fx - ox).ravel()
                depth[ry, rx], wpair[ry, rx] = dep.ravel(), wp.ravel()
    return torch.from_numpy(depth), torch.from_numpy(wpair)


@functools.lru_cache(maxsize=None)
def phong1080_prep(origin=(0, 0), size=None):
    """phong1080 at the bench angle 0.10, binned as the fused path bins it
    (``fused.prep_fused``), whole or the row slab ``size`` at ``origin``."""
    from f_renderer_tpu_torch import bench_scenes
    from f_renderer_tpu_torch.pipeline import fused
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    scene = bench_scenes.build_scene("phong1080", "cpu")
    bench_scenes.set_angle(scene, 0.10)
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    return fused.prep_fused(tri, scene.config, origin=origin, size=size)


def bits_equal(got, want):
    """(depth, pair) pairs equal, the depths bit for bit (signed zeros too)."""
    return torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cap, th", [(None, 16), (16, 16), (None, 4)])
def test_early_depth_walk_equals_plain_on_the_soup(cap, th):
    """K1's warp walks with the early depth test over the plan's lists (with
    a cap of 16 most tiles keep their whole ranges; 4-row tiles take one
    row a thread) equal the plain raster over each tile's whole ranges, bit
    for bit."""
    if th == TILE[0]:
        prep = soup_prep()
        plan = raster.tile_plan_plain(prep, cap=cap)
        want = whole_raster()
    else:  # the plain raster over the plan's lists (equal to the whole ranges', test_culled_raster_equals_whole)
        from f_renderer_tpu_torch.pipeline.render import build_triangles

        scene = soup_scene()
        tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
        prep = raster.prep_binned(tri, W, H, (th, 128), bin_k=BIN_K)
        plan = raster.tile_plan_plain(prep, cap=cap)
        want = raster.raster_tiles_plain(prep, plan=plan)
    assert bits_equal(warp_walk_plain(prep, plan), want)
    assert int((want[1] >= 0).sum()) > 40_000


@pytest.mark.parametrize("slab", [False, True])
def test_early_depth_walk_equals_plain_at_phong1080(slab):
    """The same at phong1080 (its pole tiles in rows, the rest in patches,
    its clipped faces' pieces), whole and on a row slab of 135 rows (frame
    coordinates in every test, as a sharded frame's slab)."""
    prep = phong1080_prep((3 * 135, 0), (135, 1920)) if slab else phong1080_prep()
    plan = raster.tile_plan_plain(prep)
    assert any(f & raster.TILE_ROWS for f in plan.flags) != slab
    want = raster.raster_tiles_plain(prep)
    assert bits_equal(warp_walk_plain(prep, plan), want)
    assert int((want[1] >= 0).sum()) > (50_000 if slab else 400_000)


@pytest.mark.parametrize("scene", ["soup", "phong1080"])
def test_reach_bounds_every_covered_rhw(scene):
    """A pair's reach (reach_of) is at least its rhw at every pixel it
    covers, so the early depth test's skips leave every winner as it was."""
    prep = soup_prep() if scene == "soup" else phong1080_prep()
    ti, tf = prep.tri_i32.numpy(), prep.tri_f32.numpy()
    idx = np.arange(ti.shape[1])
    mn, mx = ti[raster.MINXY].astype(np.int64), ti[raster.MAXXY].astype(np.int64)
    w, h = (mx & 0xFFFF) - (mn & 0xFFFF), (mx >> 16) - (mn >> 16)
    idx = idx[(w > 0) & (h > 0) & (w <= 64) & (h <= 64)]
    checked = 0
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for lo in range(0, idx.size, 512):
            sl = idx[lo:lo + 512]
            gy, gx = np.mgrid[0:64, 0:64]
            cx = (mn[sl] & 0xFFFF)[:, None, None] + gx
            cy = (mn[sl] >> 16)[:, None, None] + gy
            cover = raster.cover_plain(prep.tri_i32, torch.from_numpy(sl), torch.from_numpy(cx),
                                       torch.from_numpy(cy)).numpy()
            f = tf[:9, sl][:, :, None, None]
            rhw, ok = depth_of(f, cx.astype(np.float32) + np.float32(0.5), cy.astype(np.float32) + np.float32(0.5))
            live = cover & ok & ~np.isnan(rhw)
            assert not (live & (rhw > reach_of(f))).any()
            checked += int(live.sum())
    assert checked > (40_000 if scene == "soup" else 400_000)


def test_reach_bounds_rhw_on_crafted_values():
    """The reach bounds depth_of's rhw at any pixel centre (k + 0.5, k >= 0,
    as the kernels test) for vertices' rhw of every kind (of both signs,
    subnormal, huge, +inf, NaN) and vertices anywhere: far, on the pixel
    centre, a subnormal or an ulp from it, infinite, NaN. Where the rhw is
    not NaN it never passes the reach. (A nonzero difference from such a
    centre is at least 2^-25 and a nonzero |cross| at least 2^-73, so 1 / s
    stays finite; at a centre of any value it need not: a triangle a
    subnormal wide around it gives weights of +inf.)"""
    rng = np.random.default_rng(30)
    n = 400_000
    kinds = np.array([0.5, 1.0, 3.0, -2.0, 0.0, -0.0, 1e-40, 1e-45, 3e38, -3e38, np.inf, np.nan, 1e-30, 7.25],
                     np.float32)
    r = np.where(rng.random((3, n)) < 0.5, rng.choice(kinds, (3, n)),
                 (rng.standard_normal((3, n)) * 10.0 ** rng.integers(-40, 38, (3, n))).astype(np.float32))
    pc = (rng.integers(0, 1 << 15, (2, n)) + 0.5).astype(np.float32)
    off = rng.standard_normal((6, n)) * 10.0 ** rng.integers(-45, 6, (6, n))
    xy = (pc[np.arange(6) % 2] + off).astype(np.float32)
    odd = rng.random((6, n)) < 0.05
    xy = np.where(odd, rng.choice(np.array([0.0, np.inf, -np.inf, np.nan, 3e38, 1e-40], np.float32), (6, n)), xy)
    ulp = rng.random((6, n)) < 0.2  # an ulp or two off the centre
    xy = np.where(ulp, np.nextafter(pc[np.arange(6) % 2], np.float32(rng.choice([-np.inf, np.inf]))), xy)
    f = np.zeros((9, n), np.float32)
    f[raster.S0X:raster.S2Y + 1] = xy
    f[raster.RHW0:raster.RHW2 + 1] = r.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore", under="ignore"):
        rhw, ok = depth_of(f, pc[0], pc[1])
        live = ok & ~np.isnan(rhw)
        assert live.sum() > n // 4
        assert not (live & (rhw > reach_of(f))).any()


@pytest.mark.cuda
def test_k1_equals_plain_on_the_soup_on_card(monkeypatch):
    """K1 (its warp walks with the early depth test) on the soup, whose
    pixels are covered by many pairs in list order, gives its plain
    version's frame, depth and winner bit for bit, at the default cull cap
    and at 16. Run on the card with ``python -m pytest --noconftest -m cuda
    tests/test_torch_k1_layout.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from f_renderer_tpu_torch import kernels
    from f_renderer_tpu_torch.pipeline import fused
    from f_renderer_tpu_torch.pipeline.render import build_triangles

    dev = torch.device("cuda", 0)
    scene = soup_scene(dev)
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    prep = raster.prep_binned(tri, W, H, TILE, bin_k=BIN_K)
    args = (prep, scene.pixel_shader, scene.ps_uniform, scene.config)
    want = fused.render_fused_plain(*args)
    launch = kernels.fused_raster
    for cap in (kernels.CULL_CAP, 16):
        def with_cap(*a, **kw):
            return launch(*a, **kw, cull_cap=cap)

        with_cap.launches = launch.launches  # the wrapper counts on its module's name
        monkeypatch.setattr(kernels, "fused_raster", with_cap)
        got = fused.render_fused_prepared(*args)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                               b.view(torch.int32) if b.is_floating_point() else b), cap
