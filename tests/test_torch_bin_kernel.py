"""The binning kernels (csrc/bin_pairs.cu) against their plain version,
``raster.bin_packed`` on CPU tensors (``bin_bbox``' sort and an
``index_select`` of the slot records).

The kernels run only on the card. Here a numpy mirror of their counting
sort stands in for them, step by step: the stripes of slots
(``kernels.bin_stripes``, a block each), each stripe's count per key
(bin_count_kernel), the exclusive scans over the stripes (bin_scan_kernel)
and over the keys (``off``), then bin_pairs_kernel: each key's running
place in a block (off[key] + the pairs of earlier stripes), 256 slots at a
time, their pairs laid out slot-major and placed 256 at a time, a pair at
its key's running place + the pairs of that key of earlier lanes of its
warp (the kernel's ``__match_any_sync``), the warps' leaders moving each
key's place on warp by warp; the padding pairs pointing at ``m_dummy``,
and every record gathered in pair order (bin_gather_kernel). Where the
plain version takes the packed 31-bit sort, ``off`` and every pair column
must equal it bit for bit: both order the pairs by (key, slot). Cases:
tiles of 16, 32, 64 and 128 rows, k = 1, 2 and 4, the row slabs of
tests/test_torch_origin.py (an origin), the sharded frame's ``m_dummy``
(the last column). Where it takes the stable two-operand sort (keys past
31 bits), ``off`` is equal and each key's list is a permutation of the
plain one. On the card the kernels are held to the plain version (``cuda``
test), from the set-up's bbox array, from packed rows (their plain
records, ``raster.bin_rows``) and from the records' own bbox words.
"""

import dataclasses

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import kernels, make_checker_texture, make_cube, make_phong_scene, make_uv_sphere
from f_renderer_tpu_torch.pipeline import raster
from f_renderer_tpu_torch.pipeline.raster import COARSE, LANES, MAXXY, MINXY, cdiv
from f_renderer_tpu_torch.pipeline.render import build_packed, build_triangles

W, H = 640, 360
BLOCK = kernels.BIN_BLOCK  # threads of a stripe's block: slots a chunk, pairs a round


# ------------------------------------------------------------ the mirror


def slot_keys(bbox, th, grid_hw, k, kc, origin):
    """Each slot's pair keys as the kernels' ``slot_keys`` describes them →
    (offset, y0, x0, ncols, stride, n) per slot: key j < n is offset + (y0
    + j // ncols) * stride + x0 + j % ncols."""
    nty, ntx = grid_hw
    oy, ox = origin
    lo, hi = bbox[0].astype(np.int64), bbox[1].astype(np.int64)
    minx, maxx = np.clip((lo & 0xFFFF) - ox, 0, ntx * LANES), np.clip((hi & 0xFFFF) - ox, 0, ntx * LANES)
    miny, maxy = np.clip((lo >> 16) - oy, 0, nty * th), np.clip((hi >> 16) - oy, 0, nty * th)
    nonempty = (maxx > minx) & (maxy > miny)
    tx0, tx1 = minx // LANES, np.maximum(maxx - 1, minx) // LANES
    ty0, ty1 = miny // th, np.maximum(maxy - 1, miny) // th
    ncols = tx1 - tx0 + 1
    span = ncols * (ty1 - ty0 + 1)
    ntiles, ntxc = ntx * nty, cdiv(ntx, COARSE)
    cx0, cy0 = tx0 // COARSE, ty0 // COARSE
    ncolsc = tx1 // COARSE - cx0 + 1
    cspan = ncolsc * (ty1 // COARSE - cy0 + 1)
    small = nonempty & (span <= k)
    mid = nonempty & ~small & (cspan <= kc)
    spill = nonempty & ~small & ~mid
    n = np.where(small, span, np.where(mid, cspan, spill.astype(np.int64)))
    offset = np.where(small, 0, np.where(mid, ntiles, ntiles + cdiv(nty, COARSE) * ntxc))
    y0, x0 = np.where(small, ty0, np.where(mid, cy0, 0)), np.where(small, tx0, np.where(mid, cx0, 0))
    nc, stride = np.where(small, ncols, np.where(mid, ncolsc, 1)), np.where(small, ntx, np.where(mid, ntxc, 0))
    return offset, y0, x0, nc, stride, n


def key_of(keys, s, j):
    offset, y0, x0, nc, stride, _ = keys
    return offset[s] + (y0[s] + j // nc[s]) * stride[s] + x0[s] + j % nc[s]


def place_round(run, key, slot, ptri):
    """One round of bin_pairs_kernel: ``key`` and ``slot`` of up to 256
    consecutive pairs (thread t's pair t). Within each warp, a pair's rank
    among the earlier lanes of its key (``__match_any_sync``); then warp 0
    moves each key's running place on, warp by warp, and every pair lands
    at its group's place + its rank."""
    for w in range(0, key.size, 32):
        kw, sw = key[w:w + 32], slot[w:w + 32]
        for kk in np.unique(kw):
            lanes = np.flatnonzero(kw == kk)  # the match: lanes in order, the first the leader
            ptri[run[kk] + np.arange(lanes.size)] = sw[lanes]
            run[kk] += lanes.size


def mirror_bin_pairs(recs, bbox, *, n_ctx, th, grid_hw, k, kc, m_dummy, n_pad, origin=(0, 0)):
    """The four launches of ``kernels.bin_pairs``, in numpy → (off,
    tri_i32, tri_f32) in pair order."""
    recs, bbox = np.asarray(recs), np.asarray(bbox)
    m = recs.shape[0]
    nty, ntx = grid_hw
    n_keys = nty * ntx + cdiv(nty, COARSE) * cdiv(ntx, COARSE) + 1
    stripe, n_stripes = kernels.bin_stripes(m, n_keys)
    assert stripe % BLOCK == 0
    keys = slot_keys(bbox, th, grid_hw, k, kc, origin)
    n = keys[5]
    counts = np.zeros((n_stripes, n_keys), np.int64)  # bin_count_kernel
    for j in range(int(n.max(initial=0))):
        s = np.flatnonzero(j < n)
        np.add.at(counts, (s // stripe, key_of(keys, s, j)), 1)
    totals = counts.sum(0)  # bin_scan_kernel
    prefix = np.cumsum(counts, axis=0) - counts
    off = np.concatenate([[0], np.cumsum(totals)]).astype(np.int32)
    ptri = np.full(n_pad, -1, np.int64)  # bin_pairs_kernel
    for b in range(n_stripes):
        run = off[:-1].astype(np.int64) + prefix[b]
        hi = min((b + 1) * stripe, m)
        for base in range(b * stripe, hi, BLOCK):
            slots = np.arange(base, min(base + BLOCK, hi))
            counts_t = n[slots]
            total = int(counts_t.sum())
            if total == 0:
                continue
            pre = np.cumsum(counts_t) - counts_t
            for r in range(0, total, BLOCK):
                q = np.arange(r, min(r + BLOCK, total))
                lane_slot = np.searchsorted(pre, q, side="right") - 1  # the binary search
                s = slots[lane_slot]
                place_round(run, key_of(keys, s, q - pre[lane_slot]), s, ptri)
    assert (ptri[:off[-1]] >= 0).all()
    src = np.where(np.arange(n_pad) < off[-1], ptri, m_dummy)  # bin_gather_kernel
    pairs = recs[src]
    rows_f = 9 + 3 * n_ctx
    return off, pairs[:, :12].T.copy(), pairs[:, 12:12 + rows_f].T.copy().view(np.float32)


# ------------------------------------------------------------ cases


def three_draws(th=None, bin_k=None):
    """Three draws at 640 x 360 on the CPU, with the tile and bin_k."""
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.2, 0.0, 0.0], np.float32)
    cube2 = make_cube(0.6)
    cube2["pos"] = cube2["pos"] + np.array([-1.1, 0.3, 2.2], np.float32)
    scene = make_phong_scene(W, H, meshes=[make_uv_sphere(12, 24), cube, cube2], clip_cap=16,
                             textures=[make_checker_texture(16, 4)] * 3, device="cpu")
    scene.config = dataclasses.replace(scene.config, tile=None if th is None else (th, 128), bin_k=bin_k,
                                       tile_auto=th is None)
    return scene


def packed_scene(th=None, bin_k=None):
    """:func:`three_draws` through ``build_packed`` (the plain set-up on
    the CPU) → (config, records, bbox, slots, C)."""
    scene = three_draws(th, bin_k)
    recs, bbox, n, c, _ = build_packed(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    return scene.config, recs, bbox, n, c


def packed_rows(th=None, bin_k=None):
    """:func:`three_draws`' packed rows (``raster.pack_binned``)."""
    scene = three_draws(th, bin_k)
    tri, _ = build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    return raster.pack_binned(tri, W, H)


def bins(prep, k):
    """The args ``bin_packed`` gives the kernels for ``prep``'s grid."""
    return dict(n_ctx=prep.n_ctx, th=prep.th, grid_hw=(prep.h_pad // prep.th, prep.w_pad // LANES), k=k, kc=k)


def assert_equal(got, prep):
    off, ti, tf = got
    np.testing.assert_array_equal(off, prep.off.numpy())
    np.testing.assert_array_equal(ti, prep.tri_i32.numpy())
    assert np.array_equal(tf.view(np.int32), prep.tri_f32.numpy().view(np.int32))


def packed_sort(prep, m):
    n_keys = prep.off.numel()
    return n_keys.bit_length() + max((m - 1).bit_length(), 1) <= 31


@pytest.mark.parametrize("th", [16, 32, 64, 128])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_mirror_equals_plain(th, k):
    cfg, recs, bbox, n, c = packed_scene(th, k)
    prep = raster.bin_packed(recs, bbox, n, c, cfg.width, cfg.height, cfg.tile, tile_auto=False, bin_k=k)
    assert prep.th == th and packed_sort(prep, recs.shape[0])
    got = mirror_bin_pairs(recs, bbox, **bins(prep, k), m_dummy=n, n_pad=prep.tri_i32.shape[1])
    assert_equal(got, prep)
    off, ntiles = prep.off.numpy(), (prep.h_pad // th) * (prep.w_pad // LANES)
    assert off[-1] > 300 and (k > 1 or off[-1] > off[ntiles])  # at k = 1, coarse or spill pairs too


@pytest.mark.parametrize("sp", [2, 8])
def test_mirror_equals_plain_row_slabs(sp):
    """Row slabs with an origin, as tests/test_torch_origin.py cuts them, and
    cuts off the tile rows."""
    cfg, recs, bbox, n, c = packed_scene()
    slab = cfg.height // sp
    for y0, rows in [(lin * slab, slab) for lin in range(sp)] + [(8, 45), (45, 51)]:
        prep = raster.bin_packed(recs, bbox, n, c, cfg.width, cfg.height, cfg.tile, origin=(y0, 0),
                                 size=(rows, cfg.width))
        k = 4
        got = mirror_bin_pairs(recs, bbox, **bins(prep, k), m_dummy=n, n_pad=prep.tri_i32.shape[1],
                               origin=(y0, 0))
        assert_equal(got, prep)


def test_mirror_equals_plain_sharded_dummy():
    """The sharded frame's bin: the gathered columns' last one is the dummy
    (``parallel.sharding.fused_slab``)."""
    cfg, recs, bbox, n, c = packed_scene()
    m = recs.shape[0]
    prep = raster.bin_packed(recs, bbox, n, c, cfg.width, cfg.height, cfg.tile, origin=(90, 0),
                             size=(90, cfg.width), m_dummy=m - 1)
    got = mirror_bin_pairs(recs, bbox, **bins(prep, 4), m_dummy=m - 1, n_pad=prep.tri_i32.shape[1],
                           origin=(90, 0))
    assert_equal(got, prep)
    assert (prep.tri_i32.numpy()[raster.SLOT, int(prep.off[-1]):] == 0).all()  # the dummy: a padding column


def test_mirror_two_operand_sort_is_a_permutation():
    """Keys past 31 bits with the slot: the plain version sorts stably by
    key alone, so a key's pairs follow j, then the slot; the kernels order
    them by slot. ``off`` is equal, each list holds the same pairs, and
    each pair column is its slot's."""
    rng = np.random.default_rng(4)
    m = (1 << 20) + 128
    ti = np.zeros((12, m), np.int32)
    tf = np.zeros((9, m), np.float32)
    live = rng.choice(m - 128, 30_000, replace=False)
    x0, y0 = rng.integers(0, 1900, live.size), rng.integers(0, 1070, live.size)
    wh = rng.integers(1, 300, (2, live.size))  # spans of one to a few dozen tiles: all three levels
    ti[MINXY, live] = x0 | (y0 << 16)
    ti[MAXXY, live] = np.minimum(x0 + wh[0], 1920) | (np.minimum(y0 + wh[1], 1080) << 16)
    ti[raster.SLOT] = np.arange(m)
    tf[0] = np.arange(m, dtype=np.float32)
    ti_t, tf_t = torch.from_numpy(ti), torch.from_numpy(tf)
    recs, bbox = raster.slot_records(ti_t, tf_t), ti_t[MINXY:MAXXY + 1]
    prep = raster.bin_packed(recs, bbox, m - 1, 0, 1920, 1080, (16, 128), tile_auto=False, bin_k=2)
    assert not packed_sort(prep, m)
    off, got_i, got_f = mirror_bin_pairs(recs, bbox, **bins(prep, 2), m_dummy=m - 1, n_pad=prep.tri_i32.shape[1])
    want = prep.off.numpy()
    np.testing.assert_array_equal(off, want)
    plain_slots = prep.tri_i32.numpy()[raster.SLOT]
    for key in range(want.size - 1):
        a, b = want[key], want[key + 1]
        assert sorted(got_i[raster.SLOT, a:b]) == sorted(plain_slots[a:b])
        assert (np.diff(got_i[raster.SLOT, a:b]) > 0).all()  # by slot
    np.testing.assert_array_equal(got_i[:, want[-1]:], prep.tri_i32.numpy()[:, want[-1]:])
    assert (got_f[0] == got_i[raster.SLOT]).all()  # every row is its slot's


def test_rows_path_equals_records_path():
    """``bin_rows`` (packed rows: their records, ``raster.slot_records``,
    and their own bbox rows) gives the prep of ``bin_packed`` on the
    set-up's records, and the records' own bbox words give it too."""
    cfg, recs, bbox, n, c = packed_scene()
    ti, tf = packed_rows()
    args = (n, c, cfg.width, cfg.height, cfg.tile)
    want = raster.bin_packed(recs, bbox, *args)
    for got in (raster.bin_rows(ti, tf, *args), raster.bin_packed(recs, recs[:, MINXY:MAXXY + 1].T, *args)):
        assert torch.equal(got.off, want.off) and torch.equal(got.tri_i32, want.tri_i32)
        assert torch.equal(got.tri_f32.view(torch.int32), want.tri_f32.view(torch.int32))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On the card: ``bin_packed`` (the binning kernels, launches counted)
    equals its plain version on the CPU, for the tiles, k and slabs above,
    from the set-up's bbox array, from the records' own bbox words and from
    packed rows (``bin_rows``: the plain records, then the binning). Run it with
    ``python -m pytest --noconftest -m cuda tests/test_torch_bin_kernel.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for th, k, origin, size in [(16, 1, (0, 0), None), (32, 2, (0, 0), None), (64, 4, (0, 0), None),
                                (128, 4, (0, 0), None), (None, None, (45, 0), (90, W)), (None, None, (8, 0), (37, W))]:
        cfg, recs, bbox, n, c = packed_scene(th, k)
        ti, tf = packed_rows(th, k)
        args = (n, c, cfg.width, cfg.height, cfg.tile)
        kw = dict(tile_auto=th is None, bin_k=k, origin=origin, size=size)
        want = raster.bin_packed(recs, bbox, *args, **kw)
        r, b = recs.cuda(), bbox.cuda()
        for run in (lambda: raster.bin_packed(r, b, *args, **kw),
                    lambda: raster.bin_packed(r, r[:, MINXY:MAXXY + 1].T, *args, **kw),
                    lambda: raster.bin_rows(ti.cuda(), tf.cuda(), *args, **kw)):
            before = kernels.bin_pairs.launches
            got = run()
            assert kernels.bin_pairs.launches == before + 1
            assert torch.equal(got.off.cpu(), want.off) and torch.equal(got.tri_i32.cpu(), want.tri_i32)
            assert torch.equal(got.tri_f32.cpu().view(torch.int32), want.tri_f32.view(torch.int32))
