"""The binning kernels (csrc/bin_pairs.cu) against their plain version,
``raster.bin_packed`` on CPU tensors (``bin_pairs``' sort and two
``index_select``).

The kernels run only on the card. Here a numpy mirror of their counting
sort stands in for them: the same stripes of slots (``kernels.bin_stripes``),
each stripe's count per key, the exclusive scans over the stripes and over
the keys (``off``), each pair placed at off[key] + its stripe's prefix +
the pairs of that key earlier in the stripe (slot order), the padding pairs
pointing at ``m_dummy``, and every packed row gathered. Where the plain
version takes the packed 31-bit sort, ``off`` and every pair column must
equal it bit for bit: both order the pairs by (key, slot). Cases: tiles of
16, 32, 64 and 128 rows, k = 1, 2 and 4, the row slabs of
tests/test_torch_origin.py (an origin), the sharded frame's ``m_dummy`` (the
last column). Where it takes the stable two-operand sort (keys past 31
bits), ``off`` is equal and each key's list is a permutation of the plain
one. On the card the kernels are held to the plain version (``cuda``
test).
"""

import dataclasses

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import kernels, make_checker_texture, make_cube, make_phong_scene, make_uv_sphere
from f_renderer_tpu_torch.pipeline import raster
from f_renderer_tpu_torch.pipeline.raster import COARSE, LANES, MAXXY, MINXY, cdiv
from f_renderer_tpu_torch.pipeline.render import build_packed

W, H = 640, 360


# ------------------------------------------------------------ the mirror


def slot_keys(ti, th, grid_hw, k, kc, origin):
    """Each slot's pair keys, as the kernels' ``slot_keys`` computes them
    → (slot ids, keys) of every pair, slot-major."""
    nty, ntx = grid_hw
    oy, ox = origin
    lo, hi = ti[MINXY].astype(np.int64), ti[MAXXY].astype(np.int64)
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
    slots, keys = [], []
    for j in range(max(k, kc)):
        on = j < n
        s = np.nonzero(on)[0]
        slots.append(s)
        keys.append(offset[s] + (y0[s] + j // nc[s]) * stride[s] + x0[s] + j % nc[s])
    slots, keys = np.concatenate(slots), np.concatenate(keys)
    order = np.lexsort((keys, slots))  # slot-major, a slot's keys in j order
    return slots[order], keys[order]


def mirror_bin_pairs(tri_i32, tri_f32, *, th, grid_hw, k, kc, m_dummy, n_pad, origin=(0, 0)):
    """The five launches of ``kernels.bin_pairs``, in numpy → (off, tri_i32,
    tri_f32) in pair order."""
    ti, tf = np.asarray(tri_i32), np.asarray(tri_f32)
    m = ti.shape[1]
    nty, ntx = grid_hw
    n_keys = nty * ntx + cdiv(nty, COARSE) * cdiv(ntx, COARSE) + 1
    stripe, n_stripes = kernels.bin_stripes(m, n_keys)
    slots, keys = slot_keys(ti, th, grid_hw, k, kc, origin)
    stripes = slots // stripe
    counts = np.zeros((n_keys, n_stripes), np.int64)  # bin_count_kernel
    np.add.at(counts, (keys, stripes), 1)
    prefix = np.cumsum(counts, axis=1) - counts  # bin_scan_kernel
    off = np.concatenate([[0], np.cumsum(counts.sum(1))]).astype(np.int32)  # bin_offsets_kernel
    # bin_pairs_kernel: a stripe's slots in order, each key's pairs counted on
    by = np.lexsort((slots, stripes, keys))
    group = keys[by] * n_stripes + stripes[by]
    first = np.r_[True, group[1:] != group[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(by.size), 0))
    rank = np.arange(by.size) - start
    ptri = np.zeros(n_pad, np.int64)
    ptri[off[keys[by]] + prefix[keys[by], stripes[by]] + rank] = slots[by]
    src = np.where(np.arange(n_pad) < off[-1], ptri, m_dummy)  # bin_gather_kernel
    return off, ti[:, src], tf[:, src]


# ------------------------------------------------------------ cases


def packed_scene(th=None, bin_k=None):
    """Three draws at 640 x 360 through ``build_packed`` (the plain set-up
    on the CPU)."""
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.2, 0.0, 0.0], np.float32)
    cube2 = make_cube(0.6)
    cube2["pos"] = cube2["pos"] + np.array([-1.1, 0.3, 2.2], np.float32)
    scene = make_phong_scene(W, H, meshes=[make_uv_sphere(12, 24), cube, cube2], clip_cap=16,
                             textures=[make_checker_texture(16, 4)] * 3, device="cpu")
    scene.config = dataclasses.replace(scene.config, tile=None if th is None else (th, 128), bin_k=bin_k,
                                       tile_auto=th is None)
    ti, tf, n, c, _ = build_packed(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    return scene.config, ti, tf, n, c


def bins(prep, k):
    """The args ``bin_packed`` gives the kernels for ``prep``'s grid."""
    return dict(th=prep.th, grid_hw=(prep.h_pad // prep.th, prep.w_pad // LANES), k=k, kc=k)


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
    cfg, ti, tf, n, c = packed_scene(th, k)
    prep = raster.bin_packed(ti, tf, n, c, cfg.width, cfg.height, cfg.tile, tile_auto=False, bin_k=k)
    assert prep.th == th and packed_sort(prep, ti.shape[1])
    got = mirror_bin_pairs(ti, tf, **bins(prep, k), m_dummy=n, n_pad=prep.tri_i32.shape[1])
    assert_equal(got, prep)
    off, ntiles = prep.off.numpy(), (prep.h_pad // th) * (prep.w_pad // LANES)
    assert off[-1] > 300 and (k > 1 or off[-1] > off[ntiles])  # at k = 1, coarse or spill pairs too


@pytest.mark.parametrize("sp", [2, 8])
def test_mirror_equals_plain_row_slabs(sp):
    """Row slabs with an origin, as tests/test_torch_origin.py cuts them, and
    cuts off the tile rows."""
    cfg, ti, tf, n, c = packed_scene()
    slab = cfg.height // sp
    for y0, rows in [(lin * slab, slab) for lin in range(sp)] + [(8, 45), (45, 51)]:
        prep = raster.bin_packed(ti, tf, n, c, cfg.width, cfg.height, cfg.tile, origin=(y0, 0),
                                 size=(rows, cfg.width))
        k = 4
        got = mirror_bin_pairs(ti, tf, **bins(prep, k), m_dummy=n, n_pad=prep.tri_i32.shape[1], origin=(y0, 0))
        assert_equal(got, prep)


def test_mirror_equals_plain_sharded_dummy():
    """The sharded frame's bin: the gathered columns' last one is the dummy
    (``parallel.sharding.fused_slab``)."""
    cfg, ti, tf, n, c = packed_scene()
    m = ti.shape[1]
    prep = raster.bin_packed(ti, tf, n, c, cfg.width, cfg.height, cfg.tile, origin=(90, 0), size=(90, cfg.width),
                             m_dummy=m - 1)
    got = mirror_bin_pairs(ti, tf, **bins(prep, 4), m_dummy=m - 1, n_pad=prep.tri_i32.shape[1], origin=(90, 0))
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
    prep = raster.bin_packed(ti_t, tf_t, m - 1, 0, 1920, 1080, (16, 128), tile_auto=False, bin_k=2)
    assert not packed_sort(prep, m)
    off, got_i, got_f = mirror_bin_pairs(ti, tf, **bins(prep, 2), m_dummy=m - 1, n_pad=prep.tri_i32.shape[1])
    want = prep.off.numpy()
    np.testing.assert_array_equal(off, want)
    plain_slots = prep.tri_i32.numpy()[raster.SLOT]
    for key in range(want.size - 1):
        a, b = want[key], want[key + 1]
        assert sorted(got_i[raster.SLOT, a:b]) == sorted(plain_slots[a:b])
        assert (np.diff(got_i[raster.SLOT, a:b]) > 0).all()  # by slot
    np.testing.assert_array_equal(got_i[:, want[-1]:], prep.tri_i32.numpy()[:, want[-1]:])
    assert (got_f[0] == got_i[raster.SLOT]).all()  # every row is its slot's


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On the card: ``bin_packed`` (the binning kernels, launches counted)
    equals its plain version on the CPU, for the tiles, k and slabs above.
    Run it with ``python -m pytest --noconftest -m cuda
    tests/test_torch_bin_kernel.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for th, k, origin, size in [(16, 1, (0, 0), None), (32, 2, (0, 0), None), (64, 4, (0, 0), None),
                                (128, 4, (0, 0), None), (None, None, (45, 0), (90, W)), (None, None, (8, 0), (37, W))]:
        cfg, ti, tf, n, c = packed_scene(th, k)
        args = (n, c, cfg.width, cfg.height, cfg.tile)
        kw = dict(tile_auto=th is None, bin_k=k, origin=origin, size=size)
        want = raster.bin_packed(ti, tf, *args, **kw)
        before = kernels.bin_pairs.launches
        got = raster.bin_packed(ti.cuda(), tf.cuda(), *args, **kw)
        assert kernels.bin_pairs.launches == before + 1
        assert torch.equal(got.off.cpu(), want.off) and torch.equal(got.tri_i32.cpu(), want.tri_i32)
        assert torch.equal(got.tri_f32.cpu().view(torch.int32), want.tri_f32.view(torch.int32))
