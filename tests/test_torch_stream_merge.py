"""The stream mode's per-round merge (``parallel.sharding``).

Each round of the sharded frame's stream mode merges K4's planes for the
shard a rank holds into the slab's accumulator by the lexicographic (rhw,
order) maximum. On the card ``kernels.stream_merge`` (csrc/stream_merge.cu)
does it in place; its plain version ``sharding.stream_merge_plain`` is what
the CPU and the portable backend run, and what the card holds the kernel
to (``chip_smoke.py``'s ``stream_phase``). Here:

- ``stream_merge_plain`` against a numpy transcription of the JAX
  package's merge of a round (f_renderer_tpu/parallel/sharding.py:224-245),
  bit for bit, on seeded planes with forced ties: equal depths with a
  higher, an equal and a lower order, -0.0 against 0.0, NaN depths,
  ORDER_NONE in the accumulator, -1 winners on either side, owner 0 and
  owner > 0, and the round's planes padded as K4 pads them;
- the in-place ``stream_round`` (K4's plain version, then the plain merge;
  the first round writing the accumulator whole) over two- and four-round
  sequences on the kernels backend, equal to the composition it replaced
  (functional merges from ``stream_start``'s fills, the orders int64);
- the first round's write equal to the merge against ``stream_start``'s
  fills on K4's planes, which leave depth +0.0, winner -1, ps 0 and ctx 0
  where no pair won;
- the portable backend's rounds equal to the composition they replaced;
- ``kernels.stream_merge`` raises on CPU tensors: nothing falls back.

The ``cuda`` test holds the kernel to the plain version on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_stream_merge.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import kernels
from f_renderer_tpu_torch.parallel import sharding
from f_renderer_tpu_torch.pipeline import raster
from f_renderer_tpu_torch.pipeline.raster import ORDER, ORDER_NONE

REC = 36  # words of a record in the crafted cases (any width with an order word)
DEPTHS = np.array([0.0, -0.0, 0.25, 0.5, 1.0, np.nan], np.float32)


def jax_merge_np(acc, d_r, win_r, ps_r, ctx_r, order, owner, m_local):
    """The JAX package's merge of round r (f_renderer_tpu/parallel/
    sharding.py:224-245) in numpy: ``win_r`` the shard's local winners,
    ``order`` its (m_local,) orders, ``ctx_r`` / the accumulator's ctx
    (slab, W, C) as there → the merged (depth, worder, winner, psx, ctxp)."""
    depth, worder, winner, psx, ctxp = acc
    o_r = np.where(win_r >= 0, np.take(order, np.maximum(win_r, 0)), np.int32(ORDER_NONE))
    better = (d_r > depth) | ((d_r >= depth) & (o_r > worder))
    depth = np.where(better, d_r, depth)
    worder = np.where(better, o_r, worder)
    winner = np.where(better, np.where(win_r >= 0, win_r + owner * m_local, -1), winner)
    psx = np.where(better, ps_r, psx)
    ctxp = np.where(better[..., None], ctx_r, ctxp)
    return depth, worder, winner, psx, ctxp


def crafted_round(seed, h, w, n_ctx, m, pad=(5, 7)):
    """Seeded accumulator planes (slab, W, C as the JAX package holds them)
    and a round's (depth, local winner, ps, ctx (slab, W, C)) with forced
    ties, the shard's records (their ORDER words few and small, so equal
    orders meet), and the round's planes padded by ``pad`` rows / columns
    of garbage as K4 pads them."""
    rng = np.random.default_rng(seed)
    shape = (h, w)
    acc = (
        rng.choice(DEPTHS[:5], shape),  # the accumulator holds no NaN: no round writes one into it
        rng.choice(np.array([ORDER_NONE, 0, 1, 2, 3], np.int32), shape),
        rng.integers(-1, 4 * m, shape, dtype=np.int32),
        rng.integers(0, 9, shape, dtype=np.int32),
        rng.standard_normal((h, w, n_ctx)).astype(np.float32),
    )
    acc[2][acc[1] == ORDER_NONE] = -1
    records = rng.integers(-(2 ** 31), 2 ** 31 - 1, (m, REC), dtype=np.int64).astype(np.int32)
    records[:, ORDER] = rng.integers(0, 4, m)
    win_r = rng.integers(-1, m, shape, dtype=np.int32)
    d_r = rng.choice(DEPTHS, shape)
    d_r[win_r < 0] = rng.choice(DEPTHS[:2], int((win_r < 0).sum()))  # no winner: 0.0 or -0.0
    ps_r = np.where(win_r >= 0, rng.integers(0, 9, shape), 0).astype(np.int32)
    ctx_r = np.where((win_r >= 0)[..., None], rng.standard_normal((h, w, n_ctx)), 0).astype(np.float32)
    return acc, (d_r, win_r, ps_r, ctx_r), records, pad


def padded(plane, pad, fill):
    """``plane`` (h, w) or (C, h, w) in the corner of a larger plane of ``fill``."""
    shape = plane.shape[:-2] + (plane.shape[-2] + pad[0], plane.shape[-1] + pad[1])
    out = torch.full(shape, fill, dtype=plane.dtype)
    out[..., :plane.shape[-2], :plane.shape[-1]] = plane
    return out


def port_inputs(acc, rnd, records, owner, pad):
    """The crafted case as the port holds it: an accumulator of (C, slab, W)
    ctx and K4's padded planes with global winners."""
    depth, worder, winner, psx, ctxp = acc
    d_r, win_r, ps_r, ctx_r = rnd
    m = records.shape[0]
    planes = sharding.StreamPlanes(
        depth=torch.from_numpy(depth.copy()), order=torch.from_numpy(worder.copy()),
        winner=torch.from_numpy(winner.copy()), ps=torch.from_numpy(psx.copy()),
        ctx=torch.from_numpy(np.ascontiguousarray(ctxp.transpose(2, 0, 1))))
    win_g = np.where(win_r >= 0, win_r + owner * m, -1).astype(np.int32)
    k4 = (padded(torch.from_numpy(d_r), pad, float("nan")), padded(torch.from_numpy(win_g), pad, 12345),
          padded(torch.from_numpy(ps_r), pad, 77),
          padded(torch.from_numpy(np.ascontiguousarray(ctx_r.transpose(2, 0, 1))), pad, float("inf")))
    return planes, k4, torch.from_numpy(records)


def bits(t):
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_planes_equal(got: sharding.StreamPlanes, want):
    """``got`` bit for bit equal to ``want`` (depth, order, winner, ps, ctx
    (C, slab, W)); NaNs by their bits too."""
    for name, a, b in zip(("depth", "order", "winner", "ps", "ctx"), got.planes(), want):
        assert a.dtype == b.dtype, name
        assert torch.equal(bits(a), bits(b)), f"{name} differs"


@pytest.mark.parametrize("owner,n_ctx", [(0, 3), (1, 8), (3, 0), (2, 12)])
def test_plain_merge_matches_jax_transcription(owner, n_ctx):
    m = 40
    acc, rnd, records, pad = crafted_round(100 + owner + n_ctx, 19, 70, n_ctx, m)
    d_r, win_r, acc_depth, acc_order = rnd[0], rnd[1], acc[0], acc[1]
    o_r = np.where(win_r >= 0, records[:, ORDER][np.maximum(win_r, 0)], ORDER_NONE)
    eq = d_r == acc_depth
    # the ties the case must hold: equal depth with a higher, an equal and a lower order, -0.0 against 0.0,
    # NaN, ORDER_NONE on either side, -1 winners on either side
    assert (eq & (o_r > acc_order)).sum() > 5 and (eq & (o_r == acc_order)).sum() > 5
    assert (eq & (o_r < acc_order)).sum() > 5
    assert (eq & (np.signbit(d_r) != np.signbit(acc_depth))).sum() > 5
    assert np.isnan(d_r).sum() > 5 and (acc_order == ORDER_NONE).sum() > 5 and (win_r < 0).sum() > 5
    assert (eq & (win_r < 0) & (acc_order == ORDER_NONE)).sum() > 0
    want = jax_merge_np(acc, *rnd, records[:, ORDER], owner, m)
    planes, k4, recs = port_inputs(acc, rnd, records, owner, pad)
    sharding.stream_merge_plain(planes, *k4, recs[:, ORDER], owner * m)
    depth, worder, winner, psx, ctxp = (torch.from_numpy(np.ascontiguousarray(a)) for a in want)
    assert_planes_equal(planes, (depth, worder, winner, psx, ctxp.permute(2, 0, 1)))
    better = (d_r > acc_depth) | ((d_r >= acc_depth) & (o_r > acc_order))
    assert 0 < better.sum() < better.size  # some pixels merged, some kept


def scene_shards(n_dp, n_sp, backend="kernels", size=(128, 96)):
    """A phong scene's shards for an (n_dp, n_sp) grid, on the CPU: (config,
    plan, the shards' (records, bbox) or TriangleBuffers, m, C)."""
    from f_renderer_tpu_torch.scene import make_phong_scene

    scene = make_phong_scene(*size, device="cpu")
    cfg = dataclasses.replace(scene.config, comm_mode="stream", fused_shade=False, backend=backend)
    plan = sharding.shard_plan(scene.draws, cfg, n_dp, n_sp)
    setups = [sharding.setup_shard(scene.draws, scene.vertex_shader, scene.vs_uniform, cfg, plan, dp)
              for dp in range(n_dp)]
    totals = sharding.reduce_quirk(setups)
    if backend == "kernels":
        shards = [sharding.shard_records(s, totals, cfg) for s in setups]
    else:
        shards = [sharding.finish_shard(s, totals) for s in setups]
    return cfg, plan, shards, setups[0].m, setups[0].n_ctx


def old_merge(acc, d, o, win, ps, ctx):
    """The functional merge the in-place one replaced."""
    better = (d > acc.depth) | ((d >= acc.depth) & (o > acc.order))
    return sharding.StreamPlanes(*(torch.where(better, a, b) for a, b in zip((d, o, win, ps, ctx), acc.planes())))


def old_start(n_ctx, cfg, plan):
    shape = (plan.slab, cfg.width)
    return sharding.StreamPlanes(torch.zeros(shape), torch.full(shape, ORDER_NONE, dtype=torch.int64),
                                 torch.full(shape, -1, dtype=torch.int32), torch.zeros(shape, dtype=torch.int32),
                                 torch.zeros((n_ctx,) + shape))


@pytest.mark.parametrize("n_dp,n_sp", [(2, 2), (4, 1)])
def test_in_place_rounds_match_functional_composition(n_dp, n_sp):
    """Two and four rounds a slab through the in-place ``stream_round`` equal
    the functional composition: ``raster.interp_planes`` (K4's planes
    cropped), the orders gathered and cast to int64, ``old_merge`` from the
    fills."""
    cfg, plan, shards, m, n_ctx = scene_shards(n_dp, n_sp)
    covered = 0
    for dp in range(n_dp):
        for sp in range(n_sp):
            lin = dp * n_sp + sp
            acc, old = None, old_start(n_ctx, cfg, plan)
            for r in range(n_dp):
                owner = (dp - r) % n_dp
                recs, bbox = shards[owner]
                acc = sharding.stream_round(acc, recs, bbox, m, n_ctx, owner, cfg, plan, lin)
                ctx, ps, win, d = raster.interp_planes(sharding.bin_slab(recs, bbox, m, n_ctx, cfg, plan, lin))
                local = torch.clamp(win - owner * recs.shape[0], min=0).long()
                o = torch.where(win >= 0, recs[:, ORDER][local].long(), ORDER_NONE)
                old = old_merge(old, d, o, win, ps, ctx)
            assert acc.order.dtype == torch.int32
            assert_planes_equal(acc, (old.depth, old.order.to(torch.int32), old.winner, old.ps, old.ctx))
            covered += int((acc.winner >= 0).sum())
    assert covered > 1000


@pytest.mark.parametrize("n_dp,n_sp", [(2, 2), (4, 1)])
def test_first_round_write_equals_merge_against_fills(n_dp, n_sp):
    """K4's planes (its plain version) for every slab and shard: where no
    pair won, depth +0.0, ps 0 and ctx 0; where one won, depth >= 0 and an
    order above ORDER_NONE. So the first round's write gives the bits of the
    merge against ``stream_start``'s fills."""
    cfg, plan, shards, m, n_ctx = scene_shards(n_dp, n_sp)
    for lin in range(n_dp * n_sp):
        for owner, (recs, bbox) in enumerate(shards):
            depth, winner, ps, ctx = raster.raster_planes(sharding.bin_slab(recs, bbox, m, n_ctx, cfg, plan, lin),
                                                          interp=True)
            none = winner < 0
            assert torch.equal(bits(depth[none]), torch.zeros(int(none.sum()), dtype=torch.int32))
            assert not ps[none].any() and not ctx[:, none].any()
            assert bool((depth[~none] >= 0).all()) and bool((recs[:, ORDER] > ORDER_NONE).all())
            fills = sharding.stream_start(n_ctx, cfg, plan, "cpu")
            sharding.stream_merge_plain(fills, depth, winner, ps, ctx, recs[:, ORDER], owner * recs.shape[0])
            first = sharding.stream_start(n_ctx, cfg, plan, "cpu", fill=False)
            for t in first.planes():
                t.fill_(7)  # the first round must write every pixel
            sharding.stream_merge_plain(first, depth, winner, ps, ctx, recs[:, ORDER], owner * recs.shape[0],
                                        first=True)
            assert_planes_equal(first, fills.planes())


def test_portable_rounds_match_functional_composition():
    """The portable backend's rounds (``rasterize_portable``,
    ``interpolate_context``, the plain merge in place) equal the functional
    composition they replaced."""
    from f_renderer_tpu_torch.pipeline.raster_portable import rasterize_portable
    from f_renderer_tpu_torch.pipeline.shade import interpolate_context

    n_dp, n_sp = 2, 2
    cfg, plan, tris, _, n_ctx = scene_shards(n_dp, n_sp, backend="portable", size=(64, 48))
    w, h, slab = cfg.width, cfg.height, plan.slab
    for dp in range(n_dp):
        for sp in range(n_sp):
            lin = dp * n_sp + sp
            acc, old = sharding.stream_start(n_ctx, cfg, plan, "cpu"), old_start(n_ctx, cfg, plan)
            for r in range(n_dp):
                owner = (dp - r) % n_dp
                tri = tris[owner]
                acc = sharding.stream_round_portable(acc, tri, owner, cfg, plan, lin)
                win, d = rasterize_portable(tri, w, slab, origin=(lin * slab, 0), full_size=(h, w))
                ctx, ps = interpolate_context(tri, win, w, slab, origin=(lin * slab, 0))
                o = torch.where(win >= 0, tri.order[torch.clamp(win, min=0).long()].long(), ORDER_NONE)
                old = old_merge(old, d, o, torch.where(win >= 0, win + owner * tri.num_slots, -1), ps, ctx)
            assert_planes_equal(acc, (old.depth, old.order.to(torch.int32), old.winner, old.ps, old.ctx))


def test_kernel_wrapper_raises_on_cpu_tensors():
    acc, rnd, records, pad = crafted_round(7, 8, 16, 2, 10)
    planes, k4, recs = port_inputs(acc, rnd, records, 1, pad)
    before = kernels.stream_merge.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stream_merge(*k4, recs, planes.planes(), slot0=10)
    assert kernels.stream_merge.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On the card: ``kernels.stream_merge`` equals ``stream_merge_plain``
    bit for bit on the crafted rounds (merging and first), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for seed, (owner, n_ctx) in enumerate([(0, 3), (1, 8), (3, 0), (2, 12)]):
        m = 40
        acc, rnd, records, pad = crafted_round(seed, 19, 300, n_ctx, m)
        for first in (False, True):
            want, k4, recs = port_inputs(acc, rnd, records, owner, pad)
            got = sharding.StreamPlanes(*(t.cuda() for t in want.planes()))
            sharding.stream_merge_plain(want, *k4, recs[:, ORDER], owner * m, first)
            before = kernels.stream_merge.launches
            kernels.stream_merge(*(t.cuda() for t in k4), recs.cuda(), got.planes(), slot0=owner * m, first=first)
            assert kernels.stream_merge.launches == before + 1
            assert_planes_equal(sharding.StreamPlanes(*(t.cpu() for t in got.planes())), want.planes())
