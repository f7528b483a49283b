"""Multi-device rendering on ``torch.distributed``.

Port of ``f_renderer_tpu/parallel/sharding.py``. The ranks form a (dp, sp)
process grid (:func:`make_render_mesh`, a ``DeviceMesh``):

- ``dp`` shards the faces. Every rank is handed the whole draws and runs the
  set-up of its contiguous block of faces, padded with degenerate faces
  to a multiple of dp; submission order survives through per-shard order
  offsets, so the (rhw, order) merge sees the single frame's orders. The
  ps-boundary quirk reduces its per-draw counts and least slots over dp.
- ``sp`` cuts the frame into row slabs: rank (dp, sp) renders rows
  ``[lin · slab, (lin + 1) · slab)``, ``lin = dp · n_sp + sp``, through the
  raster kernels with an origin. Slabs are disjoint, so no merge of frames
  is needed.

The kernels backend hands the slabs slot records (``raster.slot_records``'
layout). On the card each shard's set-up runs the triangle set-up kernels
in their shard mode (``geometry.packed_geometry(shard=)``): they write the
shard's records, whose SLOT words are global (shard d's follow the d
shards before it, ``d · m_pad`` on), and accumulate the quirk's per-draw
counts and least keys; the counts are summed and the keys reduced by their
unsigned maximum over dp (:func:`all_reduce_quirk`, outside the clip path's
conditional node, on every rank), and ``kernels.tri_quirk`` applies the
quirk to the shard's own slots. On the CPU (:func:`setup_shard_plain`) the
same records come from the PyTorch geometry (:func:`shard_geometry`), the
quirk's partials reduced over dp, ``pack_shard`` and
``raster.slot_records``. The portable backend keeps the TriangleBuffer.

How the triangles reach a slab (``RenderConfig.comm_mode``):

- ``None`` / ``"all_gather"``: the records are all-gathered over dp (joined
  on their slot axis, the first) with their bbox words (the last), binned
  for the slab (``raster.bin_packed(origin=, size=, m_dummy=)``, the dummy
  the last shard's last padding record) and rendered by K1 (the fused
  path), or by K4 without varyings and the winners' interpolation from
  their records (``shade.interp_records``: csrc/interp_records.cu), then
  the pixel shader (the gather path). The portable backend all-gathers the
  TriangleBuffer, then ``rasterize_portable`` and ``shade_deferred``;
- ``"stream"`` with dp > 1: the shards' records travel round a dp ring of
  send / receive pairs, n_dp rounds; each round bins the shard it holds and
  rasterizes and interpolates it (K4 with varyings), and
  ``stream_merge_kernel`` (csrc/stream_merge.cu; plain
  :func:`stream_merge_plain`, which the CPU runs) merges K4's padded planes
  into the slab's accumulator (:class:`StreamPlanes`, its order plane
  int32) in place by (rhw, order), the first round writing it whole; the
  portable backend rasterizes and runs ``interpolate_context`` on the
  TriangleBuffer and merges by :func:`stream_merge_plain`. The pixel shader
  runs once on the merged planes.

The step is written as stage functions of (rank coordinates, inputs), with
each collective one small function between them, so that
:func:`render_frame_grid` can run every rank's stages of a grid in one
process, ``torch.cat`` standing in for the all-gather, sums and maxima on
the device for the all-reduce and a walk over the shards for the ring;
:func:`render_frame_sharded` runs the real collectives. Both are bit-equal
to the single-device frame as long as no shard drops a face past its
``clip_cap`` (each shard keeps its own cap, as in the JAX package).

A slab shorter than the bin tile keeps a tile height the kernels take: the
prep rasterizes ``cdiv(slab, th) · th`` rows and crops (``raster.bin_packed``),
where the JAX package shrinks the tile to ``min(th, slab)``. Both are exact.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from f_renderer_tpu_torch.device import resolve_device
from f_renderer_tpu_torch.pipeline import raster
from f_renderer_tpu_torch.pipeline.fused import bin_settings, fused_path_ok, render_fused_prepared
from f_renderer_tpu_torch.pipeline.geometry import MAX_FAN, geometry_process, packed_geometry
from f_renderer_tpu_torch.pipeline.raster import MAXXY, MINXY, ORDER, ORDER_NONE, SLOT, pack_binned
from f_renderer_tpu_torch.pipeline.raster_portable import rasterize_portable
from f_renderer_tpu_torch.pipeline.render import (
    RenderConfig,
    apply_ps_quirk_totals,
    context_codec,
    ps_quirk_partials,
)
from f_renderer_tpu_torch.pipeline.shade import interp_records, interpolate_context, shade_deferred, shade_from_planes
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer

COMM_MODES = ("all_gather", "stream")
# XOR with the top bit: unsigned 64-bit order as signed order, and back
I64_TOP = -(2**63)


def make_render_mesh(dp: int | None = None, sp: int | None = None, device_type: str = "cuda"):
    """A ("dp", "sp") ``DeviceMesh`` over every rank of the initialized
    process group: by default dp = 1 and sp = the world size, else the
    missing factor from the other (JAX ``make_render_mesh``).

    The process group must already be initialized (NCCL on cards, gloo for
    ``device_type="cpu"``); each rank's card is ``cuda:LOCAL_RANK``.
    Raises without a process group, or without CUDA when asked for it.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_render_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group first (nccl on cards, gloo on the CPU)"
        )
    n = dist.get_world_size()
    if dp is None and sp is None:
        dp, sp = 1, n
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp * sp = {dp * sp} != {n} ranks")
    if device_type == "cuda":
        resolve_device("cuda")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return init_device_mesh(device_type, (dp, sp), mesh_dim_names=("dp", "sp"))


# ---------------------------------------------------------------------------
# Stages: functions of the rank's coordinates and its inputs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The static shape of a sharded frame."""

    n_dp: int
    n_sp: int
    slab: int  # rows a rank renders
    faces: tuple  # each draw's face count, padded to a multiple of n_dp


def shard_plan(draws: Sequence, config: RenderConfig, n_dp: int, n_sp: int) -> ShardPlan:
    if config.height % (n_dp * n_sp):
        raise ValueError(f"height {config.height} must divide by the {n_dp * n_sp} ranks")
    faces = tuple(-(-next(iter(d.values())).shape[0] // n_dp) * n_dp for d in draws)
    return ShardPlan(n_dp, n_sp, config.height // (n_dp * n_sp), faces)


def pad_faces(vs_inputs: dict, f_pad: int) -> dict:
    """Pad the face axis to ``f_pad`` with degenerate faces: corner 0 of
    face 0 on all three corners, which has zero area and covers no pixel
    (JAX ``_pad_faces``)."""
    def pad(v):
        extra = f_pad - v.shape[0]
        return torch.cat([v, v[0:1, 0:1].expand(extra, *v.shape[1:])]) if extra else v

    return {k: pad(v) for k, v in vs_inputs.items()}


def shard_blocks(draws, plan: ShardPlan, dp: int):
    """Face shard ``dp`` of every draw → (its blocks, each draw's faces
    ``[dp · f_local, (dp + 1) · f_local)`` of its padded faces (views where
    no face pads), and each block's first order ``base_d + dp · f_local ·
    MAX_FAN``, ``base_d`` the padded faces of the draws before)."""
    blocks, bases, base = [], [], 0
    for vs_inputs, f_pad in zip(draws, plan.faces):
        f_local = f_pad // plan.n_dp
        blocks.append({k: v[dp * f_local:(dp + 1) * f_local] for k, v in pad_faces(vs_inputs, f_pad).items()})
        bases.append(base + dp * f_local * MAX_FAN)
        base += f_pad * MAX_FAN
    return blocks, bases


def shard_geometry(draws, vertex_shader, vs_uniform, config: RenderConfig, plan: ShardPlan, dp: int):
    """PyTorch's geometry of face shard ``dp`` of every draw →
    (TriangleBuffer, the draws' [lo, hi) slot ranges in it, faces clipped).
    Orders are the single frame's order of the padded draws
    (:func:`shard_blocks`)."""
    w, h = config.width, config.height
    bufs, clipped = [], 0
    for d, (block, base) in enumerate(zip(*shard_blocks(draws, plan, dp))):
        buf, stats = geometry_process(
            block, vertex_shader, vs_uniform, w, h, clip_cap=config.clip_cap, ps_index=d,
            order_base=base, cull=config.cull_backfaces,
        )
        clipped = clipped + stats["num_clipped"]
        bufs.append(buf)
    ranges, lo = [], 0
    for b in bufs:
        ranges.append((lo, lo + b.num_slots))
        lo += b.num_slots
    return TriangleBuffer.concat(bufs), ranges, clipped


def slab_path(config: RenderConfig, pixel_shader, ps_uniform, n_dp: int) -> str:
    """How a rank's slab is rendered: "stream", "fused" (K1 on the gathered
    records) or "gather" (K4 on the gathered records, or the portable
    raster on the gathered TriangleBuffer)."""
    comm = config.comm_mode or "all_gather"
    if comm not in COMM_MODES:
        raise ValueError(f"comm_mode {comm!r}: None, 'all_gather' or 'stream'")
    if config.backend not in ("kernels", "portable"):
        raise ValueError(f"unknown backend {config.backend!r}: 'kernels' or 'portable'")
    if comm == "stream" and n_dp > 1:
        return "stream"
    if (config.backend == "kernels" and config.fused_shade and hasattr(pixel_shader, "fused_kind")
            and fused_path_ok(pixel_shader, ps_uniform)):
        return "fused"
    return "gather"


@dataclasses.dataclass(frozen=True)
class ShardSetup:
    """A face shard's set-up before the ps boundary quirk.

    The kernels' (:func:`setup_shard_kernels`): its records and bbox words,
    the quirk's launch (``geometry.ShardQuirk``). PyTorch's
    (:func:`setup_shard_plain`, the portable backend's too): its
    TriangleBuffer and the draws' slot ranges. ``totals``: what the quirk
    reduces over the dp shards, None without the quirk: each draw's valid
    slots (D,) int32, summed, and (the kernels') its least key (D,) int64
    with the top bit flipped, so that a signed maximum orders the keys as
    their unsigned maximum does, a shard with no valid slot of the draw
    holding the least value, or (PyTorch's) its least order (D,) int32, by
    their minimum."""

    dp: int
    m: int  # the shard's slots
    n_ctx: int
    totals: tuple | None
    recs: torch.Tensor | None = None
    bbox: torch.Tensor | None = None
    quirk: object = None
    tri: TriangleBuffer | None = None
    ranges: list | None = None

    @property
    def keys_max(self) -> bool:
        """Whether ``totals[1]`` reduces by its maximum (else its minimum)."""
        return self.tri is None


def quirk_on(draws, config: RenderConfig) -> bool:
    return config.replicate_ps_boundary_quirk and len(draws) > 1


def setup_shard(draws, vertex_shader, vs_uniform, config: RenderConfig, plan: ShardPlan, dp: int) -> ShardSetup:
    """Shard ``dp``'s set-up: the triangle set-up kernels on CUDA tensors
    with the kernels backend, else PyTorch's geometry."""
    if config.backend == "kernels" and next(iter(draws[0].values())).device.type == "cuda":
        return setup_shard_kernels(draws, vertex_shader, vs_uniform, config, plan, dp)
    return setup_shard_plain(draws, vertex_shader, vs_uniform, config, plan, dp)


def setup_shard_kernels(draws, vertex_shader, vs_uniform, config: RenderConfig, plan: ShardPlan, dp: int):
    """The triangle set-up kernels in their shard mode on shard ``dp``'s
    blocks (``geometry.packed_geometry(shard=)``): its records and bbox
    words, the quirk's counts and keys accumulated."""
    blocks, bases = shard_blocks(draws, plan, dp)
    recs, bbox, m, c, _, later = packed_geometry(
        blocks, vertex_shader, vs_uniform, config.width, config.height, clip_cap=config.clip_cap,
        cull=config.cull_backfaces, quirk=quirk_on(draws, config), shard=(dp, bases))
    totals = None
    if later is not None:
        counts, keys = later.totals()
        totals = (counts, keys ^ I64_TOP)
    return ShardSetup(dp, m, c, totals, recs=recs, bbox=bbox, quirk=later)


def setup_shard_plain(draws, vertex_shader, vs_uniform, config: RenderConfig, plan: ShardPlan, dp: int):
    """PyTorch's geometry of shard ``dp`` (:func:`shard_geometry`) and the
    quirk's partials (``render.ps_quirk_partials``)."""
    tri, ranges, _ = shard_geometry(draws, vertex_shader, vs_uniform, config, plan, dp)
    totals = ps_quirk_partials(tri, ranges) if quirk_on(draws, config) else None
    return ShardSetup(dp, tri.num_slots, tri.num_channels, totals, tri=tri, ranges=ranges)


def reduce_quirk(setups) -> tuple | None:
    """Every shard's quirk totals reduced on the device (the all-reduce of
    a grid in one process) → (counts, keys), or None without the quirk."""
    if setups[0].totals is None:
        return None
    counts = torch.stack([s.totals[0] for s in setups]).sum(0).to(torch.int32)
    keys = torch.stack([s.totals[1] for s in setups])
    return counts, keys.amax(0) if setups[0].keys_max else keys.amin(0)


def finish_shard(s: ShardSetup, totals):
    """The shard after the quirk from every shard's ``totals`` (None: no
    quirk). The kernels': (records, bbox) with ``kernels.tri_quirk``
    launched. PyTorch's: its TriangleBuffer."""
    if s.tri is None:
        if totals is not None:
            counts, keys = s.quirk.totals()
            if counts.data_ptr() != totals[0].data_ptr():
                counts.copy_(totals[0])
            torch.bitwise_xor(totals[1], I64_TOP, out=keys)
            s.quirk.launch(s.recs)
        return s.recs, s.bbox
    return s.tri if totals is None else apply_ps_quirk_totals(s.tri, s.ranges, *totals)


def pack_shard(tri: TriangleBuffer, config: RenderConfig, dp: int):
    """The packed rows of shard ``dp`` (``raster.pack_binned``), its slot
    ids made global: shard d's columns follow the d shards before it."""
    ti, tf = pack_binned(tri, config.width, config.height)
    ti[SLOT] += dp * ti.shape[1]
    return ti, tf


def shard_records(s: ShardSetup, totals, config: RenderConfig):
    """The kernels backend's (records (m_pad, rec) int32, bbox (2, m_pad)
    int32) of shard ``s`` after the quirk: the set-up kernels', or
    ``raster.slot_records`` of :func:`pack_shard` (their plain version)."""
    done = finish_shard(s, totals)
    if s.tri is None:
        return done
    ti, tf = pack_shard(done, config, s.dp)
    return raster.slot_records(ti, tf), ti[MINXY:MAXXY + 1]


def bin_slab(recs, bbox, n_slots: int, n_ctx: int, config: RenderConfig, plan: ShardPlan, lin: int, **kw):
    """The records binned for slab ``lin``; the padding pairs point at the
    last record, an empty-bbox padding slot of the last shard."""
    return raster.bin_packed(recs, bbox, n_slots, n_ctx, config.width, config.height, config.tile,
                             origin=(lin * plan.slab, 0), size=(plan.slab, config.width),
                             m_dummy=recs.shape[0] - 1, **kw)


def fused_slab(recs, bbox, n_slots: int, n_ctx: int, pixel_shader, ps_uniform, config: RenderConfig,
               plan: ShardPlan, lin: int):
    """Slab ``lin`` through K1 from the gathered records and bbox words of
    every shard → (frame (slab, W, 4) u8, depth (slab, W) f32)."""
    prep = bin_slab(recs, bbox, n_slots, n_ctx, config, plan, lin, **bin_settings(config))
    frame, depth, _ = render_fused_prepared(prep, pixel_shader, ps_uniform, config)
    return frame, depth


def gather_slab(recs, bbox, n_slots: int, n_ctx: int, codec, pixel_shader, ps_uniform, config: RenderConfig,
                plan: ShardPlan, lin: int):
    """Slab ``lin`` from the gathered records (the JAX package's route:
    K4 without varyings, then ``shade_deferred``): the binning with K4's
    settings (the tile alone), K4, the winners' varyings from their
    records (``shade.interp_records``) and the pixel shader."""
    prep = bin_slab(recs, bbox, n_slots, n_ctx, config, plan, lin)
    depth, winner, _, _ = raster.raster_planes(prep, interp=False)
    winner, depth = winner[:plan.slab, :config.width], depth[:plan.slab, :config.width]
    ctx, ps = interp_records(recs, winner, n_ctx, origin=prep.origin)
    frame = shade_from_planes(ctx, ps, winner, pixel_shader, ps_uniform, codec, background=config.background,
                              vectorized=config.shade_vectorized)
    return frame, depth


def gather_slab_portable(tri: TriangleBuffer, codec, pixel_shader, ps_uniform, config: RenderConfig,
                         plan: ShardPlan, lin: int):
    """Slab ``lin`` from the gathered TriangleBuffer on the portable
    backend: ``rasterize_portable`` with an origin, then ``shade_deferred``
    at that origin."""
    w, h, slab = config.width, config.height, plan.slab
    origin = (lin * slab, 0)
    winner, depth = rasterize_portable(tri, w, slab, origin=origin, full_size=(h, w))
    frame = shade_deferred(tri, winner, pixel_shader, ps_uniform, codec,
                           background=config.background, origin=origin, vectorized=config.shade_vectorized,
                           launch=False)
    return frame, depth


@dataclasses.dataclass(frozen=True)
class StreamPlanes:
    """A slab's merged raster in the stream mode: the accumulator every
    round merges into in place (the JAX package's ``depth``, ``worder``,
    ``winner``, ``psx``, ``ctxp``; the order plane int32, as ``worder`` and
    the records' ORDER words)."""

    depth: torch.Tensor  # (slab, W) f32
    order: torch.Tensor  # (slab, W) int32, ORDER_NONE where none won
    winner: torch.Tensor  # (slab, W) int32 global slot id, -1 where none won
    ps: torch.Tensor  # (slab, W) int32
    ctx: torch.Tensor  # (C, slab, W) f32

    def planes(self):
        return self.depth, self.order, self.winner, self.ps, self.ctx


def stream_start(n_ctx: int, config: RenderConfig, plan: ShardPlan, device, fill: bool = True) -> StreamPlanes:
    """A slab's accumulator: the JAX package's start (depth 0, ORDER_NONE,
    winner -1, ps 0, ctx 0), or with ``fill=False`` unwritten planes for a
    first round that writes them all (:func:`stream_merge_plain`'s
    ``first``)."""
    shape = (plan.slab, config.width)
    planes = ((shape, torch.float32, 0.0), (shape, torch.int32, ORDER_NONE), (shape, torch.int32, -1),
              (shape, torch.int32, 0), ((n_ctx,) + shape, torch.float32, 0.0))
    return StreamPlanes(*(torch.full(s, v, dtype=dt, device=device) if fill else
                          torch.empty(s, dtype=dt, device=device) for s, dt, v in planes))


def stream_merge_plain(acc: StreamPlanes, depth, winner, ps, ctx, orders, slot0: int, first: bool = False) -> None:
    """Plain version of ``stream_merge_kernel`` (csrc/stream_merge.cu): a
    round's planes merged into ``acc`` in place by (rhw, order), as the JAX
    package merges a round (sharding.py:224-245). The planes may be K4's
    padded ones (cropped here to the accumulator's shape); ``winner`` holds
    global slot ids, and a winner's order is ``orders[winner - slot0]`` (the
    held shard's ORDER words), ORDER_NONE where winner < 0. ``first``: every
    pixel written, as the merge against :func:`stream_start`'s fills gives
    for K4's planes (0.0, -1, 0 and 0 where no pair won)."""
    h, w = acc.depth.shape
    depth, winner, ps, ctx = depth[:h, :w], winner[:h, :w], ps[:h, :w], ctx[:, :h, :w]
    local = torch.clamp(winner - slot0, 0, orders.shape[0] - 1).long()
    order = torch.where(winner >= 0, orders[local], ORDER_NONE)
    if first:
        for dst, src in zip(acc.planes(), (depth, order, winner, ps, ctx)):
            dst.copy_(src)
        return
    better = (depth > acc.depth) | ((depth >= acc.depth) & (order > acc.order))
    for dst, src in zip(acc.planes(), (depth, order, winner, ps, ctx)):
        torch.where(better, src, dst, out=dst)


def stream_round(acc: StreamPlanes | None, recs, bbox, m: int, n_ctx: int, owner: int, config: RenderConfig,
                 plan: ShardPlan, lin: int) -> StreamPlanes:
    """Bin, rasterize and interpolate shard ``owner``'s records (the shard
    this rank holds in this round) on slab ``lin`` (K4 with varyings, its
    padded planes), and merge them into ``acc`` in place (None: the first
    round, which writes a new accumulator whole) → the accumulator. The
    winners are the records' SLOT words, already global; their orders are
    the ORDER words. CUDA tensors launch ``kernels.stream_merge``, CPU
    tensors run :func:`stream_merge_plain`."""
    prep = bin_slab(recs, bbox, m, n_ctx, config, plan, lin)
    depth, winner, ps, ctx = raster.raster_planes(prep, interp=True)
    first = acc is None
    if first:
        acc = stream_start(n_ctx, config, plan, recs.device, fill=False)
    slot0 = owner * recs.shape[0]
    if recs.device.type == "cpu":
        stream_merge_plain(acc, depth, winner, ps, ctx, recs[:, ORDER], slot0, first)
    else:
        from f_renderer_tpu_torch import kernels

        kernels.stream_merge(depth, winner, ps, ctx, recs, acc.planes(), slot0=slot0, first=first)
    return acc


def stream_round_portable(acc: StreamPlanes, tri: TriangleBuffer, owner: int, config: RenderConfig,
                          plan: ShardPlan, lin: int) -> StreamPlanes:
    """:func:`stream_round` on the portable backend, from shard ``owner``'s
    TriangleBuffer (its winners become global slot ids, ``owner · m`` on),
    merged by :func:`stream_merge_plain` into ``acc`` (:func:`stream_start`'s)."""
    w, h, slab = config.width, config.height, plan.slab
    origin = (lin * slab, 0)
    win, d = rasterize_portable(tri, w, slab, origin=origin, full_size=(h, w))
    ctx, ps = interpolate_context(tri, win, w, slab, origin=origin)
    slot0 = owner * tri.num_slots
    stream_merge_plain(acc, d, torch.where(win >= 0, win + slot0, -1), ps, ctx, tri.order, slot0)
    return acc


def stream_shade(acc: StreamPlanes, codec, pixel_shader, ps_uniform, config: RenderConfig):
    """The pixel shader once on the merged planes → (frame, depth)."""
    frame = shade_from_planes(acc.ctx, acc.ps, acc.winner, pixel_shader, ps_uniform, codec,
                              background=config.background, vectorized=config.shade_vectorized,
                              launch=config.backend == "kernels")
    return frame, acc.depth


# ---------------------------------------------------------------------------
# Collectives, each a small function between the stages
# ---------------------------------------------------------------------------


def _as_rows(tri: TriangleBuffer) -> torch.Tensor:
    """Every field of a TriangleBuffer as int32 rows over its slots (floats
    by their bits, bools as 0 / 1): one tensor for one collective."""
    rows = []
    for f in dataclasses.fields(TriangleBuffer):
        t = getattr(tri, f.name)
        t = t.reshape(-1, t.shape[-1])
        rows.append(t.view(torch.int32) if t.dtype == torch.float32 else t.to(torch.int32))
    return torch.cat(rows)


def _from_rows(rows: torch.Tensor, like: TriangleBuffer) -> TriangleBuffer:
    out, r, m = {}, 0, rows.shape[-1]
    for f in dataclasses.fields(TriangleBuffer):
        t = getattr(like, f.name)
        n = t.numel() // t.shape[-1]
        block = rows[r:r + n]
        r += n
        if t.dtype == torch.float32:
            block = block.contiguous().view(torch.float32)
        else:
            block = block.to(t.dtype)
        out[f.name] = block.reshape(*t.shape[:-1], m)
    return TriangleBuffer(**out)


def all_reduce_quirk(s: ShardSetup, group):
    """The quirk's totals of shard ``s`` reduced in place over the dp group
    (on every rank, in every frame: never inside a conditional node, whose
    body some ranks would skip) → the totals: counts summed, the keys by
    their maximum (the kernels') or the least orders by their minimum."""
    counts, keys = s.totals
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(keys, op=dist.ReduceOp.MAX if s.keys_max else dist.ReduceOp.MIN, group=group)
    return s.totals


def all_gather_slots(t: torch.Tensor, group) -> torch.Tensor:
    """Every dp shard's ``t`` joined along the last (slot) axis, in shard order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def all_gather_records(recs: torch.Tensor, group) -> torch.Tensor:
    """Every dp shard's records joined along their first (slot) axis, in
    shard order: the gathered records' index is their SLOT word."""
    out = torch.empty((dist.get_world_size(group) * recs.shape[0],) + tuple(recs.shape[1:]), dtype=recs.dtype,
                      device=recs.device)
    dist.all_gather_into_tensor(out, recs.contiguous(), group=group)
    return out


def all_gather_triangles(tri: TriangleBuffer, group) -> TriangleBuffer:
    return _from_rows(all_gather_slots(_as_rows(tri), group), tri)


def ring_pass(tensors, group) -> list:
    """Send the tensors held to the next dp rank, receive the previous
    one's (of the same shapes)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt, prev = dist.get_global_rank(group, (me + 1) % n), dist.get_global_rank(group, (me - 1) % n)
    got = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, g, prev, group) for g in got]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def gather_slabs(mesh, frame: torch.Tensor, depth: torch.Tensor):
    """Every rank's slab joined into the whole frame, on every rank → (frame
    (H, W, 4) u8, depth (H, W) f32): the counterpart of reading the JAX
    package's row-sharded global array."""
    order = mesh.mesh.flatten().tolist()  # global ranks in slab order
    out = []
    for t in (frame, depth):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        out.append(torch.cat([parts[r] for r in order]))
    return tuple(out)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def render_frame_sharded(
    draws: Sequence,
    vertex_shader: Callable,
    vs_uniform,
    pixel_shader: Callable,
    ps_uniform,
    config: RenderConfig,
    mesh,
):
    """This rank's row slab of the frame → (frame (slab, W, 4) uint8, depth
    (slab, W) f32); :func:`gather_slabs` joins them. Every rank passes the
    whole draws, on its device. ``config.height`` must divide by the ranks."""
    n_dp, n_sp = mesh.shape
    dp, sp = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    group = mesh.get_group("dp")
    plan = shard_plan(draws, config, n_dp, n_sp)
    lin = dp * n_sp + sp
    path = slab_path(config, pixel_shader, ps_uniform, n_dp)
    s = setup_shard(draws, vertex_shader, vs_uniform, config, plan, dp)
    totals = None if s.totals is None else all_reduce_quirk(s, group)
    codec = None if path == "fused" else context_codec(vertex_shader, vs_uniform, draws[0])
    if config.backend != "kernels":
        tri = finish_shard(s, totals)
        if path == "gather":
            return gather_slab_portable(all_gather_triangles(tri, group), codec, pixel_shader, ps_uniform, config,
                                        plan, lin)
        acc = stream_start(tri.num_channels, config, plan, tri.spi.device)
        for r in range(n_dp):
            acc = stream_round_portable(acc, tri, (dp - r) % n_dp, config, plan, lin)
            if r + 1 < n_dp:
                tri = _from_rows(ring_pass([_as_rows(tri)], group)[0], tri)
        return stream_shade(acc, codec, pixel_shader, ps_uniform, config)
    recs, bbox = shard_records(s, totals, config)
    if path != "stream":
        slab = fused_slab if path == "fused" else functools.partial(gather_slab, codec=codec)
        return slab(all_gather_records(recs, group), all_gather_slots(bbox, group), n_dp * s.m, s.n_ctx,
                    pixel_shader=pixel_shader, ps_uniform=ps_uniform, config=config, plan=plan, lin=lin)
    acc = None
    for r in range(n_dp):
        acc = stream_round(acc, recs, bbox, s.m, s.n_ctx, (dp - r) % n_dp, config, plan, lin)
        if r + 1 < n_dp:
            recs, bbox = ring_pass([recs, bbox], group)
    return stream_shade(acc, codec, pixel_shader, ps_uniform, config)


def render_frame_grid(
    draws: Sequence,
    vertex_shader: Callable,
    vs_uniform,
    pixel_shader: Callable,
    ps_uniform,
    config: RenderConfig,
    n_dp: int,
    n_sp: int,
):
    """Every rank's stages of an (n_dp, n_sp) grid run in this process, on
    the draws' device, with ``torch.cat`` in place of the all-gather, sums
    and maxima (minima) in place of the all-reduce, and each round's shard
    picked directly in place of the ring → the joined (frame (H, W, 4) u8,
    depth (H, W) f32), which :func:`render_frame_sharded` must give as well."""
    plan = shard_plan(draws, config, n_dp, n_sp)
    path = slab_path(config, pixel_shader, ps_uniform, n_dp)
    codec = None if path == "fused" else context_codec(vertex_shader, vs_uniform, draws[0])
    setups = [setup_shard(draws, vertex_shader, vs_uniform, config, plan, dp) for dp in range(n_dp)]
    totals = reduce_quirk(setups)
    m, n_ctx = setups[0].m, setups[0].n_ctx
    lins = [(dp, dp * n_sp + sp) for dp in range(n_dp) for sp in range(n_sp)]
    if config.backend != "kernels":
        tris = [finish_shard(s, totals) for s in setups]
        if path == "gather":
            gathered = TriangleBuffer.concat(tris)
            slabs = [gather_slab_portable(gathered, codec, pixel_shader, ps_uniform, config, plan, lin)
                     for _, lin in lins]
        else:
            slabs = []
            for dp, lin in lins:
                acc = stream_start(n_ctx, config, plan, tris[0].spi.device)
                for r in range(n_dp):
                    owner = (dp - r) % n_dp
                    acc = stream_round_portable(acc, tris[owner], owner, config, plan, lin)
                slabs.append(stream_shade(acc, codec, pixel_shader, ps_uniform, config))
    else:
        shards = [shard_records(s, totals, config) for s in setups]
        if path != "stream":
            recs = torch.cat([r for r, _ in shards])
            bbox = torch.cat([b for _, b in shards], dim=-1)
            slab = fused_slab if path == "fused" else functools.partial(gather_slab, codec=codec)
            slabs = [slab(recs, bbox, n_dp * m, n_ctx, pixel_shader=pixel_shader, ps_uniform=ps_uniform,
                          config=config, plan=plan, lin=lin) for _, lin in lins]
        else:
            slabs = []
            for dp, lin in lins:
                acc = None
                for r in range(n_dp):
                    owner = (dp - r) % n_dp
                    acc = stream_round(acc, *shards[owner], m, n_ctx, owner, config, plan, lin)
                slabs.append(stream_shade(acc, codec, pixel_shader, ps_uniform, config))
    return torch.cat([f for f, _ in slabs]), torch.cat([d for _, d in slabs])
