"""Multi-device rendering on ``torch.distributed``.

Port of ``f_renderer_tpu/parallel/sharding.py``. The ranks form a (dp, sp)
process grid (:func:`make_render_mesh`, a ``DeviceMesh``):

- ``dp`` shards the faces. Every rank is handed the whole draws and runs the
  geometry of its contiguous block of faces, padded with degenerate faces
  to a multiple of dp; submission order survives through per-shard order
  offsets, so the (rhw, order) merge sees the single frame's orders. The
  ps-boundary quirk reduces its per-draw counts and minimum orders over dp.
- ``sp`` cuts the frame into row slabs: rank (dp, sp) renders rows
  ``[lin · slab, (lin + 1) · slab)``, ``lin = dp · n_sp + sp``, through the
  raster kernels with an origin. Slabs are disjoint, so no merge of frames
  is needed.

How the triangles reach a slab (``RenderConfig.comm_mode``):

- ``None`` / ``"all_gather"``: the fused path packs its local slots
  (``raster.pack_binned``), offsets their slot ids by ``dp · m_pad_local``,
  all-gathers the packed arrays over dp and bins them for its slab
  (``bin_rows(origin=, size=, m_dummy=)``: the rows' records, then
  ``bin_packed``), then K1. Other shaders, and the
  portable backend, all-gather the TriangleBuffer, then K4 (or
  ``rasterize_portable``) with an origin and ``shade_deferred(origin=)``;
- ``"stream"`` with dp > 1: the face shards travel round a dp ring of
  send / receive pairs, n_dp rounds; each round rasterizes and interpolates
  the shard it holds (K4 with an origin, or the portable raster and
  ``interpolate_context``), the rounds merge by (rhw, order), and the pixel
  shader runs once on the merged planes.

The step is written as stage functions of (rank coordinates, inputs), with
each collective one small function between them, so that
:func:`render_frame_grid` can run every rank's stages of a grid in one
process, ``torch.cat`` standing in for the all-gather and a walk over the
shards for the ring; :func:`render_frame_sharded` runs the real
collectives. Both are bit-equal to the single-device frame as long as no
shard drops a face past its ``clip_cap`` (each shard keeps its own cap, as
in the JAX package).

A slab shorter than the bin tile keeps a tile height the kernels take: the
prep rasterizes ``cdiv(slab, th) · th`` rows and crops (``raster.bin_packed``),
where the JAX package shrinks the tile to ``min(th, slab)``. Both are exact.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from f_renderer_tpu_torch.device import resolve_device
from f_renderer_tpu_torch.pipeline import raster
from f_renderer_tpu_torch.pipeline.fused import fused_path_ok, render_fused_prepared
from f_renderer_tpu_torch.pipeline.geometry import MAX_FAN, geometry_process
from f_renderer_tpu_torch.pipeline.fused import bin_settings
from f_renderer_tpu_torch.pipeline.raster import ORDER_NONE, SLOT, bin_rows, pack_binned
from f_renderer_tpu_torch.pipeline.raster_portable import rasterize_portable
from f_renderer_tpu_torch.pipeline.render import (
    RenderConfig,
    apply_ps_quirk_totals,
    context_codec,
    portable_shader,
    ps_quirk_partials,
)
from f_renderer_tpu_torch.pipeline.shade import interpolate_context, shade_deferred, shade_from_planes
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer

COMM_MODES = ("all_gather", "stream")


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


def shard_geometry(draws, vertex_shader, vs_uniform, config: RenderConfig, plan: ShardPlan, dp: int):
    """Geometry of face shard ``dp`` of every draw → (TriangleBuffer, the
    draws' [lo, hi) slot ranges in it, faces clipped). Orders are the single
    frame's order of the padded draws: ``base_d + dp · f_local · MAX_FAN``,
    ``base_d`` the padded faces of the draws before."""
    w, h = config.width, config.height
    bufs, base, clipped = [], 0, 0
    for d, (vs_inputs, f_pad) in enumerate(zip(draws, plan.faces)):
        f_local = f_pad // plan.n_dp
        block = {k: v[dp * f_local:(dp + 1) * f_local] for k, v in pad_faces(vs_inputs, f_pad).items()}
        buf, stats = geometry_process(
            block, vertex_shader, vs_uniform, w, h, clip_cap=config.clip_cap, ps_index=d,
            order_base=base + dp * f_local * MAX_FAN, cull=config.cull_backfaces,
        )
        base += f_pad * MAX_FAN
        clipped = clipped + stats["num_clipped"]
        bufs.append(buf)
    ranges, lo = [], 0
    for b in bufs:
        ranges.append((lo, lo + b.num_slots))
        lo += b.num_slots
    return TriangleBuffer.concat(bufs), ranges, clipped


def slab_path(config: RenderConfig, pixel_shader, ps_uniform, n_dp: int) -> str:
    """How a rank's slab is rendered: "stream", "fused" (K1 on gathered
    packed arrays) or "gather" (K4 or the portable raster on the gathered
    TriangleBuffer)."""
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


def pack_shard(tri: TriangleBuffer, config: RenderConfig, dp: int):
    """The fused path's packed arrays of shard ``dp``, its slot ids made
    global: shard d's columns follow the d shards before it."""
    ti, tf = pack_binned(tri, config.width, config.height)
    ti[SLOT] += dp * ti.shape[1]
    return ti, tf


def fused_slab(ti, tf, n_slots: int, n_ctx: int, pixel_shader, ps_uniform, config: RenderConfig,
               plan: ShardPlan, lin: int):
    """Slab ``lin`` through K1 from the gathered packed arrays of every
    shard → (frame (slab, W, 4) u8, depth (slab, W) f32). The last column is
    an empty-bbox padding slot of the last shard: the bin dummy. The rows
    are turned into records first (``raster.bin_rows``)."""
    prep = bin_rows(ti, tf, n_slots, n_ctx, config.width, config.height, config.tile, **bin_settings(config),
                    origin=(lin * plan.slab, 0), size=(plan.slab, config.width), m_dummy=ti.shape[1] - 1)
    frame, depth, _ = render_fused_prepared(prep, pixel_shader, ps_uniform, config)
    return frame, depth


def gather_slab(tri: TriangleBuffer, codec, pixel_shader, ps_uniform, config: RenderConfig,
                plan: ShardPlan, lin: int):
    """Slab ``lin`` from the gathered TriangleBuffer: K4 with an origin (or
    ``rasterize_portable``), then ``shade_deferred`` at that origin."""
    w, h, slab = config.width, config.height, plan.slab
    origin = (lin * slab, 0)
    if config.backend == "kernels":
        winner, depth = raster.rasterize(tri, w, slab, config.tile, origin=origin, full_size=(h, w))
    else:
        winner, depth = rasterize_portable(tri, w, slab, origin=origin, full_size=(h, w))
        pixel_shader = portable_shader(pixel_shader)
    frame = shade_deferred(tri, winner, pixel_shader, ps_uniform, codec, background=config.background,
                           origin=origin, vectorized=config.shade_vectorized)
    return frame, depth


@dataclasses.dataclass(frozen=True)
class StreamPlanes:
    """A slab's merged raster in the stream mode."""

    depth: torch.Tensor  # (slab, W) f32
    order: torch.Tensor  # (slab, W) int64, ORDER_NONE where none won
    winner: torch.Tensor  # (slab, W) int32 global slot id, -1 where none won
    ps: torch.Tensor  # (slab, W) int32
    ctx: torch.Tensor  # (C, slab, W) f32


def stream_start(n_ctx: int, config: RenderConfig, plan: ShardPlan, device) -> StreamPlanes:
    shape = (plan.slab, config.width)
    return StreamPlanes(
        depth=torch.zeros(shape, device=device),
        order=torch.full(shape, ORDER_NONE, dtype=torch.int64, device=device),
        winner=torch.full(shape, -1, dtype=torch.int32, device=device),
        ps=torch.zeros(shape, dtype=torch.int32, device=device),
        ctx=torch.zeros((n_ctx,) + shape, device=device),
    )


def stream_round(acc: StreamPlanes, tri: TriangleBuffer, owner: int, config: RenderConfig,
                 plan: ShardPlan, lin: int) -> StreamPlanes:
    """Rasterize and interpolate shard ``owner`` (the one this rank holds in
    this round) on slab ``lin``, and merge it in by (rhw, order). Its
    winners become global slot ids, ``owner · m_local`` on."""
    w, h, slab = config.width, config.height, plan.slab
    origin = (lin * slab, 0)
    if config.backend == "kernels":
        ctx, ps, win, d = raster.rasterize_interp(tri, w, slab, config.tile, origin=origin, full_size=(h, w))
    else:
        win, d = rasterize_portable(tri, w, slab, origin=origin, full_size=(h, w))
        ctx, ps = interpolate_context(tri, win, w, slab, origin=origin)
    o = torch.where(win >= 0, tri.order[torch.clamp(win, min=0).long()].long(), ORDER_NONE)
    better = (d > acc.depth) | ((d >= acc.depth) & (o > acc.order))
    return StreamPlanes(
        depth=torch.where(better, d, acc.depth),
        order=torch.where(better, o, acc.order),
        winner=torch.where(better, torch.where(win >= 0, win + owner * tri.num_slots, -1), acc.winner),
        ps=torch.where(better, ps, acc.ps),
        ctx=torch.where(better, ctx, acc.ctx),
    )


def stream_shade(acc: StreamPlanes, codec, pixel_shader, ps_uniform, config: RenderConfig):
    """The pixel shader once on the merged planes → (frame, depth)."""
    if config.backend != "kernels":
        pixel_shader = portable_shader(pixel_shader)
    frame = shade_from_planes(acc.ctx, acc.ps, acc.winner, pixel_shader, ps_uniform, codec,
                              background=config.background, vectorized=config.shade_vectorized)
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


def all_reduce_quirk(counts, mins, group):
    """Per-draw counts summed, minimum orders reduced over the dp group."""
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(mins, op=dist.ReduceOp.MIN, group=group)
    return counts, mins


def all_gather_slots(t: torch.Tensor, group) -> torch.Tensor:
    """Every dp shard's ``t`` joined along the last (slot) axis, in shard order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def all_gather_triangles(tri: TriangleBuffer, group) -> TriangleBuffer:
    return _from_rows(all_gather_slots(_as_rows(tri), group), tri)


def ring_pass(tri: TriangleBuffer, group) -> TriangleBuffer:
    """Send the shard held to the next dp rank, receive the previous one's."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    rows = _as_rows(tri)
    got = torch.empty_like(rows)
    ops = [
        dist.P2POp(dist.isend, rows, dist.get_global_rank(group, (me + 1) % n), group),
        dist.P2POp(dist.irecv, got, dist.get_global_rank(group, (me - 1) % n), group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _from_rows(got, tri)


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
    tri, ranges, _ = shard_geometry(draws, vertex_shader, vs_uniform, config, plan, dp)
    if config.replicate_ps_boundary_quirk and len(ranges) > 1:
        counts, mins = all_reduce_quirk(*ps_quirk_partials(tri, ranges), group)
        tri = apply_ps_quirk_totals(tri, ranges, counts, mins)
    path = slab_path(config, pixel_shader, ps_uniform, n_dp)
    if path == "fused":
        ti, tf = pack_shard(tri, config, dp)
        return fused_slab(all_gather_slots(ti, group), all_gather_slots(tf, group), n_dp * tri.num_slots,
                          tri.num_channels, pixel_shader, ps_uniform, config, plan, lin)
    codec = context_codec(vertex_shader, vs_uniform, draws[0])
    if path == "gather":
        return gather_slab(all_gather_triangles(tri, group), codec, pixel_shader, ps_uniform, config, plan, lin)
    acc = stream_start(tri.num_channels, config, plan, tri.spi.device)
    for r in range(n_dp):
        acc = stream_round(acc, tri, (dp - r) % n_dp, config, plan, lin)
        if r + 1 < n_dp:
            tri = ring_pass(tri, group)
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
    and minima in place of the all-reduce, and each round's shard picked
    directly in place of the ring → the joined (frame (H, W, 4) u8, depth
    (H, W) f32), which :func:`render_frame_sharded` must give as well."""
    plan = shard_plan(draws, config, n_dp, n_sp)
    shards = [shard_geometry(draws, vertex_shader, vs_uniform, config, plan, dp) for dp in range(n_dp)]
    tris = [tri for tri, _, _ in shards]
    ranges = shards[0][1]
    if config.replicate_ps_boundary_quirk and len(ranges) > 1:
        partials = [ps_quirk_partials(tri, ranges) for tri in tris]
        counts = torch.stack([c for c, _ in partials]).sum(0).to(torch.int32)
        mins = torch.stack([m for _, m in partials]).amin(0)
        tris = [apply_ps_quirk_totals(tri, ranges, counts, mins) for tri in tris]
    path = slab_path(config, pixel_shader, ps_uniform, n_dp)
    codec = context_codec(vertex_shader, vs_uniform, draws[0])
    if path == "fused":
        packed = [pack_shard(tri, config, dp) for dp, tri in enumerate(tris)]
        ti, tf = (torch.cat([p[i] for p in packed], dim=-1) for i in (0, 1))
    elif path == "gather":
        gathered = TriangleBuffer.concat(tris)
    slabs = []
    for dp in range(n_dp):
        for sp in range(n_sp):
            lin = dp * n_sp + sp
            if path == "fused":
                slabs.append(fused_slab(ti, tf, n_dp * tris[0].num_slots, tris[0].num_channels, pixel_shader,
                                        ps_uniform, config, plan, lin))
            elif path == "gather":
                slabs.append(gather_slab(gathered, codec, pixel_shader, ps_uniform, config, plan, lin))
            else:
                acc = stream_start(tris[0].num_channels, config, plan, tris[0].spi.device)
                for r in range(n_dp):
                    owner = (dp - r) % n_dp
                    acc = stream_round(acc, tris[owner], owner, config, plan, lin)
                slabs.append(stream_shade(acc, codec, pixel_shader, ps_uniform, config))
    return torch.cat([f for f, _ in slabs]), torch.cat([d for _, d in slabs])
