"""End-to-end frame rendering: geometry → raster → shade.

Port of ``f_renderer_tpu/pipeline/render.py``: geometry over all draws
builds one submission-ordered triangle list (phong.rs:314-387). Then, with
the default ``backend="kernels"`` (the JAX package's pallas backend), either
one fused kernel rasterizes and shades it (builtin ``fused_kind`` shaders),
or the raster kernel interpolates the varyings
(``raster.interp_planes``) and the pixel shader runs on the covered pixels,
compacted to a rung of ``shade.RUNGS`` (``shade.shade_from_planes``). ``backend="portable"`` (the JAX package's jnp
backend) runs ``raster_portable.rasterize_portable`` + ``shade_deferred``
and launches no kernel. A "draw" is one mesh batch sharing a ps_index (the
reference's PLACE enum selecting a texture, phong.rs:34-38).
"""

from __future__ import annotations

import dataclasses
from time import perf_counter_ns
from typing import Callable, Sequence

import torch

from f_renderer_tpu_torch.pipeline import raster
from f_renderer_tpu_torch.pipeline.fused import fused_path_ok, prep_packed, render_fused_prepared
from f_renderer_tpu_torch.pipeline.geometry import MAX_FAN, geometry_process, packed_geometry
from f_renderer_tpu_torch.pipeline.raster import interp_planes
from f_renderer_tpu_torch.pipeline.raster_portable import rasterize_portable
from f_renderer_tpu_torch.pipeline.shade import shade_deferred, shade_from_planes
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.shaders.builtin import vertex_layout
from f_renderer_tpu_torch.utils import metrics

I32_MAX = 2147483647


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int
    height: int
    background: tuple = (0, 0, 0, 255)
    clip_cap: int = 256
    # Bin tile (rows, 128). None picks (32, 128), or (128, 128) for scenes of
    # at most 2048 slots; an explicit tile is used as given.
    tile: tuple | None = None
    replicate_ps_boundary_quirk: bool = True
    # Drop back-facing triangles instead of the reference's winding repair
    # (renderer.rs:309-312). Off by default for parity.
    cull_backfaces: bool = False
    # Tiles of at least 64 rows above ``tile_auto_threshold`` slots.
    tile_auto: bool = True
    tile_auto_threshold: int = 300_000
    # Per-tile pair-expansion cap (None = size heuristic). Small values force
    # the coarse-bin and spill ranges.
    bin_k: int | None = None
    # Builtin (fused_kind) shaders run in the fused kernel; False sends them
    # through rasterize_interp + shade_from_planes like custom shaders.
    fused_shade: bool = True
    # "kernels": the CUDA kernels on the card (their plain versions on the
    # CPU). "portable": rasterize_portable + shade_deferred, no kernel.
    backend: str = "kernels"
    # Call the pixel shader once on the frame; False calls it once per pixel
    # (scalar-style custom shaders that cannot broadcast).
    shade_vectorized: bool = True
    # Sharded frames (parallel/sharding.py): None or "all_gather" gathers the
    # triangle setup over the face shards; "stream" passes the shards round
    # a ring instead, merging each round's raster by (rhw, order).
    comm_mode: str | None = None


def apply_ps_boundary_quirk(tri: TriangleBuffer, slot_ranges) -> TriangleBuffer:
    """Reproduce the inclusive ``<=`` texture-range boundaries (phong.rs:364-370).

    The reference assigns triangle index i to draw d via chained
    ``prev_off < i <= off_d`` checks, so the first emitted triangle of each
    draw lands in the earliest draw whose cumulative offset equals its index
    — ``searchsorted(offsets, i, side='left')``. ``slot_ranges`` are the
    per-draw [lo, hi) slot spans of the concatenated buffer.
    """
    if len(slot_ranges) <= 1:
        return tri
    return apply_ps_quirk_totals(tri, slot_ranges, *ps_quirk_partials(tri, slot_ranges))


def ps_quirk_partials(tri: TriangleBuffer, slot_ranges):
    """Each draw's valid slots and least valid order among ``slot_ranges``
    → (counts (D,) int32, mins (D,) int32). Over face shards, the counts
    sum and the minima take the minimum (orders are global)."""
    valid, order = tri.valid, tri.order
    counts, mins = [], []
    for lo, hi in slot_ranges:
        v = valid[lo:hi]
        counts.append(v.sum().to(torch.int32))
        mins.append(torch.where(v, order[lo:hi], I32_MAX).amin())
    return torch.stack(counts), torch.stack(mins)


def apply_ps_quirk_totals(tri: TriangleBuffer, slot_ranges, counts, mins) -> TriangleBuffer:
    """The quirk from the whole frame's per-draw ``counts`` and ``mins``
    (:func:`ps_quirk_partials`): each draw's first triangle takes the
    earliest draw whose cumulative count equals its index."""
    valid, order = tri.valid, tri.order
    offsets = torch.cumsum(counts, 0).to(torch.int32)
    start = torch.cat([torch.zeros_like(offsets[:1]), offsets[:-1]])
    target = torch.searchsorted(offsets, start).to(torch.int32)
    segs = [
        torch.where(valid[lo:hi] & (order[lo:hi] == mins[d]), target[d], tri.ps_index[lo:hi])
        for d, (lo, hi) in enumerate(slot_ranges)
    ]
    return dataclasses.replace(tri, ps_index=torch.cat(segs))


def build_triangles(draws: Sequence, vertex_shader: Callable, vs_uniform, config: RenderConfig):
    """Geometry stage over all draws → one TriangleBuffer + stats."""
    # ps_index rides in the low 8 bits of a packed setup field (raster.PS_MASK).
    if len(draws) > 256:
        raise ValueError("at most 256 draws per frame")
    bufs, order_base, num_clipped = [], 0, 0
    for d, vs_inputs in enumerate(draws):
        buf, stats = geometry_process(
            vs_inputs,
            vertex_shader,
            vs_uniform,
            config.width,
            config.height,
            clip_cap=config.clip_cap,
            ps_index=d,
            order_base=order_base,
            cull=config.cull_backfaces,
        )
        order_base += next(iter(vs_inputs.values())).shape[0] * MAX_FAN
        num_clipped = num_clipped + stats["num_clipped"]
        bufs.append(buf)
    tri = TriangleBuffer.concat(bufs)
    if config.replicate_ps_boundary_quirk:
        ranges, lo = [], 0
        for b in bufs:
            ranges.append((lo, lo + b.num_slots))
            lo += b.num_slots
        tri = apply_ps_boundary_quirk(tri, ranges)
    return tri, {"num_clipped": num_clipped}


def build_packed(draws: Sequence, vertex_shader: Callable, vs_uniform, config: RenderConfig):
    """Geometry over all draws, packed → (recs (m_pad, rec) int32, bbox (2,
    m_pad) int32, slots m, varyings C, stats): the slot records
    (``raster.slot_records``) of the rows ``raster.pack_binned`` makes of
    :func:`build_triangles`' buffer, and their MINXY and MAXXY words, which
    ``raster.bin_packed`` bins. CUDA tensors launch the triangle set-up
    kernels (csrc/tri_setup.cu, ``geometry.packed_geometry``), which write
    them bit for bit; CPU tensors run their plain version,
    :func:`build_packed_plain`."""
    if len(draws) > 256:
        raise ValueError("at most 256 draws per frame")
    dev = next(iter(draws[0].values())).device
    if dev.type == "cpu":
        return build_packed_plain(draws, vertex_shader, vs_uniform, config)
    if dev.type != "cuda":
        raise ValueError(f"the triangle set-up runs on CUDA or (plain) CPU, not {dev}")
    quirk = config.replicate_ps_boundary_quirk and len(draws) > 1
    recs, bbox, m, c, num_clipped = packed_geometry(
        draws, vertex_shader, vs_uniform, config.width, config.height, clip_cap=config.clip_cap,
        cull=config.cull_backfaces, quirk=quirk)
    return recs, bbox, m, c, {"num_clipped": num_clipped}


def build_packed_plain(draws: Sequence, vertex_shader: Callable, vs_uniform, config: RenderConfig):
    """The plain version of :func:`build_packed`'s kernels, on the tensors'
    device: ``raster.pack_binned(build_triangles(...))``, its rows turned
    into records (``raster.slot_records``), and its bbox rows."""
    tri, stats = build_triangles(draws, vertex_shader, vs_uniform, config)
    ti, tf = raster.pack_binned(tri, config.width, config.height)
    bbox = ti[raster.MINXY:raster.MAXXY + 1].clone()
    return raster.slot_records(ti, tf), bbox, tri.num_slots, tri.num_channels, stats


def context_codec(vertex_shader: Callable, vs_uniform, draw) -> ContextCodec:
    """The varying layout the vertex shader emits on ``draw``: a builtin's
    (tagged ``fused_kind``) from its tag (``builtin.vertex_layout``), with no
    op on any device; any other shader's from one zero vertex of ``draw``
    (the JAX package's make_context_codec)."""
    layout = vertex_layout(vertex_shader, draw)
    if layout is not None:
        return ContextCodec(layout)
    example = {
        k: torch.zeros((1,) + tuple(v.shape[2:]), dtype=torch.float32, device=v.device)
        for k, v in draw.items()
    }
    _, ctx = vertex_shader(vs_uniform, example)
    return ContextCodec.of(ctx)


def rasterize(tri: TriangleBuffer, config: RenderConfig):
    """Per-pixel (winner (H, W) int32, depth (H, W) f32) by ``config.backend``."""
    if config.backend == "kernels":
        return raster.rasterize(tri, config.width, config.height, tile=config.tile)
    if config.backend == "portable":
        return rasterize_portable(tri, config.width, config.height)
    raise ValueError(f"unknown backend {config.backend!r}: 'kernels' or 'portable'")


def render_frame(
    draws: Sequence,
    vertex_shader: Callable,
    vs_uniform,
    pixel_shader: Callable,
    ps_uniform,
    config: RenderConfig,
):
    """Render one frame → (frame (H, W, 4) uint8, depth (H, W) f32, stats).

    ``draws``: a sequence of dicts of (F_d, 3, k) tensors. A pixel shader
    tagged ``fused_kind`` (the builtins) runs in the fused kernel when
    ``config.fused_shade`` is set and its texture stack fits
    (``fused_path_ok``); every other shader runs on the planes that the
    raster kernel interpolates (render.py:248-267 of the JAX package): a
    user's shader on their covered pixels, ``{key: (k, R, W)}`` planes of
    R rows of slots in raster order, R the smallest rung of
    ``shade.RUNGS`` (1/8 … 6/8 of the rows) that holds them, the padding
    slots' texture id -1, or past 6/8 the whole frame's (k, H, W) planes
    (``shade.shade_from_planes``); its colour at a pixel may depend on that
    pixel's context and the uniform only.
    ``config.backend="portable"`` rasterizes with ``rasterize_portable`` and
    shades with ``shade_deferred`` (render.py:269-279 there), launching no
    kernel (``launch=False``: a builtin shader through the plain sampler,
    the plain pack). The kernels backend bins the slot records of
    :func:`build_packed`.

    The kernels backend counts its path (``utils.metrics.count``): a fused
    frame ``render.fused_frames``; a planes frame ``render.planes_frames``,
    its C varyings ``render.planes_varyings``, the planes' bytes
    ``render.planes_bytes`` ((C + 3) · 4 a pixel: the varyings, texture id,
    winner and depth) and, where the pixel shader is
    user code (no ``fused_kind``), ``render.user_shader_frames``, and where
    the pack kernel packs its colour (``shade.shade_from_planes`` on the
    card, once a frame), ``render.pack_kernel_frames``. While
    tracing is on, a planes frame records the spans ``render.planes`` (K4
    and its planes) and ``render.shade`` (``shade_from_planes``: the pixel
    shader and the pack). A captured frame keeps the counts of its capture
    and counts them again on each replay (``compiled.FrameCache``).
    """
    if config.backend != "kernels":
        tri, stats = build_triangles(draws, vertex_shader, vs_uniform, config)
        winner, depth = rasterize(tri, config)
        codec = context_codec(vertex_shader, vs_uniform, draws[0])
        frame = shade_deferred(
            tri, winner, pixel_shader, ps_uniform, codec, background=config.background,
            vectorized=config.shade_vectorized, launch=False,
        )
        return frame, depth, stats
    recs, bbox, n_slots, n_ctx, stats = build_packed(draws, vertex_shader, vs_uniform, config)
    if (
        config.fused_shade
        and hasattr(pixel_shader, "fused_kind")
        and fused_path_ok(pixel_shader, ps_uniform)
    ):
        prep = prep_packed(recs, bbox, n_slots, n_ctx, config)
        frame, depth, _ = render_fused_prepared(prep, pixel_shader, ps_uniform, config)
        metrics.count("render.fused_frames", 1)
        return frame, depth, stats
    codec = context_codec(vertex_shader, vs_uniform, draws[0])
    # the bin settings of raster.rasterize_interp: the tile alone
    prep = raster.bin_packed(recs, bbox, n_slots, n_ctx, config.width, config.height, config.tile)
    rec = metrics.recorder
    if rec is not None:
        t0 = perf_counter_ns()
    planes = interp_planes(prep)
    if rec is not None:
        t1 = perf_counter_ns()
    ctx, ps_idx, winner, depth = planes
    frame = shade_from_planes(
        ctx, ps_idx, winner, pixel_shader, ps_uniform, codec, background=config.background,
        vectorized=config.shade_vectorized,
    )
    if rec is not None:
        rec.add("render.planes", t0, t1)
        rec.add("render.shade", t1, perf_counter_ns())
    metrics.count("render.planes_frames", 1)
    metrics.count("render.planes_varyings", ctx.shape[0])
    metrics.count("render.planes_bytes", sum(t.nbytes for t in planes))
    if not hasattr(pixel_shader, "fused_kind"):
        metrics.count("render.user_shader_frames", 1)
    return frame, depth, stats
