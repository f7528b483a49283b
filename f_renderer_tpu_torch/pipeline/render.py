"""End-to-end frame rendering: geometry → raster → shade.

Port of ``f_renderer_tpu/pipeline/render.py``: geometry over all draws
builds one submission-ordered triangle list (phong.rs:314-387). Then, with
the default ``backend="kernels"`` (the JAX package's pallas backend), either
one fused kernel rasterizes and shades it (builtin ``fused_kind`` shaders),
or the raster kernel interpolates the varyings
(``raster.rasterize_interp``) and the pixel shader runs once over the frame
(``shade.shade_from_planes``). ``backend="portable"`` (the JAX package's jnp
backend) runs ``raster_portable.rasterize_portable`` + ``shade_deferred``
and launches no kernel. A "draw" is one mesh batch sharing a ps_index (the
reference's PLACE enum selecting a texture, phong.rs:34-38).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from f_renderer_tpu_torch.pipeline import raster
from f_renderer_tpu_torch.pipeline.fused import fused_path_ok, render_fused
from f_renderer_tpu_torch.pipeline.geometry import MAX_FAN, geometry_process
from f_renderer_tpu_torch.pipeline.raster import rasterize_interp
from f_renderer_tpu_torch.pipeline.raster_portable import rasterize_portable
from f_renderer_tpu_torch.pipeline.shade import shade_deferred, shade_from_planes
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.shaders.builtin import LIGHT_COLOR, LIGHT_POS, shade_plain

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
    valid, order = tri.valid, tri.order
    counts, mins = [], []
    for lo, hi in slot_ranges:
        v = valid[lo:hi]
        counts.append(v.sum().to(torch.int32))
        mins.append(torch.where(v, order[lo:hi], I32_MAX).amin())
    offsets = torch.cumsum(torch.stack(counts), 0).to(torch.int32)
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


def context_codec(vertex_shader: Callable, vs_uniform, draw) -> ContextCodec:
    """The varying layout the vertex shader emits, from one zero vertex of
    ``draw`` (the JAX package's make_context_codec)."""
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


def portable_shader(pixel_shader: Callable) -> Callable:
    """The pixel shader as the portable backend runs it: a builtin
    (``fused_kind``) samples its textures with the plain sampler, so the
    path launches no kernel; a custom shader runs as it is."""
    kind = getattr(pixel_shader, "fused_kind", None)
    if kind is None:
        return pixel_shader
    light_pos = getattr(pixel_shader, "light_pos", LIGHT_POS)
    light_color = getattr(pixel_shader, "light_color", LIGHT_COLOR)
    return lambda u, ctx, ps: shade_plain(kind, u, ctx, ps, light_pos=light_pos, light_color=light_color)


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
    raster kernel interpolates (render.py:248-267 of the JAX package).
    ``config.backend="portable"`` rasterizes with ``rasterize_portable`` and
    shades with ``shade_deferred`` (render.py:269-279 there), launching no
    kernel (:func:`portable_shader`).
    """
    tri, stats = build_triangles(draws, vertex_shader, vs_uniform, config)
    if config.backend != "kernels":
        winner, depth = rasterize(tri, config)
        codec = context_codec(vertex_shader, vs_uniform, draws[0])
        frame = shade_deferred(
            tri, winner, portable_shader(pixel_shader), ps_uniform, codec, background=config.background,
            vectorized=config.shade_vectorized,
        )
        return frame, depth, stats
    if (
        config.fused_shade
        and hasattr(pixel_shader, "fused_kind")
        and fused_path_ok(pixel_shader, ps_uniform)
    ):
        frame, depth, _ = render_fused(tri, pixel_shader, ps_uniform, config)
        return frame, depth, stats
    codec = context_codec(vertex_shader, vs_uniform, draws[0])
    ctx, ps_idx, winner, depth = rasterize_interp(tri, config.width, config.height, tile=config.tile)
    frame = shade_from_planes(
        ctx, ps_idx, winner, pixel_shader, ps_uniform, codec, background=config.background,
        vectorized=config.shade_vectorized,
    )
    return frame, depth, stats
