"""Deferred shading (reference: renderer.rs:343-381, run once per surviving
pixel instead of once per covered pixel).

Port of ``f_renderer_tpu/pipeline/shade.py:23-144``. Given each pixel's
winning triangle, gather its vertex attributes, recompute the barycentrics
at the pixel center, interpolate the varyings perspective-correct
(renderer.rs:368-378) and run the user pixel shader once over the whole
frame. The final u8 pack matches vec4_to_u8_array (renderer.rs:7-14);
background pixels keep the fill color.

The port's shader contract is planar: the pixel shader gets
``{key: (k, H, W)}`` channel planes and a (H, W) texture id, and returns
(4, H, W) rgba. Context planes are (C, H, W). With ``vectorized=False`` the
shader is called once per pixel instead (``{key: (k,)}``, a 0-d texture id,
returning (4,)), the JAX package's ``vmap(vmap(shade_one))`` form, for
scalar-style custom shaders that cannot broadcast.

A builtin pixel shader (tagged ``fused_kind``) is not called: on the card
one kernel shades the planes (``kernels.shade_planes``, csrc/shade_planes.cu:
the pixel shader, the sampler, the pack and the background, where XLA
fused them in the JAX package); on the CPU its plain version
:func:`shade_planes_plain` does. The builtins broadcast, so
``vectorized`` changes none of their frames.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from f_renderer_tpu_torch.device import constant
from f_renderer_tpu_torch.math.transforms import true_div
from f_renderer_tpu_torch.pipeline.fused import background_packed
from f_renderer_tpu_torch.pipeline.raster import NF_I, PS, PS_MASK
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.shaders.builtin import LIGHT_COLOR, LIGHT_POS, shade_plain, shading_inputs, varying_offsets
from f_renderer_tpu_torch.utils import metrics


def interpolate_context(tri: TriangleBuffer, winner, width: int, height: int, *, origin=(0, 0)):
    """Per-pixel perspective-correct varying interpolation.

    Returns ``(ctx (C, H, W) f32, ps_index (H, W) int32)`` for the winning
    triangle at each pixel (garbage where winner < 0: mask downstream).
    ``origin=(y0, x0)``: the full-frame coordinates of the top-left pixel.
    """
    wid = torch.clamp(winner, min=0).long()
    # the float rows of raster.pack_setup: S0X, S0Y, ..., S2Y, RHW0-2, the 3C varyings
    rows = [tri.spf[v, a] for v in range(3) for a in range(2)] + [tri.rhw[v] for v in range(3)] + list(tri.ctx)
    ctx = _interpolate(lambda j: rows[j][wid], tri.num_channels, width, height, origin, winner.device)
    return ctx, tri.ps_index[wid]


def interpolate_records(recs, winner, n_ctx: int, *, origin=(0, 0)):
    """:func:`interpolate_context` from slot records (``raster.slot_records``,
    the set-up kernels' output): ``recs`` (m, rec) int32, ``winner`` (H, W)
    int32 a record's index (record 0 where winner < 0, garbage to mask, as
    :func:`interpolate_context` reads slot 0) → ``(ctx (C, H, W) f32,
    ps_index (H, W) int32)``, bit-equal to :func:`interpolate_context` on the
    TriangleBuffer whose records these are: it reads the same words (the
    float rows from word NF_I, the PS word's ps_index bits) and does the
    same float32 operations. The plain version of ``kernels.interp_records``
    (csrc/interp_records.cu), on the tensors' device."""
    h, w = winner.shape
    wid = torch.clamp(winner, min=0).long()
    rows = recs[:, NF_I:NF_I + 9 + 3 * n_ctx].view(torch.float32)
    ctx = _interpolate(lambda j: rows[:, j][wid], n_ctx, w, h, origin, winner.device)
    return ctx, (recs[:, PS] & PS_MASK)[wid]


def interp_records(recs, winner, n_ctx: int, *, origin=(0, 0)):
    """The winners' varyings from their slot records: CUDA tensors launch
    ``kernels.interp_records`` (csrc/interp_records.cu), CPU tensors run its
    plain version :func:`interpolate_records`."""
    if recs.device.type == "cpu":
        return interpolate_records(recs, winner, n_ctx, origin=origin)
    from f_renderer_tpu_torch import kernels

    return kernels.interp_records(recs, winner, n_ctx=n_ctx, origin=origin)


def _interpolate(row, nc: int, width: int, height: int, origin, dev):
    """The interpolation of :func:`interpolate_context`: ``row(j)`` the
    winners' float row j (H, W) of ``raster.pack_setup``'s layout → ctx (C,
    H, W) f32."""
    y0, x0 = origin
    sfx = [row(2 * v) for v in range(3)]
    sfy = [row(2 * v + 1) for v in range(3)]
    rhw3 = [row(6 + v) for v in range(3)]
    px = (x0 + torch.arange(width, dtype=torch.float32, device=dev)[None, :]) + 0.5
    py = (y0 + torch.arange(height, dtype=torch.float32, device=dev)[:, None]) + 0.5
    sx = [sfx[v] - px for v in range(3)]
    sy = [sfy[v] - py for v in range(3)]

    def perp(i, j):
        return torch.abs(sx[i] * sy[j] - sy[i] * sx[j])

    a, b, c = perp(1, 2), perp(2, 0), perp(0, 1)
    inv_s = true_div(1.0, a + b + c)
    la, lb, lc = a * inv_s, b * inv_s, c * inv_s
    rhw = rhw3[0] * la + rhw3[1] * lb + rhw3[2] * lc
    w_corr = true_div(1.0, torch.where(rhw != 0.0, rhw, 1.0))  # renderer.rs:368
    coef = [rhw3[0] * la * w_corr, rhw3[1] * lb * w_corr, rhw3[2] * lc * w_corr]
    if not nc:
        return torch.zeros((0, height, width), device=dev)
    return torch.stack([row(9 + ch) * coef[0] + row(9 + nc + ch) * coef[1] + row(9 + 2 * nc + ch) * coef[2]
                        for ch in range(nc)])


def shade_from_planes(
    ctx,
    ps_idx,
    winner,
    pixel_shader: Callable,
    ps_uniform,
    codec: ContextCodec,
    *,
    background=(0, 0, 0, 255),
    vectorized: bool = True,
    launch: bool = True,
):
    """Shade from interpolated context planes (``raster.rasterize_interp``).

    ``ctx`` (C, H, W) f32, ``ps_idx``/``winner`` (H, W) int32. The pixel
    shader runs once on the whole frame (``vectorized``) or once per pixel
    (``torch.func.vmap`` over the flattened pixels); the background fills
    pixels where winner < 0 (:func:`pack_frame`). Returns (H, W, 4) uint8.
    A builtin pixel shader (``fused_kind``) runs as :func:`shade_planes` on
    CUDA tensors and as :func:`shade_planes_plain` on CPU tensors, whatever
    ``vectorized`` says. ``launch=False`` (the portable backend) launches
    no kernel on any device: a builtin runs as ``builtin.shade_plain`` (the
    plain sampler) in the user shader's place, and :func:`_pack` packs.
    """
    kind = getattr(pixel_shader, "fused_kind", None)
    if kind is not None:
        light = dict(light_pos=getattr(pixel_shader, "light_pos", LIGHT_POS),
                     light_color=getattr(pixel_shader, "light_color", LIGHT_COLOR))
        if launch:
            entry = shade_planes_plain if winner.device.type == "cpu" else shade_planes
            return entry(ctx, ps_idx, winner, kind, ps_uniform, codec, background=background, **light)
        pixel_shader = functools.partial(shade_plain, kind, **light)
    # Background pixels carry garbage ctx; ps_index = -1 marks them so
    # samplers can exclude them (their color is replaced below anyway).
    ps_idx = torch.where(winner >= 0, ps_idx, -1)
    if vectorized:
        color = pixel_shader(ps_uniform, codec.unflatten(ctx), ps_idx)
    else:

        def shade_one(flat, idx):
            return pixel_shader(ps_uniform, codec.unflatten(flat), idx)

        h, w = winner.shape
        flat = torch.func.vmap(shade_one, in_dims=(1, 0), out_dims=1)(
            ctx.reshape(ctx.shape[0], h * w), ps_idx.reshape(h * w)
        )
        color = flat.reshape(4, h, w)
    return pack_frame(color, winner, background) if launch else _pack(color, winner, background)


def _on_card(t) -> bool:
    """Whether ``t`` lies on the card, where :func:`pack_frame` launches
    (the CPU tests replace it to walk the card's route)."""
    return t.device.type == "cuda"


def pack_frame(color, winner, background):
    """A user pixel shader's (4, H, W) colour → (H, W, 4) uint8: on the card
    one launch of ``kernels.pack_rgba8`` (csrc/pack_rgba8.cu, whatever the
    colour's strides), counted as ``render.pack_kernel_frames``, on the
    colour in float32, as the JAX package computes it (a float64 or float16
    colour is converted first); :func:`_pack`, its plain version, on the
    CPU."""
    if not _on_card(color):
        return _pack(color, winner, background)
    from f_renderer_tpu_torch import kernels

    metrics.count("render.pack_kernel_frames", 1)
    h, w = winner.shape
    rgba = kernels.pack_rgba8(color.to(torch.float32), winner, background_packed(background))
    return rgba.view(torch.uint8).reshape(h, w, 4)


def _pack(color, winner, background):
    """(4, H, W) colour → (H, W, 4) uint8: ``clip(color · 255, 0, 255)``
    truncated, with NaN to 0 (what XLA's saturating float-to-u8 conversion
    gives the JAX package; a NaN to u8 cast has no fixed value in PyTorch),
    the background where winner < 0. The plain version of
    ``kernels.pack_rgba8``."""
    q = torch.clamp(color * 255.0, 0.0, 255.0)
    u8 = torch.where(torch.isnan(q), 0.0, q).to(torch.uint8).permute(1, 2, 0)
    bg = constant(tuple(background), u8.device, torch.uint8)
    return torch.where((winner >= 0)[..., None], u8, bg)


def shade_planes_plain(ctx, ps_idx, winner, kind, ps_uniform, codec: ContextCodec, *, background=(0, 0, 0, 255),
                       light_pos=LIGHT_POS, light_color=LIGHT_COLOR):
    """The plain version of :func:`shade_planes`, on the tensors' device:
    the builtin pixel shader of ``fused_kind`` ``kind`` (``builtin.shade_plain``,
    the plain sampler) on the planes as :func:`shade_from_planes` runs a
    pixel shader, and its pack. It launches no kernel on any device.
    ValueError where ``codec`` lacks a varying the builtin reads or gives it
    another width (``builtin.varying_offsets``)."""
    varying_offsets(kind, codec)
    stack, view_pos = shading_inputs(kind, ps_uniform, winner.device)
    u = dict(ps_uniform, textures=stack, view_pos=view_pos)
    ps_idx = torch.where(winner >= 0, ps_idx, -1)
    color = shade_plain(kind, u, codec.unflatten(ctx), ps_idx, light_pos=light_pos, light_color=light_color)
    return _pack(color, winner, background)


def shade_planes(ctx, ps_idx, winner, kind, ps_uniform, codec: ContextCodec, *, background=(0, 0, 0, 255),
                 light_pos=LIGHT_POS, light_color=LIGHT_COLOR):
    """The builtin pixel shader of ``fused_kind`` ``kind`` on the planes,
    packed, with the background where winner < 0, in one launch of
    ``kernels.shade_planes`` (csrc/shade_planes.cu) → (H, W, 4) uint8. The
    planes are read through their strides (K4's cropped planes need no
    copy), each varying at the channel ``codec`` gives its name; the
    sampler's opaque shortcut only where ``TextureStack.sampler_opaque``
    allows it, as the plain sampler takes it. CUDA tensors only (it launches
    or raises); :func:`shade_planes_plain` is its plain version."""
    from f_renderer_tpu_torch import kernels

    stack, view_pos = shading_inputs(kind, ps_uniform, winner.device)
    rgba = kernels.shade_planes(
        ctx, ps_idx, winner, view_pos.to(torch.float32).contiguous(), stack.dims, stack.texels, kind=kind,
        varyings=varying_offsets(kind, codec), opaque=stack.sampler_opaque(ps_idx),
        bg_packed=background_packed(background), light_pos=light_pos, light_color=light_color)
    h, w = winner.shape
    return rgba.view(torch.uint8).reshape(h, w, 4)


def shade_deferred(
    tri: TriangleBuffer,
    winner,
    pixel_shader: Callable,
    ps_uniform,
    codec: ContextCodec,
    *,
    background=(0, 0, 0, 255),
    origin=(0, 0),
    vectorized: bool = True,
    launch: bool = True,
):
    """Run the pixel shader over the frame; returns (H, W, 4) uint8.

    ``pixel_shader(ps_uniform, context planes, ps_index) -> rgba (4, H, W)``
    (see :func:`shade_from_planes` for ``vectorized`` and ``launch``);
    ``origin`` as in :func:`interpolate_context`.
    """
    h, w = winner.shape
    ctx, ps_idx = interpolate_context(tri, winner, w, h, origin=origin)
    return shade_from_planes(
        ctx, ps_idx, winner, pixel_shader, ps_uniform, codec, background=background,
        vectorized=vectorized, launch=launch,
    )
