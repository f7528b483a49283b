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

from typing import Callable

import torch

from f_renderer_tpu_torch.device import constant
from f_renderer_tpu_torch.math.transforms import true_div
from f_renderer_tpu_torch.pipeline.fused import background_packed
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.shaders.builtin import LIGHT_COLOR, LIGHT_POS, shade_plain, shading_inputs, varying_offsets


def interpolate_context(tri: TriangleBuffer, winner, width: int, height: int, *, origin=(0, 0)):
    """Per-pixel perspective-correct varying interpolation.

    Returns ``(ctx (C, H, W) f32, ps_index (H, W) int32)`` for the winning
    triangle at each pixel (garbage where winner < 0: mask downstream).
    ``origin=(y0, x0)``: the full-frame coordinates of the top-left pixel.
    """
    y0, x0 = origin
    wid = torch.clamp(winner, min=0).long()
    sfx = [tri.spf[v, 0][wid] for v in range(3)]
    sfy = [tri.spf[v, 1][wid] for v in range(3)]
    rhw3 = [tri.rhw[v][wid] for v in range(3)]
    nc = tri.num_channels
    dev = winner.device
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
    ctx = torch.stack(
        [
            tri.ctx[ch][wid] * coef[0] + tri.ctx[nc + ch][wid] * coef[1] + tri.ctx[2 * nc + ch][wid] * coef[2]
            for ch in range(nc)
        ]
    ) if nc else torch.zeros((0, height, width), device=dev)
    return ctx, tri.ps_index[wid]


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
):
    """Shade from interpolated context planes (``raster.rasterize_interp``).

    ``ctx`` (C, H, W) f32, ``ps_idx``/``winner`` (H, W) int32. The pixel
    shader runs once on the whole frame (``vectorized``) or once per pixel
    (``torch.func.vmap`` over the flattened pixels); the background fills
    pixels where winner < 0. Returns (H, W, 4) uint8. A builtin pixel
    shader (``fused_kind``) runs as :func:`shade_planes` on CUDA tensors
    and as :func:`shade_planes_plain` on CPU tensors, whatever
    ``vectorized`` says.
    """
    kind = getattr(pixel_shader, "fused_kind", None)
    if kind is not None:
        light = dict(light_pos=getattr(pixel_shader, "light_pos", LIGHT_POS),
                     light_color=getattr(pixel_shader, "light_color", LIGHT_COLOR))
        entry = shade_planes_plain if winner.device.type == "cpu" else shade_planes
        return entry(ctx, ps_idx, winner, kind, ps_uniform, codec, background=background, **light)
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
    return _pack(color, winner, background)


def _pack(color, winner, background):
    """(4, H, W) colour → (H, W, 4) uint8: ``clip(color · 255, 0, 255)``
    truncated, with NaN to 0 (what XLA's saturating float-to-u8 conversion
    gives the JAX package; a NaN to u8 cast has no fixed value in PyTorch),
    the background where winner < 0."""
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
):
    """Run the pixel shader over the frame; returns (H, W, 4) uint8.

    ``pixel_shader(ps_uniform, context planes, ps_index) -> rgba (4, H, W)``
    (see :func:`shade_from_planes` for ``vectorized``); ``origin`` as in
    :func:`interpolate_context`.
    """
    h, w = winner.shape
    ctx, ps_idx = interpolate_context(tri, winner, w, h, origin=origin)
    return shade_from_planes(
        ctx, ps_idx, winner, pixel_shader, ps_uniform, codec, background=background,
        vectorized=vectorized,
    )
