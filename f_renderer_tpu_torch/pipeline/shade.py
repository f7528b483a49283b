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
"""

from __future__ import annotations

from typing import Callable

import torch

from f_renderer_tpu_torch.math.transforms import true_div
from f_renderer_tpu_torch.pipeline.types import TriangleBuffer
from f_renderer_tpu_torch.shaders.api import ContextCodec


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
    pixels where winner < 0. Returns (H, W, 4) uint8.

    The pack is ``clip(color · 255, 0, 255)`` truncated to u8, with NaN to 0:
    what XLA's saturating float-to-u8 conversion gives the JAX package (a
    NaN to u8 cast has no fixed value in PyTorch).
    """
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
    q = torch.clamp(color * 255.0, 0.0, 255.0)
    u8 = torch.where(torch.isnan(q), 0.0, q).to(torch.uint8).permute(1, 2, 0)
    bg = torch.tensor(background, dtype=torch.uint8, device=u8.device)
    return torch.where((winner >= 0)[..., None], u8, bg)


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
