"""Bilinear RGBA8 texture sampling, plain PyTorch version.

Port of ``f_renderer_tpu/shaders/texture_pallas.py:sample_packed_planar``
(K2) and of the standalone sampler ``sample_bilinear_pallas`` (K3). On the
card the same arithmetic runs as a device function (``csrc/sampler.cuh``)
inside the fused raster kernel (``csrc/fused_raster.cu``) and inside K3's
kernel (``csrc/sample_bilinear.cu``); this module is their plain version,
which the CPU tests hold against the JAX package and which the plain
versions of both kernels call.

Semantics (FrameBuffer::sample_2d, renderer.rs:516-538, as K2 has them):

- fract() weights, ``x = u·w``, ``y = v·h`` with a NaN guard before the
  fracts (texture_pallas.py:143-147);
- the width-clamp-on-y quirk: y clamps to ``w - 1``, not ``h - 1``
  (``replicate_clamp_bug``, on by default as in the JAX package);
- y clamps to the stack's row extent ``hmax - 1`` (:159-162);
- texels are u8/255: the four taps accumulate as
  ``(((0 + w11·t11) + w12·t12) + w21·t21) + w22·t22`` in [0, 255] and one
  correctly rounded division by 255 follows (:342-413);
- ``opaque`` stacks take alpha as the weight sum, with no division;
- a texture id outside ``[0, T)`` (background: -1) samples 0.
"""

from __future__ import annotations

import torch

from f_renderer_tpu_torch.math.transforms import true_div


def _u8(g, c):
    """Channel c of packed RGBA8 int32 texels → float32 in [0, 255]."""
    return ((g >> (8 * c)) & 0xFF).to(torch.float32)


def _bilinear_taps(texels, dims, ps, u, v, replicate_clamp_bug):
    """The four taps of every sample → (sel, flat texel indices t11, t12,
    t21, t22, weights w11, w12, w21, w22); weights are 0 where ``sel`` (the
    sample has a texture) is false."""
    t_count, hmax, wmax = texels.shape
    sel = (ps >= 0) & (ps < t_count)
    t = torch.where(sel, ps, 0).long()
    h_t = dims[:, 0][t]
    w_t = dims[:, 1][t]
    wf = w_t.to(torch.float32)
    hf = h_t.to(torch.float32)
    x = u * wf
    y = v * hf
    x = torch.where(torch.isnan(x), 0.0, x)
    y = torch.where(torch.isnan(y), 0.0, y)
    a = x - torch.trunc(x)
    b = y - torch.trunc(y)
    y_hi = (w_t if replicate_clamp_bug else h_t) - 1  # the width-clamp quirk
    x1 = torch.minimum(torch.clamp(torch.trunc(x), min=0.0), wf - 1.0).to(torch.int32)
    y1 = torch.minimum(
        torch.clamp(torch.trunc(y), min=0.0), y_hi.to(torch.float32)
    ).to(torch.int32)
    x1 = torch.clamp(x1, min=0)
    y1 = torch.clamp(y1, min=0)
    x2 = torch.minimum(x1 + 1, w_t - 1)
    y2 = torch.minimum(y1 + 1, y_hi)
    y1 = torch.clamp(y1, max=hmax - 1)
    y2 = torch.clamp(y2, max=hmax - 1)
    wx1 = torch.where(sel, 1.0 - a, 0.0)
    wx2 = torch.where(sel, a, 0.0)
    wy1 = 1.0 - b
    wy2 = b
    base = t * (hmax * wmax)

    def tap(yy, xx):
        return base + yy.long() * wmax + xx.long()

    taps = (tap(y1, x1), tap(y1, x2), tap(y2, x1), tap(y2, x2))
    return sel, taps, (wx1 * wy1, wx2 * wy1, wx1 * wy2, wx2 * wy2)


def texel_taps(texels, dims, ps, u, v, *, replicate_clamp_bug: bool = True):
    """Flat indices into ``texels`` of the four taps of every sample that has
    a texture, (4, n): the texels a sampler must read for these samples."""
    sel, taps, _ = _bilinear_taps(texels, dims, ps, u, v, replicate_clamp_bug)
    return torch.stack(taps)[:, sel]


def sample_packed_plain(texels, dims, ps, u, v, *, opaque: bool, replicate_clamp_bug: bool = True):
    """Sample ``texels`` (T, Hmax, Wmax) int32 RGBA8 with per-pixel texture id
    ``ps`` and coordinates ``u``, ``v`` (all of one shape) → (4, *shape) f32.

    ``dims`` is (T, 2) int32 (height, width) per texture.
    ``replicate_clamp_bug`` clamps y to the width (the reference's quirk);
    False clamps it to the height.
    """
    _, taps, (w11, w12, w21, w22) = _bilinear_taps(texels, dims, ps, u, v, replicate_clamp_bug)
    flat = texels.reshape(-1)
    t11, t12, t21, t22 = (flat[i] for i in taps)
    zero = torch.zeros_like(w11)

    def accum(c):
        return (
            ((zero + w11 * _u8(t11, c)) + w12 * _u8(t12, c)) + w21 * _u8(t21, c)
        ) + w22 * _u8(t22, c)

    rgb = [true_div(accum(c), 255.0) for c in range(3)]
    alpha = zero + (((w11 + w12) + w21) + w22) if opaque else true_div(accum(3), 255.0)
    return torch.stack(rgb + [alpha])
