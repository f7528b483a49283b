// Bilinear RGBA8 texture sample by per-pixel texture id: a device function
// called from the fused raster kernel's shading epilogue (K1) and from the
// standalone sampler kernel (K3, sample_bilinear.cu).
//
// Replaces the TPU kernel f_renderer_tpu/shaders/texture_pallas.py:95
// (sample_packed_planar, "K2"). On the TPU the packed stack sat in VMEM and
// each (row, page) of a texture's touched range was lane-gathered for a
// whole (bs, 128) pixel block. Here each thread samples its own pixel: four
// 4-byte texel loads from the (T, Hmax, Wmax) stack in device memory, which
// stays resident in the 50 MB L2 (3 MiB at phong1080) — it is far past the
// 227 KB of shared memory. What bounds it on the card is those dependent
// scattered loads, a few per shaded pixel, not arithmetic.
//
// The arithmetic is K2's, expression by expression (the plain version is
// shaders/texture_sampler.py:sample_packed_plain): fract() weights, the NaN
// guard, the width-clamp-on-y quirk (y clamps to w - 1 with
// replicate_clamp_bug, else to h - 1), the y clamp to hmax-1, taps summed as
// (((0 + w11 t11) + w12 t12) + w21 t21) + w22 t22 over u8 values and one
// IEEE division by 255 (alpha is the weight sum for opaque stacks).
#pragma once
#include <stdint.h>

__device__ __forceinline__ float fr_u8(uint32_t g, int c) {
  return (float)((g >> (8 * c)) & 0xFFu);
}

__device__ __forceinline__ void fr_sample(const int32_t* __restrict__ dims,
                                          const int32_t* __restrict__ texels,
                                          int t_count, int hmax, int wmax, bool opaque,
                                          bool replicate_clamp_bug, int ps, float u, float v,
                                          float out[4]) {
  if (ps < 0 || ps >= t_count) {  // background / no such texture: samples 0
    out[0] = out[1] = out[2] = out[3] = 0.0f;
    return;
  }
  const int h_t = dims[2 * ps];
  const int w_t = dims[2 * ps + 1];
  const float wf = (float)w_t;
  const float hf = (float)h_t;
  float x = u * wf;
  float y = v * hf;
  if (isnan(x)) x = 0.0f;
  if (isnan(y)) y = 0.0f;
  const float a = x - truncf(x);
  const float b = y - truncf(y);
  const int y_hi = (replicate_clamp_bug ? w_t : h_t) - 1;  // renderer.rs:523-525
  int x1 = (int)fminf(fmaxf(truncf(x), 0.0f), wf - 1.0f);
  int y1 = (int)fminf(fmaxf(truncf(y), 0.0f), (float)y_hi);
  x1 = max(x1, 0);
  y1 = max(y1, 0);
  const int x2 = min(x1 + 1, w_t - 1);
  int y2 = min(y1 + 1, y_hi);
  y1 = min(y1, hmax - 1);
  y2 = min(y2, hmax - 1);
  const float wx1 = 1.0f - a, wx2 = a, wy1 = 1.0f - b, wy2 = b;
  const float w11 = wx1 * wy1, w12 = wx2 * wy1, w21 = wx1 * wy2, w22 = wx2 * wy2;
  const int32_t* tex = texels + (size_t)ps * hmax * wmax;
  const uint32_t t11 = (uint32_t)__ldg(tex + (size_t)y1 * wmax + x1);
  const uint32_t t12 = (uint32_t)__ldg(tex + (size_t)y1 * wmax + x2);
  const uint32_t t21 = (uint32_t)__ldg(tex + (size_t)y2 * wmax + x1);
  const uint32_t t22 = (uint32_t)__ldg(tex + (size_t)y2 * wmax + x2);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float acc = 0.0f;
    acc = acc + w11 * fr_u8(t11, c);
    acc = acc + w12 * fr_u8(t12, c);
    acc = acc + w21 * fr_u8(t21, c);
    acc = acc + w22 * fr_u8(t22, c);
    out[c] = acc / 255.0f;
  }
  if (opaque) out[3] = 0.0f + (((w11 + w12) + w21) + w22);
}
