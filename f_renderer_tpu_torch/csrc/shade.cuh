// The builtin pixel shaders' per-pixel shading and RGBA8 pack: device
// functions called from the fused raster kernel's epilogue (K1,
// fused_raster.cu) and from the kernel that shades K4's planes
// (shade_planes.cu).
//
// The arithmetic is the JAX fused epilogue's (f_renderer_tpu/pipeline/
// fused.py:46-117), expression by expression; its plain version is
// shaders/builtin.py:shade_plain (phong_light_planar, the plain sampler) and
// the pack of pipeline/shade.py. With --fmad=false and IEEE division and
// sqrt the results match it to the bit.
#pragma once
#include <stdint.h>

#include "sampler.cuh"

namespace fr {

// Where a builtin kind finds its varyings: the first channel of each, as
// the context codec lays them out (the sorted varying names). A kind reads
// only its own: flat color (4), gouraud color (3), textured uv (2), phong
// normal (3), pos (3), uv (2).
struct Varyings {
  int color, normal, pos, uv;
};

__device__ __forceinline__ float nanmax0(float x) {
  // jnp.maximum(x, 0): NaN propagates
  return isnan(x) ? x : fmaxf(x, 0.0f);
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  // 1/sqrtf (two correctly rounded steps), not rsqrtf: the plain version
  // computes the same, bit for bit, on any device.
  const float inv = 1.0f / sqrtf((x * x + y * y) + z * z);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float pow32(float x) {
  // lax.integer_pow(x, 32): five squarings, not powf
#pragma unroll
  for (int i = 0; i < 5; ++i) x = x * x;
  return x;
}

__device__ __forceinline__ int u8_of(float p) {
  // clip(p * 255, 0, 255) truncated; NaN gives 0
  return (int)fminf(fmaxf(p * 255.0f, 0.0f), 255.0f);
}

__device__ __forceinline__ int32_t pack_rgba8(const float col[4]) {
  const uint32_t packed = (uint32_t)u8_of(col[0]) | ((uint32_t)u8_of(col[1]) << 8) |
                          ((uint32_t)u8_of(col[2]) << 16) | ((uint32_t)u8_of(col[3]) << 24);
  return (int32_t)packed;
}

// The builtin pixel shader of kind p.kind (0 flat, 1 gouraud, 2 textured,
// 3 phong) at one pixel: ``ctx(ch)`` reads varying channel ch, ``at`` says
// where each varying starts. P carries kind, t_count, hmax, wmax, opaque
// and the light constants (light_pos, light_color, ambient = 0.1 *
// light_color rounded once to float).
template <class P, class Ctx>
__device__ __forceinline__ void shade(const P& p, const float* __restrict__ view_pos,
                                      const int32_t* __restrict__ dims,
                                      const int32_t* __restrict__ texels, int ps, const Ctx& ctx,
                                      const Varyings& at, float col[4]) {
  if (p.kind == 0) {  // flat
    col[0] = ctx(at.color); col[1] = ctx(at.color + 1); col[2] = ctx(at.color + 2);
    col[3] = ctx(at.color + 3);
  } else if (p.kind == 1) {  // gouraud
    col[0] = ctx(at.color); col[1] = ctx(at.color + 1); col[2] = ctx(at.color + 2); col[3] = 1.0f;
  } else if (p.kind == 2) {  // textured
    fr_sample(dims, texels, p.t_count, p.hmax, p.wmax, p.opaque != 0, true, ps, ctx(at.uv),
              ctx(at.uv + 1), col);
  } else {  // phong
    float nx = ctx(at.normal), ny = ctx(at.normal + 1), nz = ctx(at.normal + 2);
    const float px = ctx(at.pos), py = ctx(at.pos + 1), pz = ctx(at.pos + 2);
    normalize3(nx, ny, nz);
    float ldx = p.light_pos[0] - px, ldy = p.light_pos[1] - py, ldz = p.light_pos[2] - pz;
    normalize3(ldx, ldy, ldz);
    const float diff = nanmax0((nx * ldx + ny * ldy) + nz * ldz);
    float vdx = view_pos[0] - px, vdy = view_pos[1] - py, vdz = view_pos[2] - pz;
    normalize3(vdx, vdy, vdz);
    // reflect(-light_dir, n) = normalize(2 (L.N) N - L), L = -light_dir
    const float d = -((ldx * nx + ldy * ny) + ldz * nz);
    float rx = (2.0f * d) * nx + ldx, ry = (2.0f * d) * ny + ldy, rz = (2.0f * d) * nz + ldz;
    normalize3(rx, ry, rz);
    const float spec = pow32(nanmax0((vdx * rx + vdy * ry) + vdz * rz));
    float tex[4];
    fr_sample(dims, texels, p.t_count, p.hmax, p.wmax, p.opaque != 0, true, ps, ctx(at.uv),
              ctx(at.uv + 1), tex);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lc = p.light_color[c];
      const float light = (p.ambient[c] + diff * lc) + (0.5f * spec) * lc;
      col[c] = tex[c] * light;
    }
    col[3] = tex[3];
  }
}

}  // namespace fr
