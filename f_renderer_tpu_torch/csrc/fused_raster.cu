// Fused raster + varying interpolation + shading + RGBA8 pack, over (th,
// 128) bin tiles, th / 8 CUDA thread blocks to a tile (raster_loop.cuh).
//
// Replaces the TPU kernel f_renderer_tpu/pipeline/fused.py:525 (the
// pallas_call in render_fused_prepared, "K1"), whose body is
// raster_pallas._make_kernel in its binned + deferred form plus the shading
// epilogue fused._make_epilogue; the texture sampler it calls (K2) is
// sampler.cuh. The plain version is pipeline/fused.py:render_fused_plain.
//
// What it computes, per pixel of the tile:
//  - the strict (rhw, order) maximum over the tile's pair lists, recording
//    the winning pair: raster_loop.cuh, shared with the non-fused raster
//    kernel (K4, raster_planes.cu);
//  - once, for the winner: perspective-correct interpolation of the C
//    varyings with the final depth (the GPU form of _deferred_update);
//  - flat / gouraud / textured / phong shading, clip-and-truncate RGBA8
//    pack, background fill.
// The arithmetic follows the JAX kernel expression by expression; with
// --fmad=false and IEEE division/sqrt the results match the plain version
// to the bit.
//
// What bounds it on the card: the raster loop's ALU work per (pair, pixel)
// inside each pair's bbox (raster_loop.cuh: warp-level bbox culling over
// double-buffered pair records), then the epilogue: per pixel, the varyings
// (3C floats of the winner) and the shading inputs read from device memory
// once, and the shading arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"
#include "raster_loop.cuh"
#include "sampler.cuh"

namespace {

using namespace fr;
constexpr int MAX_CTX = 8;

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

__device__ void shade(const FrFusedParams& p, const float* __restrict__ view_pos,
                      const int32_t* __restrict__ dims, const int32_t* __restrict__ texels,
                      int ps, const float* ctx, float col[4]) {
  if (p.kind == 0) {  // flat
    col[0] = ctx[0]; col[1] = ctx[1]; col[2] = ctx[2]; col[3] = ctx[3];
  } else if (p.kind == 1) {  // gouraud
    col[0] = ctx[0]; col[1] = ctx[1]; col[2] = ctx[2]; col[3] = 1.0f;
  } else if (p.kind == 2) {  // textured
    fr_sample(dims, texels, p.t_count, p.hmax, p.wmax, p.opaque != 0, true, ps, ctx[0], ctx[1], col);
  } else {  // phong: normal ctx[0..2], world pos ctx[3..5], uv ctx[6..7]
    float nx = ctx[0], ny = ctx[1], nz = ctx[2];
    const float px = ctx[3], py = ctx[4], pz = ctx[5];
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
    fr_sample(dims, texels, p.t_count, p.hmax, p.wmax, p.opaque != 0, true, ps, ctx[6], ctx[7], tex);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lc = p.light_color[c];
      const float light = (p.ambient[c] + diff * lc) + (0.5f * spec) * lc;
      col[c] = tex[c] * light;
    }
    col[3] = tex[3];
  }
}

template <int R>
__global__ void __launch_bounds__(TW * TY, 2)
fused_raster_kernel(const FrFusedParams p, const int32_t* __restrict__ tri_i32,
                    const float* __restrict__ tri_f32, const float* __restrict__ view_pos,
                    const int32_t* __restrict__ dims, const int32_t* __restrict__ texels,
                    int32_t* __restrict__ rgba, float* __restrict__ depth_out,
                    int32_t* __restrict__ winner_out, const TileDesc* desc) {
  const TileSlot at = tile_slot(p.th, p.ntx, desc);
  const int cx = at.cx;
  const float pcx = (float)cx + 0.5f;
  const size_t np = (size_t)p.n_pairs;
  float dep[R];
  int wpair[R];
  raster_tile<R>(tri_i32, tri_f32, np, at, dep, wpair);

  // Interpolate the winner's varyings once, shade, pack. (Unrolled, so the
  // per-pixel carries stay in registers: a dynamic index would put them in
  // local memory for the whole kernel.)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int cy = at.row0 + at.step * r;
    const size_t o = (size_t)cy * p.w_pad + cx;
    const int pair = wpair[r];
    depth_out[o] = dep[r];
    if (pair < 0) {
      winner_out[o] = -1;
      rgba[o] = p.bg_packed;
      continue;
    }
    float c0, c1, c2;
    interp_weights(tri_f32, np, pair, pcx, (float)cy + 0.5f, dep[r], c0, c1, c2);
    float ctx[MAX_CTX];
#pragma unroll
    for (int ch = 0; ch < MAX_CTX; ++ch) {
      ctx[ch] = 0.0f;
      if (ch < p.n_ctx) {
        ctx[ch] = interp_channel(tri_f32, np, pair, p.n_ctx, ch, c0, c1, c2);
      }
    }
    const int ps = tri_i32[PS * np + pair] & PS_MASK;
    winner_out[o] = tri_i32[SLOT * np + pair];
    float col[4];
    shade(p, view_pos, dims, texels, ps, ctx, col);
    const uint32_t packed = (uint32_t)u8_of(col[0]) | ((uint32_t)u8_of(col[1]) << 8) |
                            ((uint32_t)u8_of(col[2]) << 16) | ((uint32_t)u8_of(col[3]) << 24);
    rgba[o] = (int32_t)packed;
  }
}

}  // namespace

extern "C" int fr_fused_raster(FrFusedParams p, const int32_t* off, const int32_t* tri_i32,
                               const float* tri_f32, const float* view_pos,
                               const int32_t* dims, const int32_t* texels, int32_t* rgba,
                               float* depth, int32_t* winner, int32_t* tiles, void* stream) {
  if (p.n_ctx < 1 || p.n_ctx > MAX_CTX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  TileDesc* desc = reinterpret_cast<TileDesc*>(tiles);
  switch (p.th) {
    case 4:
      return (int)launch_after_order(fused_raster_kernel<1>, p.th, p.ntx, p.nty, off, tri_i32,
                                     p.n_pairs, desc, s, p, tri_i32, tri_f32, view_pos, dims,
                                     texels, rgba, depth, winner, desc);
    case 8: case 16: case 32: case 64: case 128:
      return (int)launch_after_order(fused_raster_kernel<RT_MAX>, p.th, p.ntx, p.nty, off,
                                     tri_i32, p.n_pairs, desc, s, p, tri_i32, tri_f32, view_pos,
                                     dims, texels, rgba, depth, winner, desc);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
