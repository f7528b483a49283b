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
//    pack (shade.cuh, shared with the kernel that shades K4's planes,
//    shade_planes.cu), background fill.
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
#include "shade.cuh"

namespace {

using namespace fr;
constexpr int MAX_CTX = 8;

template <int R, bool kOrigin>
__global__ void __launch_bounds__(TW * TY, 2)
fused_raster_kernel(const FrFusedParams p, const int32_t* __restrict__ tri_i32,
                    const float* __restrict__ tri_f32, const float* __restrict__ view_pos,
                    const int32_t* __restrict__ dims, const int32_t* __restrict__ texels,
                    int32_t* __restrict__ rgba, float* __restrict__ depth_out,
                    int32_t* __restrict__ winner_out, const int32_t* plan) {
  const int oy = kOrigin ? p.oy : 0, ox = kOrigin ? p.ox : 0;
  const TileSlot at = tile_slot(p.th, p.ntx, p.nty, plan, oy, ox);
  const int cx = at.cx;
  const float pcx = (float)cx + 0.5f;
  const size_t np = (size_t)p.n_pairs;
  float dep[R];
  int wpair[R];
  raster_tile<R, true>(tri_i32, tri_f32, np, at, dep, wpair);  // with the early depth test

  // Interpolate the winner's varyings once, shade, pack. (Unrolled, so the
  // per-pixel carries stay in registers: a dynamic index would put them in
  // local memory for the whole kernel.)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int cy = at.row0 + at.step * r;  // a frame row; the planes start at row oy
    const size_t o = (size_t)(cy - oy) * p.w_pad + (cx - ox);
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
    // A varying by its channel, chosen among the registers by compare and
    // select: ctx indexed by a channel known only at run time (uv: 0 for
    // textured, 6 for phong) would put the array in local memory.
    const auto varying = [&](int ch) {
      float v = ctx[0];
#pragma unroll
      for (int i = 1; i < MAX_CTX; ++i) v = ch == i ? ctx[i] : v;
      return v;
    };
    float col[4];
    // the kinds' own layouts (shaders/builtin.py PIXEL_KINDS): phong's
    // normal, pos, uv at 0, 3, 6; every other kind's varying at 0
    shade(p, view_pos, dims, texels, ps, varying, Varyings{0, 0, 3, p.kind == 2 ? 0 : 6}, col);
    rgba[o] = pack_rgba8(col);
  }
}

template <bool kOrigin>
cudaError_t launch_fused(const FrFusedParams& p, const int32_t* off, const int32_t* tri_i32,
                         const float* tri_f32, const float* view_pos, const int32_t* dims,
                         const int32_t* texels, int32_t* rgba, float* depth, int32_t* winner,
                         int32_t* plan, int cap, cudaStream_t s) {
  return launch_after_plan<kOrigin>(p.th == 4 ? fused_raster_kernel<1, kOrigin>
                                               : fused_raster_kernel<RT_MAX, kOrigin>,
                                     p.th, p.ntx, p.nty, p.oy, p.ox, off, tri_i32, tri_f32, p.n_pairs,
                                     plan, cap, s, p, tri_i32, tri_f32, view_pos, dims, texels, rgba,
                                     depth, winner, (const int32_t*)plan);
}

}  // namespace

extern "C" int fr_fused_raster(FrFusedParams p, const int32_t* off, const int32_t* tri_i32,
                               const float* tri_f32, const float* view_pos,
                               const int32_t* dims, const int32_t* texels, int32_t* rgba,
                               float* depth, int32_t* winner, int32_t* tiles, int cap,
                               void* stream) {
  if (p.n_ctx < 1 || p.n_ctx > MAX_CTX || cap < 0) return (int)cudaErrorInvalidValue;
  if (p.th != 4 && p.th != 8 && p.th != 16 && p.th != 32 && p.th != 64 && p.th != 128) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(p.oy != 0 || p.ox != 0
                   ? launch_fused<true>(p, off, tri_i32, tri_f32, view_pos, dims, texels, rgba,
                                        depth, winner, tiles, cap, s)
                   : launch_fused<false>(p, off, tri_i32, tri_f32, view_pos, dims, texels, rgba,
                                         depth, winner, tiles, cap, s));
}

extern "C" const char* fr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
