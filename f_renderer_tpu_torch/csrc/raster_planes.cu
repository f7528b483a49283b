// Non-fused raster: per-pixel winner and depth, and optionally the
// perspective-correct varying planes and texture id of the winner, over
// (th, 128) bin tiles, th / 8 CUDA thread blocks to a tile (raster_loop.cuh).
//
// Replaces the TPU kernel f_renderer_tpu/pipeline/raster_pallas.py:1562 (the
// pallas_call in _call, "K4"), _make_kernel in chunk-scan mode, behind
// rasterize_pallas (:1583) and rasterize_interp_pallas (:1617). The plain
// version is pipeline/raster.py:raster_planes_plain.
//
// It does not carry over the chunk scan (compact_sort, chunk_bounds, DMA
// semaphores): it reads the same binned pair lists as the fused kernel and
// runs the same loop (raster_loop.cuh). The per-pixel (rhw, order) merge is
// order-free, so the winners equal the chunk scan's. The TPU kernel
// interpolated at every accept; the last accept's rhw is the final depth, so
// interpolating the winner once after the loop gives the same values.
//
// The epilogue writes raw planes instead of shading: depth, winner slot,
// and with interp the texture id (ps & 0xFF) and the C varyings. C has no
// cap: the channels go to the (C, h_pad, w_pad) output CH_GROUP at a time.
// Where no pair won, depth is 0, winner -1, ps 0 and every channel 0 (the
// TPU kernel's initial carries).
//
// What bounds it on the card: with interp, the (C + 3) plane stores (99 MB
// at phong1080_tex2048, C = 8: the bound, 0.0296 ms; with every pair list
// empty the kernel is these stores alone, 0.034 ms on an H100) and the loop's
// latency (raster_loop.cuh), which runs before a block's stores: the
// kernel is the sum of its blocks' latencies over the 264 resident blocks
// (a per-block trace, tools/k4_trace.py). The epilogue's own part was its gathers:
// ~33 scattered tri_f32 words a covered pixel, and a load behind each
// branch waits for its own round trip. So a warp with no winner writes the
// background and loads nothing; in any other warp every lane loads (from
// pair column 0 where it has no winner, then discards), so the loads of
// both rows issue together: one round trip for the ids and the 9 rows of
// the weights, one for each CH_GROUP channels (0.0685 -> 0.0629 ms on an
// H100 80GB HBM3 at 700 W, PERF.md). Tiles that no pair reaches skip the
// loop (the plan pass), but still store their 11 planes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"
#include "raster_loop.cuh"

namespace {

using namespace fr;

constexpr int CH_GROUP = 4;  // varying channels loaded together in the epilogue

template <int R, bool kOrigin>
__global__ void __launch_bounds__(TW * TY, 2)
raster_planes_kernel(const int ntx, const int nty, const int th, const int w_pad,
                     const int n_pairs, const int n_ctx, const int origin_y, const int origin_x,
                     const int32_t* __restrict__ tri_i32,
                     const float* __restrict__ tri_f32, float* __restrict__ depth_out,
                     int32_t* __restrict__ winner_out, int32_t* __restrict__ ps_out,
                     float* __restrict__ ctx_out, const int32_t* plan) {
  const int oy = kOrigin ? origin_y : 0, ox = kOrigin ? origin_x : 0;
  const TileSlot at = tile_slot(th, ntx, nty, plan, oy, ox);
  const int cx = at.cx;
  const float pcx = (float)cx + 0.5f;
  const size_t np = (size_t)n_pairs;
  const size_t plane = (size_t)nty * th * w_pad;
  float dep[R];
  int wpair[R];
  raster_tile<R, false>(tri_i32, tri_f32, np, at, dep, wpair);

  // The epilogue: no load behind a branch (the header above). pc is the
  // pair column each lane loads from, 0 where it has no winner.
  int pc[R];
  bool has[R], any = false;
  size_t o[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    o[r] = (size_t)(at.row0 + at.step * r - oy) * w_pad + (cx - ox);  // frame pixel → its place in the planes
    has[r] = wpair[r] >= 0;
    pc[r] = has[r] ? wpair[r] : 0;
    any |= has[r];
  }
  if (!__any_sync(0xFFFFFFFFu, any)) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      depth_out[o[r]] = dep[r];
      winner_out[o[r]] = -1;
      if (ps_out == nullptr) continue;
      ps_out[o[r]] = 0;
      for (int ch = 0; ch < n_ctx; ++ch) ctx_out[ch * plane + o[r]] = 0.0f;
    }
    return;
  }
  int slot[R], psv[R];
  float f[R][9];
#pragma unroll
  for (int r = 0; r < R; ++r) slot[r] = __ldg(tri_i32 + SLOT * np + pc[r]);
  if (ps_out != nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      psv[r] = __ldg(tri_i32 + PS * np + pc[r]) & PS_MASK;
      load_fields(tri_f32, np, pc[r], f[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    depth_out[o[r]] = dep[r];
    winner_out[o[r]] = has[r] ? slot[r] : -1;
  }
  if (ps_out == nullptr) return;
  float c[R][3];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ps_out[o[r]] = has[r] ? psv[r] : 0;
    weights_of(f[r], pcx, (float)(at.row0 + at.step * r) + 0.5f, dep[r], c[r][0], c[r][1], c[r][2]);
  }
  for (int ch0 = 0; ch0 < n_ctx; ch0 += CH_GROUP) {
    float v[R][CH_GROUP];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int g = 0; g < CH_GROUP; ++g) {
        const float* q = tri_f32 + (size_t)(CTX0 + min(ch0 + g, n_ctx - 1)) * np + pc[r];
        v[r][g] = (__ldg(q) * c[r][0] + __ldg(q + n_ctx * np) * c[r][1]) +
                  __ldg(q + 2 * n_ctx * np) * c[r][2];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int g = 0; g < CH_GROUP; ++g) {
        if (ch0 + g < n_ctx) ctx_out[(ch0 + g) * plane + o[r]] = has[r] ? v[r][g] : 0.0f;
      }
    }
  }
}

template <bool kOrigin>
cudaError_t launch_planes(int th, int ntx, int nty, int n_pairs, int n_ctx, int oy, int ox,
                          const int32_t* off, const int32_t* tri_i32, const float* tri_f32,
                          float* depth, int32_t* winner, int32_t* ps, float* ctx, int32_t* plan,
                          int cap, cudaStream_t s) {
  const int w_pad = ntx * TW;
  return launch_after_plan<kOrigin>(th == 4 ? raster_planes_kernel<1, kOrigin>
                                             : raster_planes_kernel<RT_MAX, kOrigin>,
                                     th, ntx, nty, oy, ox, off, tri_i32, tri_f32, n_pairs, plan, cap, s,
                                     ntx, nty, th, w_pad, n_pairs, n_ctx, oy, ox, tri_i32, tri_f32,
                                     depth, winner, ps, ctx, (const int32_t*)plan);
}

}  // namespace

extern "C" int fr_raster_planes(int th, int ntx, int nty, int n_pairs, int n_ctx, int oy, int ox,
                                const int32_t* off, const int32_t* tri_i32,
                                const float* tri_f32, float* depth, int32_t* winner,
                                int32_t* ps, float* ctx, int32_t* tiles, int cap, void* stream) {
  if (n_ctx < 0 || cap < 0 || (ps == nullptr && ctx != nullptr)) return (int)cudaErrorInvalidValue;
  if (th != 4 && th != 8 && th != 16 && th != 32 && th != 64 && th != 128) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(oy != 0 || ox != 0
                   ? launch_planes<true>(th, ntx, nty, n_pairs, n_ctx, oy, ox, off, tri_i32,
                                         tri_f32, depth, winner, ps, ctx, tiles, cap, s)
                   : launch_planes<false>(th, ntx, nty, n_pairs, n_ctx, oy, ox, off, tri_i32,
                                          tri_f32, depth, winner, ps, ctx, tiles, cap, s));
}
