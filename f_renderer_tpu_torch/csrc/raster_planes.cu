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
// cap: the channels are streamed to the (C, h_pad, w_pad) output one at a
// time, nothing per channel is held in registers. Where no pair won, depth
// is 0, winner -1, ps 0 and every channel 0 (the TPU kernel's initial
// carries).
//
// What bounds it on the card: the raster loop's ALU work inside each pair's
// bbox (raster_loop.cuh, shared with K1); the epilogue adds (C + 3) plane
// stores per pixel, coalesced along x. The epilogue has not been redesigned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"
#include "raster_loop.cuh"

namespace {

using namespace fr;

template <int R>
__global__ void __launch_bounds__(TW * TY, 2)
raster_planes_kernel(const int ntx, const int nty, const int th, const int w_pad,
                     const int n_pairs, const int n_ctx, const int32_t* __restrict__ off,
                     const int32_t* __restrict__ tri_i32, const float* __restrict__ tri_f32,
                     float* __restrict__ depth_out, int32_t* __restrict__ winner_out,
                     int32_t* __restrict__ ps_out, float* __restrict__ ctx_out,
                     const int32_t* __restrict__ order) {
  const TileSlot at = tile_slot(th, ntx, order);
  const int cx = at.cx;
  const float pcx = (float)cx + 0.5f;
  const size_t np = (size_t)n_pairs;
  const size_t plane = (size_t)nty * th * w_pad;
  float dep[R];
  int wpair[R];
  raster_tile<R>(off, tri_i32, tri_f32, ntx, nty, np, at, dep, wpair);

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int cy = at.row0 + at.step * r;
    const size_t o = (size_t)cy * w_pad + cx;
    const int pair = wpair[r];
    depth_out[o] = dep[r];
    winner_out[o] = pair < 0 ? -1 : tri_i32[SLOT * np + pair];
    if (ps_out == nullptr) continue;
    if (pair < 0) {
      ps_out[o] = 0;
      for (int ch = 0; ch < n_ctx; ++ch) ctx_out[ch * plane + o] = 0.0f;
      continue;
    }
    ps_out[o] = tri_i32[PS * np + pair] & PS_MASK;
    float c0, c1, c2;
    interp_weights(tri_f32, np, pair, pcx, (float)cy + 0.5f, dep[r], c0, c1, c2);
    for (int ch = 0; ch < n_ctx; ++ch) {
      ctx_out[ch * plane + o] = interp_channel(tri_f32, np, pair, n_ctx, ch, c0, c1, c2);
    }
  }
}

template <int R>
cudaError_t launch(int ntx, int nty, int th, int w_pad, int n_pairs, int n_ctx,
                   const int32_t* off, const int32_t* tri_i32, const float* tri_f32,
                   float* depth, int32_t* winner, int32_t* ps, float* ctx, int32_t* order,
                   cudaStream_t stream) {
  tile_order_kernel<<<1, ORDER_THREADS, 0, stream>>>(off, ntx, nty, order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(ntx * nty * blocks_per_tile(th)), block(TW, TY);
  raster_planes_kernel<R><<<grid, block, 0, stream>>>(ntx, nty, th, w_pad, n_pairs, n_ctx, off,
                                                       tri_i32, tri_f32, depth, winner, ps, ctx,
                                                       order);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fr_raster_planes(int th, int ntx, int nty, int n_pairs, int n_ctx,
                                const int32_t* off, const int32_t* tri_i32,
                                const float* tri_f32, float* depth, int32_t* winner,
                                int32_t* ps, float* ctx, int32_t* order, void* stream) {
  if (n_ctx < 0 || (ps == nullptr && ctx != nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int w_pad = ntx * TW;
  switch (th) {
    case 4: return (int)launch<1>(ntx, nty, th, w_pad, n_pairs, n_ctx, off, tri_i32, tri_f32, depth, winner, ps, ctx, order, s);
    case 8: case 16: case 32: case 64: case 128:
      return (int)launch<RT_MAX>(ntx, nty, th, w_pad, n_pairs, n_ctx, off, tri_i32, tri_f32, depth, winner, ps, ctx, order, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
