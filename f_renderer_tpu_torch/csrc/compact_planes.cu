// The compaction of K4's planes to their covered pixels, for a user's pixel
// shader: the covered pixels' varyings and texture ids gathered into
// compact planes in raster order, each pixel's slot in a slot map, and the
// frame's rung of the ladder (pipeline/shade.py RUNGS) chosen from the
// count, so that the shader runs on the rung's rows and not on the frame.
//
// Replaces no TPU kernel: the JAX package runs its shader on the whole frame
// (f_renderer_tpu/pipeline/shade.py:80-…), and so did the port, because a
// captured frame has static shapes. The reference calls its pixel shader
// once a covered pixel (renderer.rs:343-381). The plain version is
// pipeline/shade.py:compact_planes_plain, bit for bit on the count, the rung,
// the slot map and the rung's rows of the compact planes.
//
// Design: one cooperative launch (cudaLaunchAttributeCooperative: every
// block resident, so a grid barrier cannot deadlock) of at most the blocks
// the card holds at once; a block owns a run of `chunk` pixels in raster
// order, taken in passes of 256 (each thread steps its pixel's row and
// column, with no division a pixel). 1. each warp ballots its pixels' winners a
// pass: its count goes to shared memory, and each thread keeps its covered
// bits (the first 64 passes) in a register; the block scans the counts
// (pass-major) into each warp's first slot a pass; the grid's barrier; 2.
// each block sums the blocks' counts before it (its first slot) and all of
// them (the frame's count) and chooses the rung; block 0 records them,
// sets each rung's conditional node (cudaGraphSetConditional, as
// tri_setup_kernel's last block does) and adds the frame to the tally; 3.
// each warp walks its pixels again with no barrier: its slot a pass, a
// ballot, a covered pixel's rank in it, so slots follow raster order with
// no atomic (the same slots every run); a covered pixel loads its texture
// id and up to 8 varyings at once and stores them at its slot; 4. on a
// rung, the grid fills the rung's slots past the count with ps -1 and
// zeros. The whole frame's rung writes the slot map only. A frame of more
// than 65,536 pixels a resident block (52 M pixels on an H100) is refused.
//
// What bounds it on the card: bytes. At 1920 x 1080 with C = 8 and ~557 k
// covered pixels on rung 3/8: the winner read (8.3 MB), the covered
// pixels' texture ids and varyings (20.1 MB), the slot map (8.3 MB) and the
// rung's compact planes (28.0 MB) written: ~65 MB, 0.019 ms at 3.35 TB/s.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPasses = 256;  // a block's most passes: chunk <= kMaxPasses * kThreads
constexpr int kBits = 64;        // the passes whose covered bit a thread keeps in a register
constexpr int kBatch = 8;        // the varyings a covered pixel loads at once

// The sum of v over the block, in every thread; `red` kWarps words of
// shared memory, free again on return.
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) s += red[k];
  __syncthreads();
  return s;
}

// A thread's pixel, pass by pass: pixel i (raster order) as its row and
// column, stepped kThreads pixels a pass; a division only where the step
// leaves the row (once in w / kThreads passes at 1920 columns).
struct Walk {
  int y, x;
  __device__ __forceinline__ Walk(int i, int w) : y(i / w), x(i - i / w * w) {}
  __device__ __forceinline__ void step(int w) {
    x += kThreads;
    if (x >= w) {
      const int rows = x / w;
      y += rows;
      x -= rows * w;
    }
  }
};

// Pixel (y, x)'s texture id and varyings to compact slot `slot`.
__device__ __forceinline__ void copy_pixel(const FrCompactParams& p, const int32_t* __restrict__ ps,
                                           const float* __restrict__ ctx, int y, int x, int slot,
                                           int32_t* __restrict__ ps_c, float* __restrict__ ctx_c) {
  const size_t plane = (size_t)p.rmax * p.w;  // the compact planes' channel stride
  const float* px = ctx + y * p.ctx_row + x * p.ctx_col;
  const int32_t id = __ldg(ps + y * p.ps_row + x * p.ps_col);
  for (int c0 = 0; c0 < p.n_ctx; c0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j < p.n_ctx) v[j] = __ldg(px + (c0 + j) * p.ctx_channel);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j < p.n_ctx) ctx_c[(c0 + j) * plane + slot] = v[j];
    }
  }
  ps_c[slot] = id;
}

__global__ void __launch_bounds__(kThreads)
compact_planes_kernel(const __grid_constant__ FrCompactParams p, const int32_t* __restrict__ winner,
                      const int32_t* __restrict__ ps, const float* __restrict__ ctx, int32_t* __restrict__ info,
                      int32_t* __restrict__ slots, int32_t* __restrict__ ps_c, float* __restrict__ ctx_c,
                      unsigned long long* __restrict__ tally) {
  __shared__ int first[kMaxPasses * kWarps];  // a warp's covered pixels a pass, then its first slot in the block
  __shared__ int red[kWarps];
  const int n = p.h * p.w;
  const int base = blockIdx.x * p.chunk;
  const int end = min(base + p.chunk, n);
  const int passes = base < end ? (end - base + kThreads - 1) / kThreads : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* counts = info + 2;
  // 1. each warp's covered pixels a pass; the thread's first kBits covered bits
  unsigned long long bits = 0;
  const int w = max(p.w, 1);
  Walk at(base + threadIdx.x, w);
#pragma unroll 4
  for (int it = 0; it < passes; ++it) {
    const int i = base + it * kThreads + threadIdx.x;
    const bool cov = i < end && __ldg(winner + at.y * p.winner_row + at.x * p.winner_col) >= 0;
    const unsigned m = __ballot_sync(0xffffffffu, cov);
    if (lane == 0) first[it * kWarps + warp] = __popc(m);
    if (it < kBits) bits |= (unsigned long long)cov << it;
    at.step(w);
  }
  __syncthreads();
  // the counts' exclusive prefix, pass-major: each thread a run of entries
  const int entries = passes * kWarps;
  const int per = (entries + kThreads - 1) / kThreads;
  const int e0 = min(threadIdx.x * per, entries), e1 = min(e0 + per, entries);
  int run = 0;
  for (int e = e0; e < e1; ++e) run += first[e];
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int acc = incl - run, mine = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int c = red[k];
    acc += k < warp ? c : 0;
    mine += c;
  }
  for (int e = e0; e < e1; ++e) {
    const int c = first[e];
    first[e] = acc;
    acc += c;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = mine;
  __syncthreads();  // `first` whole, `red` read
  cg::this_grid().sync();
  // 2. the block's first slot, the frame's count and its rung
  int before = 0, total = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    const int c = __ldcg(counts + j);
    total += c;
    before += j < (int)blockIdx.x ? c : 0;
  }
  before = block_sum(before, red);
  total = block_sum(total, red);
  int rung = 0;
  while (rung < FR_RUNGS && (long long)p.rows[rung] * p.w < total) ++rung;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    info[0] = total;
    info[1] = rung;
    if (p.conds) {
      for (int k = 0; k <= FR_RUNGS; ++k) cudaGraphSetConditional(p.cond[k], k == rung ? 1u : 0u);
    }
    if (tally != nullptr) {
      atomicAdd(tally + rung, 1ull);
      atomicAdd(tally + FR_RUNGS + 1, (unsigned long long)total);
      atomicAdd(tally + FR_RUNGS + 2, (unsigned long long)(rung < FR_RUNGS ? p.rows[rung] * p.w : n));
      atomicAdd(tally + FR_RUNGS + 3, (unsigned long long)n);
    }
  }
  const bool compact = rung < FR_RUNGS;
  // 3. the slots, in raster order, and the covered pixels' planes at them
  const unsigned below = (1u << lane) - 1u;
  at = Walk(base + threadIdx.x, w);
  for (int it = 0; it < passes; ++it, at.step(w)) {
    const int i = base + it * kThreads + threadIdx.x;
    const bool cov = it < kBits ? (bits >> it) & 1ull
                                : i < end && __ldg(winner + at.y * p.winner_row + at.x * p.winner_col) >= 0;
    const unsigned m = __ballot_sync(0xffffffffu, cov);
    if (i >= end) continue;
    const int slot = before + first[it * kWarps + warp] + __popc(m & below);
    slots[i] = cov ? slot : -1;
    if (cov && compact) copy_pixel(p, ps, ctx, at.y, at.x, slot, ps_c, ctx_c);
  }
  // 4. the rung's slots past the count: ps -1, zeros
  if (compact) {
    const size_t plane = (size_t)p.rmax * p.w;
    const int cap = p.rows[rung] * p.w;
    for (int s = total + blockIdx.x * kThreads + threadIdx.x; s < cap; s += gridDim.x * kThreads) {
      ps_c[s] = -1;
      for (int c = 0; c < p.n_ctx; ++c) ctx_c[c * plane + s] = 0.0f;
    }
  }
}

}  // namespace

extern "C" int fr_compact_planes(FrCompactParams p, const int32_t* winner, const int32_t* ps, const float* ctx,
                                 int32_t* info, int32_t* slots, int32_t* ps_c, float* ctx_c,
                                 unsigned long long* tally, void* stream) {
  if (p.h < 0 || p.w < 0 || p.n_ctx < 0 || (long long)p.h * p.w > 0x7FFFFFFFLL || p.rmax != p.rows[FR_RUNGS - 1])
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < FR_RUNGS; ++k) {
    if (p.rows[k] < 0 || p.rows[k] > p.h || (k > 0 && p.rows[k] < p.rows[k - 1])) return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_planes_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  int most = per_sm * sms;  // the blocks resident at once: a cooperative grid's most
  if (most > FR_COMPACT_MAX_BLOCKS) most = FR_COMPACT_MAX_BLOCKS;
  if (most < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long n = (long long)p.h * p.w;
  long long chunk = (n + most - 1) / most;
  chunk = (chunk + kThreads - 1) / kThreads * kThreads;
  if (chunk < kThreads) chunk = kThreads;
  if (chunk > (long long)kMaxPasses * kThreads) return (int)cudaErrorInvalidValue;  // a frame past the grid's passes
  p.chunk = (int32_t)chunk;
  const unsigned blocks = (unsigned)(n > 0 ? (n + chunk - 1) / chunk : 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, compact_planes_kernel, p, winner, ps, ctx, info, slots, ps_c, ctx_c, tally);
}
