// The per-tile raster loop shared by the fused kernel (K1, fused_raster.cu)
// and the non-fused raster kernel (K4, raster_planes.cu). A (th, 128) bin
// tile is shared by S = th / (4 RT) thread blocks of 128 x 4 threads; each
// thread owns RT rows (RT = 2, or 1 at th = 4) of one pixel column, the rows
// of the tile interleaved with a stride of 4 S over the blocks and their
// warps, so each warp owns 32 columns x RT rows spread over the tile.
//
// Over the tile's own fine pair range, its coarse-bin range and the shared
// spill range it computes, per pixel: affine int32 edges (wrapped: computed
// in uint32), e12 = area2 - e01 - e20, the sign-OR cover test against the
// exclusive bbox max, |cross| barycentrics with an s != 0 guard, rhw, and
// the strict (rhw, order) maximum, recording the winning pair. This is the
// loop of f_renderer_tpu/pipeline/raster_pallas.py:_make_kernel (the
// tri_body at :773-889); its plain version is
// pipeline/raster.py:raster_tiles_plain. With --fmad=false and IEEE
// division the results match the plain version to the bit.
//
// What bounds it on the card: the (pair, pixel) work inside each pair's
// bbox, and how it is spread over the warps. A tile that holds many small
// triangles (the sphere's pole at phong1080: 557 pairs) is the critical
// path: its work falls to the few warps whose pixels those triangles touch,
// each a latency-bound chain of pairs and rows. The design against both:
//  - warp-level bbox culling: the 32 lanes of a warp test 32 staged pairs'
//    bboxes [MINXY, MAXXY) against the warp's columns and rows at once, and
//    the warp walks only the pairs of the ballot, skipping its rows outside
//    [min_y, max_y). Both tests are warp-uniform branches. They are exact
//    because every pixel the cover test accepts lies inside its pair's
//    bbox (the edges bound it from below, MAXXY from above;
//    tests/test_torch_raster.py pins it), and the merge does not depend on
//    the order of the pairs;
//  - interleaved rows: a small triangle's rows fall to several warps of
//    several blocks (on several SMs), so no warp carries a long chain;
//  - heaviest tiles first (tile_order_kernel): the longest chains start in
//    the first wave;
//  - the three ranges are one list, staged in chunks of 128 pair records of
//    80 bytes (read as five 16-byte broadcasts) by 4-byte cp.async copies
//    into two buffers, so chunk i + 1 loads while chunk i runs;
//  - each pixel carries only (depth, pair): the winner's order, needed on
//    an exact rhw tie alone, is read back from device memory then; the
//    kernels fit two blocks an SM in 64 registers (three, in 40, spilled
//    and measured no faster: PERF.md).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace fr {

// tri_i32 / tri_f32 rows (pipeline/raster.py)
constexpr int A01 = 0, B01 = 1, C01 = 2, A20 = 3, B20 = 4, C20 = 5, AREA2 = 6,
              ORDER = 7, MINXY = 8, MAXXY = 9, SLOT = 10, PS = 11;
constexpr int S0X = 0, S0Y = 1, S1X = 2, S1Y = 3, S2X = 4, S2Y = 5, RHW0 = 6,
              RHW1 = 7, RHW2 = 8, CTX0 = 9;
constexpr int PS_MASK = 0xFF;
constexpr int TW = 128;     // tile width = threads in x
constexpr int TY = 4;       // threads in y
constexpr int CHUNK = 128;  // pair records staged in shared memory at a time
constexpr int COARSE = 4;
constexpr int ORDER_NONE = INT32_MIN;
// A staged pair record, 20 words: the 8 int32 rows A01..ORDER, MAXXY, the 9
// float rows S0X..RHW2, the pair's column, MINXY.
constexpr int REC = 20, REC_MAXXY = 8, REC_F = 9, REC_PAIR = 18, REC_MINXY = 19;

constexpr int RT_MAX = 2;   // rows per thread (1 at th = 4)

// Rows per thread and blocks per tile for tile height th.
__host__ __device__ constexpr int rows_per_thread(int th) { return th < TY * RT_MAX ? 1 : RT_MAX; }
__host__ __device__ constexpr int blocks_per_tile(int th) { return th / (TY * rows_per_thread(th)); }

// Where this block's thread (threadIdx.x, threadIdx.y) sits: block b of the
// grid (ntiles * S) is slice s = b % S of tile order[b / S]; the thread owns
// column cx and rows row0 + step * r, r < RT.
struct TileSlot {
  int tile_x, tile_y, cx, row0, step;
};

__device__ __forceinline__ TileSlot tile_slot(int th, int ntx, const int32_t* __restrict__ order) {
  const int S = blocks_per_tile(th);
  const int t = order[blockIdx.x / S], s = blockIdx.x % S;
  const int tile_x = t % ntx, tile_y = t / ntx;
  return {tile_x, tile_y, tile_x * TW + (int)threadIdx.x,
          tile_y * th + s + S * (int)threadIdx.y, TY * S};
}

// Heaviest tiles first: one block of 1024 threads writes every tile id to
// order (ntiles,), the tiles with the most pairs in their fine and coarse
// ranges (the spill range is every tile's) first, bucketed by the pairs'
// floor(log2). The raster kernels take their tiles in this order, so the
// longest tiles start in the first wave instead of wherever the grid puts
// them. Any order gives the same pixels.
constexpr int ORDER_THREADS = 1024;

__device__ __forceinline__ int tile_weight(const int32_t* __restrict__ off, int t, int ntx,
                                           int ntiles, int ntxc) {
  const int c = ntiles + (t / ntx / COARSE) * ntxc + (t % ntx) / COARSE;
  const int n = (off[t + 1] - off[t]) + (off[c + 1] - off[c]);
  return n > 0 ? 32 - __clz(n) : 0;  // 0 .. 32
}

static __global__ void __launch_bounds__(ORDER_THREADS)
tile_order_kernel(const int32_t* __restrict__ off, int ntx, int nty, int32_t* __restrict__ order) {
  __shared__ int slot[33];
  const int ntiles = ntx * nty, ntxc = (ntx + COARSE - 1) / COARSE;
  if (threadIdx.x < 33) slot[threadIdx.x] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < ntiles; t += ORDER_THREADS)
    atomicAdd(&slot[tile_weight(off, t, ntx, ntiles, ntxc)], 1);
  __syncthreads();
  if (threadIdx.x == 0) {  // each bucket's first position, heaviest bucket first
    int at = 0;
    for (int w = 32; w >= 0; --w) {
      const int n = slot[w];
      slot[w] = at;
      at += n;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ntiles; t += ORDER_THREADS)
    order[atomicAdd(&slot[tile_weight(off, t, ntx, ntiles, ntxc)], 1)] = t;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Stage the pairs v0 .. v0 + n - 1 of the tile's list (the three ranges one
// after another) into rec[0 .. n - 1]; the copies are committed as one group.
__device__ __forceinline__ void stage_chunk(int32_t (*rec)[REC], int v0, int n,
                                            const int (&starts)[3], int len0, int len01,
                                            const int32_t* __restrict__ tri_i32,
                                            const float* __restrict__ tri_f32, size_t np,
                                            int tid) {
  for (int e = tid; e < REC * CHUNK; e += TW * TY) {
    const int f = e / CHUNK, j = e % CHUNK;
    if (j >= n) continue;
    const int v = v0 + j;
    const int pair = v < len0 ? starts[0] + v
                     : v < len01 ? starts[1] + (v - len0)
                                 : starts[2] + (v - len01);
    if (f == REC_PAIR) {
      rec[j][f] = pair;
      continue;
    }
    const void* src;
    if (f < REC_MAXXY) src = tri_i32 + f * np + pair;
    else if (f == REC_MAXXY) src = tri_i32 + MAXXY * np + pair;
    else if (f == REC_MINXY) src = tri_i32 + MINXY * np + pair;
    else src = tri_f32 + (f - REC_F) * np + pair;
    cp_async4(&rec[j][f], src);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A staged pair record, unpacked for the pixel column cx.
struct Pair {
  uint32_t b01, b20, area2, ex01, ex20;  // ex = A * cx + C of the two edges
  int32_t xbits;                         // max_x - 1 - cx: negative past the bbox
  int order, miny, maxy, pair;
  float f0x, f0y, f1x, f1y, f2x, f2y, r0, r1, r2;
};

__device__ __forceinline__ Pair load_pair(const int32_t* rec, int cx) {
  const int4* q = reinterpret_cast<const int4*>(rec);
  const int4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3], q4 = q[4];
  Pair p;
  p.b01 = (uint32_t)q0.y;
  p.b20 = (uint32_t)q1.x;
  p.area2 = (uint32_t)q1.z;
  p.ex01 = (uint32_t)q0.x * (uint32_t)cx + (uint32_t)q0.z;
  p.ex20 = (uint32_t)q0.w * (uint32_t)cx + (uint32_t)q1.y;
  p.xbits = (q2.x & 0xFFFF) - 1 - cx;
  p.order = q1.w;
  p.miny = q4.w >> 16;
  p.maxy = q2.x >> 16;
  p.pair = q4.z;
  p.f0x = __int_as_float(q2.y), p.f0y = __int_as_float(q2.z), p.f1x = __int_as_float(q2.w);
  p.f1y = __int_as_float(q3.x), p.f2x = __int_as_float(q3.y), p.f2y = __int_as_float(q3.z);
  p.r0 = __int_as_float(q3.w), p.r1 = __int_as_float(q4.x), p.r2 = __int_as_float(q4.y);
  return p;
}

// The cover test of row cy (inside the bbox's rows): wrapped int32 edges
// e = (A cx + B cy) + C, e12 = area2 - e01 - e20, all >= 0, and cx < max_x.
__device__ __forceinline__ bool covers(const Pair& p, int cy) {
  const uint32_t e01 = p.ex01 + p.b01 * (uint32_t)cy;
  const uint32_t e20 = p.ex20 + p.b20 * (uint32_t)cy;
  const uint32_t e12 = p.area2 - e01 - e20;
  return ((e01 | e12 | e20 | (uint32_t)p.xbits) & 0x80000000u) == 0u;
}

// |cross| barycentrics at the pixel centre and rhw; false where s == 0.
__device__ __forceinline__ bool depth_of(const Pair& p, float pcx, float pcy, float& rhw) {
  const float s0x = p.f0x - pcx, s0y = p.f0y - pcy;
  const float s1x = p.f1x - pcx, s1y = p.f1y - pcy;
  const float s2x = p.f2x - pcx, s2y = p.f2y - pcy;
  const float a = fabsf(s1x * s2y - s1y * s2x);
  const float b = fabsf(s2x * s0y - s2y * s0x);
  const float c = fabsf(s0x * s1y - s0y * s1x);
  const float s = (a + b) + c;
  const float inv_s = 1.0f / s;
  rhw = (p.r0 * (a * inv_s) + p.r1 * (b * inv_s)) + p.r2 * (c * inv_s);
  return s != 0.0f;
}

// Fold a covered pair into the pixel's strict (rhw, order) maximum; the
// order of the current winner is needed on an exact tie only.
__device__ __forceinline__ void merge(float rhw, const Pair& p, const int32_t* __restrict__ tri_i32,
                                      size_t np, float& dep, int& wpair) {
  bool take = rhw > dep;
  if (!take && rhw == dep) {
    const int word = wpair < 0 ? ORDER_NONE : __ldg(tri_i32 + ORDER * np + wpair);
    take = p.order > word;
  }
  if (take) {
    dep = rhw;
    wpair = p.pair;
  }
}

// Walk the tile of slot ``at`` and leave, for each of the thread's R pixels
// (column at.cx, rows at.row0 + at.step * r), the winning depth (0 if none)
// and pair column (-1 if none). Every thread of the block must call it (it
// synchronises the block).
template <int R>
__device__ __forceinline__ void raster_tile(const int32_t* __restrict__ off,
                                            const int32_t* __restrict__ tri_i32,
                                            const float* __restrict__ tri_f32, int ntx,
                                            int nty, size_t np, const TileSlot& at,
                                            float (&dep)[R], int (&wpair)[R]) {
  __shared__ __align__(16) int32_t s_rec[2][CHUNK][REC];
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int cx = at.cx, row0 = at.row0, step = at.step;
  const float pcx = (float)cx + 0.5f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dep[r] = 0.0f;
    wpair[r] = -1;
  }
  // the warp's pixels: columns [wx0, wx0 + 32), rows row0 + step * r
  const int wx0 = cx - lane;

  const int tile_x = at.tile_x, tile_y = at.tile_y;
  const int ntiles = ntx * nty;
  const int ntxc = (ntx + COARSE - 1) / COARSE;
  const int ntilesc = ntxc * ((nty + COARSE - 1) / COARSE);
  const int t_lin = tile_y * ntx + tile_x;
  const int c_lin = ntiles + (tile_y / COARSE) * ntxc + tile_x / COARSE;
  const int s_lin = ntiles + ntilesc;
  const int starts[3] = {off[t_lin], off[c_lin], off[s_lin]};
  const int len0 = off[t_lin + 1] - starts[0];
  const int len01 = len0 + off[c_lin + 1] - starts[1];
  const int total = len01 + off[s_lin + 1] - starts[2];
  const int nchunks = (total + CHUNK - 1) / CHUNK;

  if (nchunks > 0) {
    stage_chunk(s_rec[0], 0, min(CHUNK, total), starts, len0, len01, tri_i32, tri_f32, np, tid);
  }
  for (int ci = 0; ci < nchunks; ++ci) {
    if (ci + 1 < nchunks) {
      const int v1 = (ci + 1) * CHUNK;
      stage_chunk(s_rec[(ci + 1) & 1], v1, min(CHUNK, total - v1), starts, len0, len01,
                  tri_i32, tri_f32, np, tid);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk ci is in shared memory for every thread
    const int32_t (*rec)[REC] = s_rec[ci & 1];
    const int n = min(CHUNK, total - ci * CHUNK);
    for (int j0 = 0; j0 < n; j0 += 32) {
      // lane l tests pair j0 + l's bbox against the warp's columns and rows
      bool touch = false;
      if (j0 + lane < n) {
        const int mn = rec[j0 + lane][REC_MINXY], mx = rec[j0 + lane][REC_MAXXY];
        const int miny = mn >> 16, maxy = mx >> 16;
        bool rows = false;
#pragma unroll
        for (int r = 0; r < R; ++r) rows |= row0 + step * r >= miny && row0 + step * r < maxy;
        touch = rows && (mn & 0xFFFF) < wx0 + 32 && (mx & 0xFFFF) > wx0;
      }
      uint32_t mask = __ballot_sync(0xFFFFFFFFu, touch);
      while (mask != 0u) {
        const int j = j0 + __ffs(mask) - 1;
        mask &= mask - 1u;
        const Pair pr = load_pair(rec[j], cx);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int cy = row0 + step * r;
          if (cy < pr.miny || cy >= pr.maxy) continue;  // the row is outside the bbox
          if (!covers(pr, cy)) continue;
          float rhw;
          if (depth_of(pr, pcx, (float)cy + 0.5f, rhw)) merge(rhw, pr, tri_i32, np, dep[r], wpair[r]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer ci & 1 before it is refilled
  }
}

// Perspective-correct interpolation weights of pair column ``pair`` at pixel
// centre (pcx, pcy) with final depth d (renderer.rs:368-378): the varying is
// (v0 * c0 + v1 * c1) + v2 * c2. The GPU form of the TPU kernel's
// _deferred_update (raster_pallas.py:1102-1149): the barycentrics are
// recomputed from the same fields that produced the accept.
__device__ __forceinline__ void interp_weights(const float* __restrict__ tri_f32, size_t np,
                                               int pair, float pcx, float pcy, float d,
                                               float& c0, float& c1, float& c2) {
  const float* f = tri_f32 + pair;
  const float s0x = f[S0X * np] - pcx, s0y = f[S0Y * np] - pcy;
  const float s1x = f[S1X * np] - pcx, s1y = f[S1Y * np] - pcy;
  const float s2x = f[S2X * np] - pcx, s2y = f[S2Y * np] - pcy;
  const float a = fabsf(s1x * s2y - s1y * s2x);
  const float b = fabsf(s2x * s0y - s2y * s0x);
  const float c = fabsf(s0x * s1y - s0y * s1x);
  const float inv_s = 1.0f / ((a + b) + c);
  const float w_corr = 1.0f / (d != 0.0f ? d : 1.0f);
  c0 = (f[RHW0 * np] * (a * inv_s)) * w_corr;
  c1 = (f[RHW1 * np] * (b * inv_s)) * w_corr;
  c2 = (f[RHW2 * np] * (c * inv_s)) * w_corr;
}

// Varying channel ch of C interpolated with the weights above.
__device__ __forceinline__ float interp_channel(const float* __restrict__ tri_f32, size_t np,
                                                int pair, int n_ctx, int ch, float c0,
                                                float c1, float c2) {
  const float* f = tri_f32 + pair;
  return (f[(CTX0 + ch) * np] * c0 + f[(CTX0 + n_ctx + ch) * np] * c1) +
         f[(CTX0 + 2 * n_ctx + ch) * np] * c2;
}

}  // namespace fr
