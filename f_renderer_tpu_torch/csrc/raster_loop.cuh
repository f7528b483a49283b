// The per-tile raster loop shared by the fused kernel (K1, fused_raster.cu)
// and the non-fused raster kernel (K4, raster_planes.cu). A (th, 128) bin
// tile is shared by S = th / (4 RT) thread blocks of 128 x 4 threads; each
// thread owns RT rows (RT = 2, or 1 at th = 4) of one pixel column: each
// warp an 8-column patch of 4 RT rows, or, in the few heaviest tiles, 32
// columns of RT rows interleaved over the tile (tile_slot).
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
// What bounds it on the card: a block's latency. Two blocks fit an SM (64
// registers), and a per-block trace of K4 at phong1080 (%globaltimer,
// tools/k4_trace.py) showed all 264 resident slots busy for the whole
// kernel: its time was the sum of its blocks' latencies over 264, not bytes
// or issue.
// That sum is the (pair, pixel) work inside each pair's bbox as
// latency-bound chains of pairs and rows on the warps whose pixels the pairs
// touch, the prologue every block pays (its tile, then its first chunk),
// and the epilogue. With the design below the sum fell by a quarter, and
// the sphere's two pole tiles (>= 256 pairs each, ~40 us of loop) became
// the critical path as well. The design:
//  - warp-level bbox culling: the 32 lanes of a warp test 32 staged pairs'
//    bboxes [MINXY, MAXXY) against the warp's columns and rows at once, and
//    the warp walks only the pairs of the ballot, skipping its rows outside
//    [min_y, max_y). Both tests are warp-uniform branches. They are exact
//    because every pixel the cover test accepts lies inside its pair's
//    bbox (the edges bound it from below, MAXXY from above;
//    tests/test_torch_raster.py pins it), and the merge does not depend on
//    the order of the pairs;
//  - the warps' pixel layout (tile_slot): 8 x 8 patches, where a small
//    triangle touches fewer warps and fills more lanes than a 32-pixel row
//    (a CPU model of the ballot at phong1080, tools/raster_model.py: 38%
//    fewer instructions, 26% less summed block chains); rows interleaved
//    over the blocks in the heaviest tiles, so no warp there carries a long
//    chain;
//  - the order pass (tile_order_kernel) writes each tile's descriptor
//    (its three ranges, 32 bytes) heaviest tile first, so the longest
//    chains start at once and a block finds its ranges in one dependent
//    load; the raster grid starts behind it by programmatic dependent
//    launch, and the pass empties the list of a tile that none of its
//    pairs' bboxes reaches (332 of phong1080's 510 tiles,
//    tools/raster_model.py), whose blocks then
//    write the background without staging anything;
//  - the three ranges are one list, staged in chunks of 128 pair records of
//    80 bytes (read as five 16-byte broadcasts) by 4-byte cp.async copies
//    into two buffers, so chunk i + 1 loads while chunk i runs;
//  - each pixel carries only (depth, pair): the winner's order, needed on
//    an exact rhw tie alone, is read back from device memory then; the
//    kernels fit two blocks an SM in 64 registers (three, in 40, spilled
//    and measured no faster: PERF.md).
// Measured slower and dropped (PERF.md): a persistent grid taking slots
// from an atomic ticket, or statically; heaviest and lightest tiles in
// turn; the heaviest tiles' lists cut into parts over more blocks, folded
// by the last part (it halved the pole tiles' chain, yet K4 with varyings
// read slower).
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

// A tile's pair list as the raster blocks walk it: its fine, coarse and
// spill ranges one after another, starting at starts[0..2], with len0 /
// len01 / total pairs up to the end of each. Eight words, one 32-byte
// sector, so a block reads its tile in one load.
struct __align__(16) TileDesc {
  int t, len0, len01, total;
  int starts[3], pad;
};

// Heaviest tiles first: one block of 1024 threads writes every tile's
// descriptor to desc (ntiles,), the tiles with the most pairs in their fine
// and coarse ranges (the spill range is every tile's) first, bucketed by the
// pairs' floor(log2). Block b of the raster grid takes slice b % S of tile
// desc[b / S], so the longest tiles start in the first wave, and a block
// finds its tile and its ranges in one dependent load instead of the tile id
// and then its offsets. Any order gives the same pixels.
constexpr int ORDER_THREADS = 1024;
// A tile with no fine pairs and at most this many coarse and spill pairs
// has their bboxes tested against its pixels by the order pass.
constexpr int TOUCH_SCAN = 32;

__device__ __forceinline__ TileDesc tile_desc(const int32_t* __restrict__ off, int t, int ntx,
                                              int nty) {
  const int ntiles = ntx * nty, ntxc = (ntx + COARSE - 1) / COARSE;
  const int c = ntiles + (t / ntx / COARSE) * ntxc + (t % ntx) / COARSE;
  const int s = ntiles + ntxc * ((nty + COARSE - 1) / COARSE);
  TileDesc d;
  d.t = t;
  d.starts[0] = off[t], d.starts[1] = off[c], d.starts[2] = off[s];
  d.len0 = off[t + 1] - d.starts[0];
  d.len01 = d.len0 + off[c + 1] - d.starts[1];
  d.total = d.len01 + off[s + 1] - d.starts[2];
  d.pad = 0;
  return d;
}

// Whether any pair of tile d's list may cover one of its pixels. Fine
// pairs reach their tile by the binning; the coarse and spill pairs of a
// tile with no fine pairs, at most TOUCH_SCAN of them, have their bboxes
// tested against the tile (an accepted pixel lies in its pair's bbox).
// A tile that none reaches is background: the order pass empties its list,
// so its raster blocks stage nothing.
__device__ __forceinline__ bool reached(const TileDesc& d, const int32_t* __restrict__ tri_i32,
                                        size_t np, int ntx, int th) {
  if (d.len0 != 0 || d.total > TOUCH_SCAN) return true;
  const int x0 = (d.t % ntx) * TW, y0 = (d.t / ntx) * th;
  bool any = false;
#pragma unroll 8
  for (int v = 0; v < d.total; ++v) {  // independent loads: no early exit
    const int pair = v < d.len01 ? d.starts[1] + v : d.starts[2] + (v - d.len01);
    const int mn = __ldg(tri_i32 + MINXY * np + pair), mx = __ldg(tri_i32 + MAXXY * np + pair);
    any |= (mn & 0xFFFF) < x0 + TW && (mx & 0xFFFF) > x0 && (mn >> 16) < y0 + th &&
           (mx >> 16) > y0;
  }
  return any;
}

// The bucket of a tile: floor(log2) of the pairs in its fine and coarse
// ranges, 0 for none.
__device__ __forceinline__ int tile_weight(const TileDesc& d) {
  return d.len01 > 0 ? 32 - __clz(d.len01) : 0;  // 0 .. 32
}

// atomicAdd(&slot[w], 1) for each active lane, one atomic per distinct w
// in the warp (most tiles share a bucket) → the lane's position.
__device__ __forceinline__ int bucket_add(int* slot, int w, bool active) {
  const unsigned act = __ballot_sync(0xFFFFFFFFu, active);
  if (!active) return 0;
  const unsigned peers = __match_any_sync(act, w);
  const int leader = __ffs(peers) - 1, lane = threadIdx.x & 31;
  int base = 0;
  if (lane == leader) base = atomicAdd(&slot[w], __popc(peers));
  return __shfl_sync(peers, base, leader) + __popc(peers & ((1u << lane) - 1u));
}

static __global__ void __launch_bounds__(ORDER_THREADS)
tile_order_kernel(const int32_t* __restrict__ off, const int32_t* __restrict__ tri_i32, size_t np,
                  int ntx, int nty, int th, TileDesc* __restrict__ desc) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);  // the raster grid may start
  __shared__ int slot[33];
  const int ntiles = ntx * nty;
  if (threadIdx.x < 33) slot[threadIdx.x] = 0;
  __syncthreads();
  uint32_t unreached = 0;  // bit i: this thread's tile of round i (the first 32 rounds)
  // whole warps in every round: bucket_add synchronises them
  for (int t0 = 0, i = 0; t0 < ntiles; t0 += ORDER_THREADS, ++i) {
    const int t = t0 + threadIdx.x;
    const TileDesc d = tile_desc(off, t < ntiles ? t : 0, ntx, nty);
    if (t < ntiles && i < 32 && !reached(d, tri_i32, np, ntx, th)) unreached |= 1u << i;
    bucket_add(slot, tile_weight(d), t < ntiles);
  }
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
  for (int t0 = 0, i = 0; t0 < ntiles; t0 += ORDER_THREADS, ++i) {
    const int t = t0 + threadIdx.x;
    TileDesc d = tile_desc(off, t < ntiles ? t : 0, ntx, nty);
    const int at = bucket_add(slot, tile_weight(d), t < ntiles);
    if (i < 32 && (unreached >> i) & 1u) d.len01 = d.total = 0;  // an emptied tile keeps its place
    if (t < ntiles) desc[at] = d;
  }
}

// Launch a raster kernel, ntiles * S blocks, behind tile_order_kernel on the
// same stream with programmatic stream serialization: its blocks start while
// the order pass runs and wait for it (griddepcontrol.wait in tile_slot).
template <typename... Params, typename... Args>
cudaError_t launch_after_order(void (*kernel)(Params...), int th, int ntx, int nty,
                               const int32_t* off, const int32_t* tri_i32, int n_pairs,
                               TileDesc* desc, cudaStream_t stream, Args... args) {
  tile_order_kernel<<<1, ORDER_THREADS, 0, stream>>>(off, tri_i32, (size_t)n_pairs, ntx, nty, th,
                                                     desc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntx * nty * blocks_per_tile(th));
  cfg.blockDim = dim3(TW, TY);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
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

// A tile whose fine and coarse ranges hold at least this many pairs keeps
// its rows interleaved over its blocks (below).
constexpr int HEAVY_PAIRS = 256;
// A warp's patch: PATCH_W columns, PATCH_ROWS rows in each row step.
constexpr int PATCH_W = 8, PATCH_ROWS = 32 / PATCH_W;

// Where this block's thread sits: block b is slice s = b % S of tile
// desc[b / S]; the thread owns column cx and rows row0 + step * r, r < RT.
// Two layouts, by the tile's pairs:
//  - patches (most tiles): slice s is the tile's rows [s TY RT, (s + 1) TY
//    RT), and each warp a patch of PATCH_W columns of them, lane l at
//    column l % PATCH_W, rows l / PATCH_W + PATCH_ROWS r. A small triangle
//    touches few warps, and fills more of each warp's lanes;
//  - interleaved rows (a tile of at least HEAVY_PAIRS pairs, the sphere's
//    pole at phong1080): slice s takes rows s, s + S, ..., each warp 32
//    columns of two rows TY S apart, so a small triangle's rows fall to
//    several warps of several blocks (on several SMs), and the tile that is
//    the kernel's longest chain of pairs is cut short.
struct TileSlot {
  TileDesc d;
  int cx, row0, step;
  bool patch;
};

__device__ __forceinline__ TileSlot tile_slot(int th, int ntx, const TileDesc* desc) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // tile_order_kernel's desc
  const int S = blocks_per_tile(th);
  TileSlot at;
  at.d = desc[blockIdx.x / S];
  const int s = blockIdx.x % S, tid = (int)threadIdx.y * TW + (int)threadIdx.x;
  const int x0 = (at.d.t % ntx) * TW, y0 = (at.d.t / ntx) * th;
  at.patch = at.d.len01 < HEAVY_PAIRS;
  if (at.patch) {
    const int lane = tid & 31, warp = tid >> 5, across = TW / PATCH_W, rt = rows_per_thread(th);
    at.cx = x0 + PATCH_W * (warp % across) + lane % PATCH_W;
    at.row0 = y0 + s * TY * rt + (warp / across) * PATCH_ROWS * rt + lane / PATCH_W;
    at.step = PATCH_ROWS;
  } else {
    at.cx = x0 + (int)threadIdx.x;
    at.row0 = y0 + s + S * (int)threadIdx.y;
    at.step = TY * S;
  }
  return at;
}

// Walk the tile of slot ``at`` and leave, for each of the thread's R pixels
// (column at.cx, rows at.row0 + at.step * r), the winning depth (0 if none)
// and pair column (-1 if none). Every thread of the block must call it (it
// synchronises the block).
template <int R>
__device__ __forceinline__ void raster_tile(const int32_t* __restrict__ tri_i32,
                                            const float* __restrict__ tri_f32, size_t np,
                                            const TileSlot& at, float (&dep)[R], int (&wpair)[R]) {
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
  // the warp's pixels: columns [wx0, wx0 + wcols), and in row step r the
  // rows [wrow0 + step * r, wrow0 + step * r + wspan)
  const int wx0 = cx - (at.patch ? lane % PATCH_W : lane), wcols = at.patch ? PATCH_W : 32;
  const int wrow0 = row0 - (at.patch ? lane / PATCH_W : 0), wspan = at.patch ? PATCH_ROWS : 1;
  const TileDesc& d = at.d;
  const int total = d.total;
  const int nchunks = (total + CHUNK - 1) / CHUNK;

  if (nchunks > 0) {
    stage_chunk(s_rec[0], 0, min(CHUNK, total), d.starts, d.len0, d.len01, tri_i32, tri_f32, np,
                tid);
  }
  for (int ci = 0; ci < nchunks; ++ci) {
    if (ci + 1 < nchunks) {
      const int v1 = (ci + 1) * CHUNK;
      stage_chunk(s_rec[(ci + 1) & 1], v1, min(CHUNK, total - v1), d.starts, d.len0, d.len01,
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
        for (int r = 0; r < R; ++r) {
          rows |= wrow0 + step * r < maxy && wrow0 + step * r + wspan > miny;
        }
        touch = rows && (mn & 0xFFFF) < wx0 + wcols && (mx & 0xFFFF) > wx0;
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
__device__ __forceinline__ void weights_of(const float (&f)[9], float pcx, float pcy, float d,
                                           float& c0, float& c1, float& c2) {
  const float s0x = f[S0X] - pcx, s0y = f[S0Y] - pcy;
  const float s1x = f[S1X] - pcx, s1y = f[S1Y] - pcy;
  const float s2x = f[S2X] - pcx, s2y = f[S2Y] - pcy;
  const float a = fabsf(s1x * s2y - s1y * s2x);
  const float b = fabsf(s2x * s0y - s2y * s0x);
  const float c = fabsf(s0x * s1y - s0y * s1x);
  const float inv_s = 1.0f / ((a + b) + c);
  const float w_corr = 1.0f / (d != 0.0f ? d : 1.0f);
  c0 = (f[RHW0] * (a * inv_s)) * w_corr;
  c1 = (f[RHW1] * (b * inv_s)) * w_corr;
  c2 = (f[RHW2] * (c * inv_s)) * w_corr;
}

// The rows S0X..RHW2 of pair column ``pair``, the inputs of the weights.
__device__ __forceinline__ void load_fields(const float* __restrict__ tri_f32, size_t np, int pair,
                                            float (&f)[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = __ldg(tri_f32 + k * np + pair);
}

__device__ __forceinline__ void interp_weights(const float* __restrict__ tri_f32, size_t np,
                                               int pair, float pcx, float pcy, float d,
                                               float& c0, float& c1, float& c2) {
  float f[9];
  load_fields(tri_f32, np, pair, f);
  weights_of(f, pcx, pcy, d, c0, c1, c2);
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
