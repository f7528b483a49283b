// The per-tile raster loop shared by the fused kernel (K1, fused_raster.cu)
// and the non-fused raster kernel (K4, raster_planes.cu). A (th, 128) bin
// tile is shared by S = th / (4 RT) thread blocks of 128 x 4 threads; each
// thread owns RT rows (RT = 2, or 1 at th = 4) of one pixel column: each
// warp an 8-column patch of 4 RT rows, or, in an outlier tile, 32 columns
// of RT rows interleaved over the tile (tile_slot).
//
// Over the tile's own fine pair range and the coarse and spill pairs that
// reach it, it computes, per pixel: affine int32 edges (wrapped: computed
// in uint32), e12 = area2 - e01 - e20, the sign-OR cover test against the
// exclusive bbox max, |cross| barycentrics with an s != 0 guard, rhw, and
// the strict (rhw, order) maximum, recording the winning pair. The grid may
// cover a rectangle of the frame (a row slab of a sharded frame) whose
// top-left pixel is (oy, ox): every test, the bbox culling and the pixel
// centres use frame coordinates, so a slab is bit-equal to the crop of the
// whole frame; only the kernels' stores subtract the origin. The origin is
// a compile-time flag (kOrigin) of the plan pass and of both kernels: at
// (0, 0) they compile to code without it, since the two live values it adds
// cost K4 2% on an H100 (PERF.md). This is the loop of
// f_renderer_tpu/pipeline/raster_pallas.py:_make_kernel (the tri_body at
// :773-889); its plain version is pipeline/raster.py:raster_tiles_plain
// (the plan: raster.tile_plan_plain). With --fmad=false and IEEE division
// the results match the plain version to the bit.
//
// What bounds it on the card: a block's latency. Two blocks fit an SM
// (<= 64 registers), and a per-block trace of K4 at phong1080 (%globaltimer,
// tools/k4_trace.py) showed all 264 resident slots busy for the whole
// kernel: its time is the sum of its blocks' latencies over 264, not bytes
// or issue. That sum is the pair records each block stages and ballots, the
// (pair, pixel) work inside each pair's bbox as latency-bound chains on the
// warps whose pixels the pairs touch, the prologue (its tile, then its first
// chunk) and the epilogue; the heaviest tiles' chains can be the critical
// path as well. At stress4k (a million small triangles, 1,020 tiles of 64
// rows) whole lists and a fixed threshold for rows (256 pairs) spent 1.79
// of K1's 4.20 ms staging and balloting pairs that could not reach the
// block, and walked 460 tiles in rows interleaved (tools/k1_split.py,
// PERF.md). The design:
//  - the plan pass (tile_plan_kernel, one block a tile) places each tile in
//    the raster grid's order, heaviest first, chooses its layout, and culls
//    its coarse and spill ranges to the pairs whose bbox meets the tile,
//    copying their records into the plan; the raster grid starts behind it
//    by programmatic dependent launch, and a block finds its tile, ranges
//    and layout in one dependent load;
//  - the warps' pixel layout (tile_slot): 8 x 8 patches, where a small
//    triangle touches fewer warps and fills more lanes than a 32-pixel row;
//    rows interleaved over the blocks only in an outlier tile whose blocks
//    would bound the kernel (the sphere's poles at phong1080), so no warp
//    there carries a long chain; each layout a compile-time walk;
//  - in a tile of patches longer than a chunk, each block walks only the
//    pairs whose bbox rows meet its own (select_rows): 0.28 of the records
//    at stress4k;
//  - warp-level bbox culling: the 32 lanes of a warp test 32 staged pairs'
//    bboxes [MINXY, MAXXY) against the warp's columns and rows at once, and
//    the warp walks only the pairs of the ballot, skipping its rows outside
//    [min_y, max_y). Every cut (tile, block, warp, row) is exact because
//    every pixel the cover test accepts lies inside its pair's bbox (the
//    edges bound it from below, MAXXY from above; tests/test_torch_raster.py
//    pins it), and the merge does not depend on the order of the pairs;
//  - the list is staged in chunks of 128 pair records of 80 bytes (read as
//    five 16-byte broadcasts) by 4-byte cp.async copies into two buffers,
//    so chunk i + 1 loads while chunk i runs (three buffers read no faster);
//  - each pixel carries only (depth, pair): the winner's order, needed on
//    an exact rhw tie alone, is read back from device memory then;
//  - in K1 an early depth test (kDepthTest): a pair's rhw at any pixel is at
//    most its reach, a bound from its three vertices' rhw, so a pixel whose
//    depth already passes the reach skips the pair's cover test and depth,
//    and a warp leaves the pair out of its ballot (no visit) where, in each
//    row step the pair's bbox rows meet, every pixel's depth passes it. At
//    stress4k, where a pixel is covered by ~20 pairs in list order, most of
//    the visits and depths fall away (K1 1.43 -> 0.89 ms on an H100,
//    PERF.md §6).
// Measured slower and dropped (PERF.md): a persistent grid taking slots
// from an atomic ticket, or statically; heaviest and lightest tiles in
// turn; the heaviest tiles' lists cut into parts over more blocks, folded
// by the last part; a separate cull pass ahead of a one-block order pass
// (its blocks held the SMs the raster grid waits on); culled lists read
// through a column index; a runtime layout inside the walk.
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
// A pair's reach: its rhw at any pixel is a sum of its three vertices' rhw
// times weights that sum to 1 within 7 roundings, so at most RHW_SLACK
// times the largest of them (or 0), plus RHW_FLOOR for roundings among
// subnormals. (A pixel centre is k + 0.5, k >= 0: a nonzero difference from
// it is at least 2^-25 and a nonzero |cross| at least 2^-73, so 1 / s is
// finite and no weight is +inf.) A pixel already deeper than the reach (a
// larger rhw) cannot take the pair, which merge() takes only at an rhw at
// least the pixel's (tests/test_torch_k1_layout.py pins the bound).
constexpr float RHW_SLACK = 1.000001f;        // 1 + 2^-20 > (1 + 2^-24)^8
constexpr float RHW_FLOOR = 1.17549435e-38f;  // the least normal float
// A staged pair record, 20 words: the 8 int32 rows A01..ORDER, MAXXY, the 9
// float rows S0X..RHW2, the pair's column, MINXY.
constexpr int REC = 20, REC_MAXXY = 8, REC_F = 9, REC_PAIR = 18, REC_MINXY = 19;

constexpr int RT_MAX = 2;   // rows per thread (1 at th = 4)

// Rows per thread and blocks per tile for tile height th.
__host__ __device__ constexpr int rows_per_thread(int th) { return th < TY * RT_MAX ? 1 : RT_MAX; }
__host__ __device__ constexpr int blocks_per_tile(int th) { return th / (TY * rows_per_thread(th)); }

// A tile's pair list as the raster blocks walk it: its fine range, then its
// coarse and spill ranges, pairs v = 0 .. total - 1 in that order. Fine pair
// v < len0 is column starts[0] + v. A culled tile (TILE_CULLED, the rule)
// has no coarse range (len01 = len0): its pairs v >= len0 are the coarse and
// spill pairs whose bbox meets the tile (tile_plan_kernel), whose staged
// records the plan pass wrote to the plan, field f of pair v at word
// starts[2] + f * starts[1] + v - len0 of its record area. A tile whose
// culled list would overflow (TILE_OVERFLOW) keeps both ranges whole: coarse
// pair v < len01 is column starts[1] + v - len0, spill pair v >= len01
// column starts[2] + v - len01. TILE_ROWS: the tile's rows are interleaved
// over its blocks (tile_slot). Eight words, one 32-byte sector, so a block
// reads its tile in one load.
constexpr int TILE_ROWS = 1, TILE_CULLED = 2, TILE_OVERFLOW = 4;
struct __align__(16) TileDesc {
  int t, len0, len01, total;
  int starts[3], flags;
};

// The tile plan, in one int32 scratch buffer of ntiles * (9 + REC * cap)
// words: the descriptors (8 words a tile, in the order the raster grid takes
// the tiles), each tile's count of culled pairs, then each tile's record
// area, the staged records of its first cap culled pairs field by field
// (REC rows of cap words).
__host__ __device__ constexpr size_t plan_counts(int ntiles) { return (size_t)ntiles * 8; }
__host__ __device__ constexpr size_t plan_records(int ntiles) { return (size_t)ntiles * 9; }

// Whether the bbox [mn, mx) (packed x | y << 16, frame pixels) meets the
// rectangle [x0, x0 + TW) x [y0, y0 + th).
__device__ __forceinline__ bool bbox_meets(int mn, int mx, int x0, int y0, int th) {
  return (mn & 0xFFFF) < x0 + TW && (mx & 0xFFFF) > x0 && (mn >> 16) < y0 + th && (mx >> 16) > y0;
}

// The plan pass, one block a tile, no block waiting for another: block t
// writes tile t's descriptor at its place in the raster grid's order and
// culls tile t's coarse and spill ranges.
//
// The order: the tiles with the most pairs in their fine range first,
// bucketed by floor(log2), in tile order within a bucket; block b of the
// raster grid takes slice b % S of the tile whose descriptor is b / S, so
// the longest tiles start in the first wave, and a block finds its tile,
// its ranges and its layout in one dependent load. Every block reads every
// tile's fine count (ntiles words, once a block) to find its tile's place.
// Any order and any layout give the same pixels.
//
// The layout: rows interleaved (TILE_ROWS) in an outlier, a tile of w fine
// pairs that holds at least four times the mean of the frame's n tiles with
// fine pairs, w * n >= 4 * W (W the sum of every tile's w), and whose blocks
// would bound the kernel, one block's share of it outweighing twice a
// resident slot's share of the frame, w * slots >= 2 * S * W (slots the
// raster blocks the card holds at once); patches everywhere else. A tile of
// many small triangles takes patches: in rows its blocks' chains are ~1.9x
// longer (stress4k, and the tiles of a small frame of such triangles that
// bound the kernel); an outlier is a place where triangles converge, such
// as the sphere's pole, whose busiest patch would walk nearly all of its
// pairs. It takes phong1080's two pole tiles (557 and 519 fine pairs; a
// fixed threshold of 256 pairs takes the same) and no tile of stress4k
// (5,685 against a threshold of 10,659) (tools/raster_model.py).
//
// The cull: the coarse and spill pairs whose bbox meets the tile, in list
// order, the staged records of the first cap of them to the tile's record
// area. Exact: every pixel the cover test accepts lies inside its pair's
// bbox (tests/test_torch_raster.py pins it). At stress4k it keeps 84,380 of
// the 478,480 coarse entries and 6,204 of the 1,582,020 spill entries of the
// tiles' lists (tools/raster_model.py), which every block of every tile
// staged and balloted before. A tile with more than cap keeps both ranges
// whole (TILE_OVERFLOW). The pass copies the kept records, so the raster
// blocks stage them as they stage a range, with no dependent load of a pair
// column (which cost K1 0.093 ms at stress4k on an H100: PERF.md); a list of
// at most PLAN_ROUND pairs loads every record with its bbox. A tile that
// no pair reaches (no fine pair, none culled) gets an empty list: its blocks
// write the background and stage nothing.
// Blocks of 64 threads, each testing two pairs a round, in 64 registers:
// the raster grid's blocks (launched behind the pass) find room on the SMs
// beside them and start the moment the pass ends (256-thread blocks, or
// four pairs a thread in 128 registers, left less and cost K1 up to 0.003
// ms at phong1080 on an H100: PERF.md).
constexpr int PLAN_THREADS = 64, PLAN_PAIRS = 2;
constexpr int PLAN_ROUND = PLAN_THREADS * PLAN_PAIRS;

template <bool kOrigin>
static __global__ void __launch_bounds__(PLAN_THREADS)
tile_plan_kernel(const int32_t* __restrict__ off, const int32_t* __restrict__ tri_i32,
                 const float* __restrict__ tri_f32, size_t np, int ntx, int nty, int th,
                 int origin_y, int origin_x, int cap, int slots, int32_t* __restrict__ plan) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);  // the raster grid may start, and waits
  const int oy = kOrigin ? origin_y : 0, ox = kOrigin ? origin_x : 0;
  constexpr int WARPS = PLAN_THREADS / 32;
  __shared__ int heavier, before_t, warp_kept[PLAN_PAIRS][WARPS];
  __shared__ unsigned long long frame_pairs, frame_tiles;
  const int t = (int)blockIdx.x, ntiles = ntx * nty;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntxc = (ntx + COARSE - 1) / COARSE;
  const int c = ntiles + (t / ntx / COARSE) * ntxc + (t % ntx) / COARSE;
  const int s = ntiles + ntxc * ((nty + COARSE - 1) / COARSE);
  const int f0 = off[t], w = off[t + 1] - f0;
  const int c0 = off[c], nc = off[c + 1] - c0, s0 = off[s], n = nc + off[s + 1] - s0;
  const int bucket = w > 0 ? 32 - __clz(w) : 0;
  if (threadIdx.x == 0) heavier = before_t = 0, frame_pairs = frame_tiles = 0;
  __syncthreads();
  // every tile's bucket: the tiles in heavier buckets, those of t's bucket
  // before t, W and n
  {
    int k_heavier = 0, k_before = 0;
    unsigned long long sum = 0, tiles = 0;
#pragma unroll 4
    for (int u = threadIdx.x; u < ntiles; u += PLAN_THREADS) {
      const int wu = off[u + 1] - off[u], bu = wu > 0 ? 32 - __clz(wu) : 0;
      k_heavier += bu > bucket;
      k_before += bu == bucket && u < t;
      sum += (unsigned long long)wu;
      tiles += wu > 0;
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) {
      k_heavier += __shfl_xor_sync(0xFFFFFFFFu, k_heavier, k);
      k_before += __shfl_xor_sync(0xFFFFFFFFu, k_before, k);
      sum += __shfl_xor_sync(0xFFFFFFFFu, sum, k);
      tiles += __shfl_xor_sync(0xFFFFFFFFu, tiles, k);
    }
    if (lane == 0) {
      atomicAdd(&heavier, k_heavier);
      atomicAdd(&before_t, k_before);
      atomicAdd(&frame_pairs, sum);
      atomicAdd(&frame_tiles, tiles);
    }
  }
  // the cull, PLAN_PAIRS pairs a thread a round: pair v0 + k PLAN_THREADS + tid
  const bool one_round = n <= PLAN_ROUND;  // block-uniform
  const int x0 = ox + (t % ntx) * TW, y0 = oy + (t / ntx) * th;  // frame coordinates, as the bboxes
  const int32_t* f32 = reinterpret_cast<const int32_t*>(tri_f32);
  int32_t* out = plan + plan_records(ntiles) + (size_t)t * REC * cap;
  int kept = 0;  // block-uniform
  for (int v0 = 0; v0 < n; v0 += PLAN_ROUND) {
    int r[PLAN_PAIRS][REC];
    bool keep[PLAN_PAIRS];
#pragma unroll
    for (int k = 0; k < PLAN_PAIRS; ++k) {
      const int v = v0 + k * PLAN_THREADS + (int)threadIdx.x;
      const int pair = v < nc ? c0 + v : s0 + (v - nc);
      r[k][REC_PAIR] = pair;
      r[k][REC_MINXY] = v < n ? __ldg(tri_i32 + MINXY * np + pair) : 0;
      r[k][REC_MAXXY] = v < n ? __ldg(tri_i32 + MAXXY * np + pair) : 0;
      if (one_round && v < n) {  // the whole record, with the bbox
#pragma unroll
        for (int f = 0; f < REC_MAXXY; ++f) r[k][f] = __ldg(tri_i32 + f * np + pair);
#pragma unroll
        for (int f = REC_F; f < REC_PAIR; ++f) r[k][f] = __ldg(f32 + (f - REC_F) * np + pair);
      }
    }
    uint32_t m[PLAN_PAIRS];
#pragma unroll
    for (int k = 0; k < PLAN_PAIRS; ++k) {
      const int v = v0 + k * PLAN_THREADS + (int)threadIdx.x;
      keep[k] = v < n && bbox_meets(r[k][REC_MINXY], r[k][REC_MAXXY], x0, y0, th);
      if (!one_round && keep[k]) {  // the rest of its record, in flight while the block compacts
        const int pair = r[k][REC_PAIR];
#pragma unroll
        for (int f = 0; f < REC_MAXXY; ++f) r[k][f] = __ldg(tri_i32 + f * np + pair);
#pragma unroll
        for (int f = REC_F; f < REC_PAIR; ++f) r[k][f] = __ldg(f32 + (f - REC_F) * np + pair);
      }
      m[k] = __ballot_sync(0xFFFFFFFFu, keep[k]);
      if (lane == 0) warp_kept[k][warp] = __popc(m[k]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PLAN_PAIRS; ++k) {
      int before = 0, all = 0;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) {
        before += q < warp ? warp_kept[k][q] : 0;
        all += warp_kept[k][q];
      }
      const int at = kept + before + __popc(m[k] & ((1u << lane) - 1u));
      if (keep[k] && at < cap) {
#pragma unroll
        for (int f = 0; f < REC; ++f) out[(size_t)f * cap + at] = r[k][f];
      }
      kept += all;
    }
    __syncthreads();  // warp_kept is rewritten in the next round
  }
  __syncthreads();  // the order's sums (an empty cull has no barrier)
  if (threadIdx.x != 0) return;
  plan[plan_counts(ntiles) + t] = kept;
  TileDesc d;
  d.t = t;
  d.starts[0] = f0;
  d.len0 = w;
  if (kept <= cap) {  // the fine range, then the culled records
    d.starts[1] = cap;
    d.starts[2] = t * REC * cap;
    d.len01 = w;
    d.total = w + kept;
    d.flags = TILE_CULLED;
  } else {  // the three ranges whole
    d.starts[1] = c0, d.starts[2] = s0;
    d.len01 = w + nc;
    d.total = w + n;
    d.flags = TILE_OVERFLOW;
  }
  const unsigned long long u = (unsigned long long)w, W = frame_pairs;
  if (u > 0 && u * frame_tiles >= 4ull * W &&
      u * (unsigned long long)slots >= 2ull * (unsigned long long)blocks_per_tile(th) * W) {
    d.flags |= TILE_ROWS;
  }
  reinterpret_cast<TileDesc*>(plan)[heavier + before_t] = d;
}

// Launch a raster kernel, ntiles * S blocks, behind the plan pass on the
// same stream by programmatic stream serialization: its blocks start while
// the plan pass runs and wait for it (griddepcontrol.wait in tile_slot).
// ``plan`` is the ntiles * (9 + REC * cap) word scratch.
template <bool kOrigin, typename... Params, typename... Args>
cudaError_t launch_after_plan(void (*kernel)(Params...), int th, int ntx, int nty, int oy, int ox,
                              const int32_t* off, const int32_t* tri_i32, const float* tri_f32,
                              int n_pairs, int32_t* plan, int cap, cudaStream_t stream,
                              Args... args) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ntiles = ntx * nty;
  tile_plan_kernel<kOrigin><<<ntiles, PLAN_THREADS, 0, stream>>>(
      off, tri_i32, tri_f32, (size_t)n_pairs, ntx, nty, th, oy, ox, cap,
      2 * sms,  // two raster blocks an SM (64 registers)
      plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntiles * blocks_per_tile(th));
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

// The column of the pair at position v of a tile's list (TileDesc), outside
// its culled records.
__device__ __forceinline__ int pair_at(const int (&starts)[3], int len0, int len01, int v) {
  return v < len0 ? starts[0] + v : v < len01 ? starts[1] + (v - len0) : starts[2] + (v - len01);
}

// Stage the pairs of items v0 .. v0 + n - 1 into rec[0 .. n - 1]: item i is
// position sel[i] of the tile's list (TileDesc), or position i where sel is
// null; ``recs`` is the plan's record areas where the tile is culled, else
// null; the copies are committed as one group.
__device__ __forceinline__ void stage_chunk(int32_t (*rec)[REC], int v0, int n, const int* sel,
                                            const int (&starts)[3], int len0, int len01,
                                            const int32_t* __restrict__ recs,
                                            const int32_t* __restrict__ tri_i32,
                                            const float* __restrict__ tri_f32, size_t np,
                                            int tid) {
  for (int e = tid; e < REC * CHUNK; e += TW * TY) {
    const int f = e / CHUNK, j = e % CHUNK;
    if (j >= n) continue;
    const int v = sel != nullptr ? sel[v0 + j] : v0 + j;
    if (v >= len01 && recs != nullptr) {  // a culled pair: its record as the plan pass wrote it
      cp_async4(&rec[j][f], recs + starts[2] + f * starts[1] + (v - len01));
      continue;
    }
    const int pair = pair_at(starts, len0, len01, v);
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

// The reach (RHW_SLACK) of a pair whose vertices' rhw are r0, r1, r2: never
// NaN, +inf where one of them is.
__device__ __forceinline__ float reach_of(float r0, float r1, float r2) {
  return fmaxf(fmaxf(fmaxf(r0, r1), r2), 0.0f) * RHW_SLACK + RHW_FLOOR;
}

// A staged pair record, unpacked for the pixel column cx.
struct Pair {
  uint32_t b01, b20, area2, ex01, ex20;  // ex = A * cx + C of the two edges
  int32_t xbits;                         // max_x - 1 - cx: negative past the bbox
  int order, miny, maxy, pair;
  float f0x, f0y, f1x, f1y, f2x, f2y, r0, r1, r2;
  float reach;  // reach_of(r0, r1, r2)
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
  p.reach = reach_of(p.r0, p.r1, p.r2);
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

// A warp's patch: PATCH_W columns, PATCH_ROWS rows in each row step.
constexpr int PATCH_W = 8, PATCH_ROWS = 32 / PATCH_W;

// Where this block's thread sits: block b is slice s = b % S of the tile
// whose descriptor is b / S in the plan; the thread owns column cx and rows
// row0 + step * r, r < RT, in frame coordinates (the grid's top-left pixel
// is the frame's (oy, ox); a kernel without kOrigin passes the constant 0).
// Two layouts, as the plan pass chose for the tile (TILE_ROWS):
//  - patches (most tiles): slice s is the tile's rows [s TY RT, (s + 1) TY
//    RT), and each warp a patch of PATCH_W columns of them, lane l at
//    column l % PATCH_W, rows l / PATCH_W + PATCH_ROWS r. A small triangle
//    touches few warps, and fills more of each warp's lanes;
//  - interleaved rows (a tile heavy enough to bound the kernel, such as
//    the sphere's pole at phong1080): slice s takes rows s, s + S, ...,
//    each warp 32 columns of two rows TY S apart, so a small triangle's rows
//    fall to several warps of several blocks (on several SMs), and the tile
//    that is the kernel's longest chain of pairs is cut short.
struct TileSlot {
  TileDesc d;
  const int32_t* recs;  // the plan's record areas where the tile is culled, else null
  int cx, row0, step;
  bool patch;
};

__device__ __forceinline__ TileSlot tile_slot(int th, int ntx, int nty, const int32_t* plan, int oy,
                                              int ox) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the plan pass's descriptors and records
  const int S = blocks_per_tile(th);
  TileSlot at;
  at.d = reinterpret_cast<const TileDesc*>(plan)[blockIdx.x / S];
  at.recs = (at.d.flags & TILE_CULLED) ? plan + plan_records(ntx * nty) : nullptr;
  const int s = blockIdx.x % S, tid = (int)threadIdx.y * TW + (int)threadIdx.x;
  const int x0 = ox + (at.d.t % ntx) * TW, y0 = oy + (at.d.t / ntx) * th;
  at.patch = (at.d.flags & TILE_ROWS) == 0;
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

// A warp's pixels for the ballot: columns [x0, x0 + cols), and in row step
// r the rows [row0 + step r, row0 + step r + span).
struct WarpRect {
  int x0, cols, row0, step, span;
};

// Walk items 0 .. count - 1 of the tile's list (item i: position sel[i],
// or i where sel is null) for the thread's R pixels (column cx, rows row0 +
// step r): the bbox ballot against the warp's rect, then each pair of the
// ballot, merged into dep / wpair. Double-buffered chunks of CHUNK records.
// kDepthTest: the early depth test, in the ballot against the least depth
// of the warp's pixels in each row step that the pair's bbox rows meet (a
// pair whose reach it passes covers nothing there that the warp would take)
// and at each pixel before its cover test.
template <int R, bool kDepthTest>
__device__ __forceinline__ void walk_items(int32_t (*s_rec)[CHUNK][REC], int count, const int* sel,
                                           const int32_t* __restrict__ tri_i32,
                                           const float* __restrict__ tri_f32, size_t np,
                                           const TileSlot& at, int step, const WarpRect& wr,
                                           float (&dep)[R], int (&wpair)[R]) {
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int cx = at.cx, row0 = at.row0;
  const float pcx = (float)cx + 0.5f;
  const TileDesc& d = at.d;
  const int nchunks = (count + CHUNK - 1) / CHUNK;

  if (nchunks > 0) {
    stage_chunk(s_rec[0], 0, min(CHUNK, count), sel, d.starts, d.len0, d.len01, at.recs, tri_i32,
                tri_f32, np, tid);
  }
  for (int ci = 0; ci < nchunks; ++ci) {
    if (ci + 1 < nchunks) {
      const int v1 = (ci + 1) * CHUNK;
      stage_chunk(s_rec[(ci + 1) & 1], v1, min(CHUNK, count - v1), sel, d.starts, d.len0, d.len01,
                  at.recs, tri_i32, tri_f32, np, tid);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk ci is in shared memory for every thread
    const int32_t (*rec)[REC] = s_rec[ci & 1];
    const int n = min(CHUNK, count - ci * CHUNK);
    for (int j0 = 0; j0 < n; j0 += 32) {
      // the least depth of the warp's pixels in each row step (depth >= +-0,
      // whose bits order as the values once the sign is cleared)
      float least[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t bits = __float_as_uint(dep[r]) & 0x7FFFFFFFu;
        least[r] = kDepthTest ? __uint_as_float(__reduce_min_sync(0xFFFFFFFFu, bits)) : 0.0f;
      }
      // lane l tests pair j0 + l's bbox against the warp's columns and rows
      bool touch = false;
      if (j0 + lane < n) {
        const int mn = rec[j0 + lane][REC_MINXY], mx = rec[j0 + lane][REC_MAXXY];
        const int miny = mn >> 16, maxy = mx >> 16;
        const float* f = reinterpret_cast<const float*>(rec[j0 + lane]) + REC_F;
        const float reach = kDepthTest ? reach_of(f[RHW0], f[RHW1], f[RHW2]) : 0.0f;
        bool rows = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          rows |= wr.row0 + wr.step * r < maxy && wr.row0 + wr.step * r + wr.span > miny &&
                  !(kDepthTest && least[r] > reach);
        }
        touch = rows && (mn & 0xFFFF) < wr.x0 + wr.cols && (mx & 0xFFFF) > wr.x0;
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
          if (kDepthTest && dep[r] > pr.reach) continue;  // the pixel is deeper than the pair can reach
          if (!covers(pr, cy)) continue;
          float rhw;
          if (depth_of(pr, pcx, (float)cy + 0.5f, rhw)) merge(rhw, pr, tri_i32, np, dep[r], wpair[r]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer ci & 1 before it is refilled
  }
}

// Positions seg0 .. seg0 + n - 1 (n <= SELECT) of the tile's list whose bbox
// rows meet [y0, y0 + rows), in order, to sel → their count. Every thread
// of the block must call it (it synchronises the block).
constexpr int SELECT = 4 * TW * TY;
__device__ __forceinline__ int select_rows(int* sel, int seg0, int n, const TileSlot& at, int y0,
                                           int rows, const int32_t* __restrict__ tri_i32,
                                           size_t np) {
  constexpr int WARPS = TW * TY / 32, K = SELECT / (TW * TY);
  __shared__ int warp_kept[K][WARPS];
  const int tid = threadIdx.y * TW + threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TileDesc& d = at.d;
  bool keep[K];
  uint32_t m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {  // every bbox first, then the ballots
    const int i = k * TW * TY + tid, v = seg0 + i;
    int mn = 0, mx = 0;
    if (i < n) {
      if (v >= d.len01 && at.recs != nullptr) {
        const int32_t* q = at.recs + d.starts[2] + (v - d.len01);
        mn = __ldg(q + REC_MINXY * d.starts[1]), mx = __ldg(q + REC_MAXXY * d.starts[1]);
      } else {
        const int pair = pair_at(d.starts, d.len0, d.len01, v);
        mn = __ldg(tri_i32 + MINXY * np + pair), mx = __ldg(tri_i32 + MAXXY * np + pair);
      }
    }
    keep[k] = i < n && (mn >> 16) < y0 + rows && (mx >> 16) > y0;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    m[k] = __ballot_sync(0xFFFFFFFFu, keep[k]);
    if (lane == 0) warp_kept[k][warp] = __popc(m[k]);
  }
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int before = 0, all = 0;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) {
      before += q < warp ? warp_kept[k][q] : 0;
      all += warp_kept[k][q];
    }
    const int at = count + before + __popc(m[k] & ((1u << lane) - 1u));
    if (keep[k]) sel[at] = seg0 + k * TW * TY + tid;
    count += all;
  }
  __syncthreads();  // sel is whole, and warp_kept free for the next call
  return count;
}

// walk_tile for one layout (kPatch: patches, else rows interleaved), its
// warp rects and row step compile-time where the layout fixes them: a
// runtime layout in the loop cost K1 5% at stress4k and 0.0025 ms at
// phong1080 on an H100 (PERF.md). A tile of patches longer than a chunk is
// walked a segment of SELECT positions at a time, each cut first to the
// pairs whose bbox rows meet the block's (exact, as the warps' ballot):
// the blocks of a tile split its rows, and a small triangle's rows fall to
// few of them (at stress4k 28% of the fine pairs' (pair, block) couples
// meet, tools/raster_model.py), so each block stages and ballots about a
// third of the list.
template <int R, bool kPatch, bool kDepthTest>
__device__ __forceinline__ void walk_tile(int32_t (*s_rec)[CHUNK][REC], int* s_sel,
                                          const int32_t* __restrict__ tri_i32,
                                          const float* __restrict__ tri_f32, size_t np,
                                          const TileSlot& at, float (&dep)[R], int (&wpair)[R]) {
  const int lane = threadIdx.x & 31;
  const int step = kPatch ? PATCH_ROWS : at.step;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dep[r] = 0.0f;
    wpair[r] = -1;
  }
  WarpRect wr;
  wr.x0 = at.cx - (kPatch ? lane % PATCH_W : lane);
  wr.cols = kPatch ? PATCH_W : 32;
  wr.row0 = at.row0 - (kPatch ? lane / PATCH_W : 0);
  wr.step = step;
  wr.span = kPatch ? PATCH_ROWS : 1;
  const int total = at.d.total;
  if (!kPatch || total <= CHUNK) {
    walk_items<R, kDepthTest>(s_rec, total, nullptr, tri_i32, tri_f32, np, at, step, wr, dep, wpair);
    return;
  }
  // every warp of a block of patches holds the same rows: the block's
  static_assert(TW / PATCH_W == TW * TY / 32, "a block of patches is one band of rows");
  for (int seg0 = 0; seg0 < total; seg0 += SELECT) {
    const int count = select_rows(s_sel, seg0, min(SELECT, total - seg0), at, wr.row0,
                                  PATCH_ROWS * R, tri_i32, np);
    walk_items<R, kDepthTest>(s_rec, count, s_sel, tri_i32, tri_f32, np, at, step, wr, dep, wpair);
  }
}

// Walk the tile of slot ``at`` and leave, for each of the thread's R pixels
// (column at.cx, rows at.row0 + at.step * r), the winning depth (0 if none)
// and pair column (-1 if none). Every thread of the block must call it (it
// synchronises the block). kDepthTest: the early depth test (walk_items), in
// K1 only: K4 keeps the loop as it was.
template <int R, bool kDepthTest>
__device__ __forceinline__ void raster_tile(const int32_t* __restrict__ tri_i32,
                                            const float* __restrict__ tri_f32, size_t np,
                                            const TileSlot& at, float (&dep)[R], int (&wpair)[R]) {
  __shared__ __align__(16) int32_t s_rec[2][CHUNK][REC];
  __shared__ int s_sel[SELECT];
  if (at.patch) {
    walk_tile<R, true, kDepthTest>(s_rec, s_sel, tri_i32, tri_f32, np, at, dep, wpair);
  } else {
    walk_tile<R, false, kDepthTest>(s_rec, s_sel, tri_i32, tri_f32, np, at, dep, wpair);
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
