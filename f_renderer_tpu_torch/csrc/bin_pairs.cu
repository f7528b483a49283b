// Binning and pair gather: the packed set-up columns sorted into per-tile
// pair lists, as a counting sort, and gathered into pair order.
//
// Replaces no Pallas kernel but XLA's fusions of the JAX package's binning
// and pair-order gather: raster_pallas.py:319 bin_pairs (the (tile,
// triangle) pair keys of the fine, coarse and spill levels, their sort and
// the searchsorted offsets) and fused.py:160 _pair_gather /
// fused.py:183 prep_fused_packed (every packed row gathered in pair order).
// The port ran them as some hundred PyTorch ops (torch.sort included) a
// frame. The plain version is pipeline/raster.py:bin_packed on CPU tensors
// (bin_pairs + two index_select); where it takes the packed 31-bit sort its
// offsets and pair columns equal the kernels' bit for bit, since both order
// the pairs by (key, slot). Where it takes the stable two-operand sort (keys
// past 31 bits) its pairs within a key follow the key slot j instead: the
// offsets are equal and each key's list is a permutation of the plain one
// (the raster's per-pixel (rhw, order) merge does not depend on the order).
//
// The keys are few (ntiles + ntilesc + 1: 548 at phong1080, 1,094 at
// stress4k), so the sort counts. A stripe of consecutive slots is one
// warp's:
//   bin_count_kernel    a warp counts its stripe's pairs per key into
//                       counts[key][stripe] (zeroed by a memset before);
//   bin_scan_kernel     a block a key: the exclusive scan of its counts over
//                       the stripes (in place) and its total;
//   bin_offsets_kernel  one block: off, the exclusive scan of the totals;
//   bin_pairs_kernel    a warp walks its stripe 32 slots at a time, in slot
//                       order; a pair's place is off[key] + counts[key]
//                       [stripe] + the pairs of that key of earlier lanes
//                       (a hash table of the chunk's keys in shared memory,
//                       each entry the lanes that hold the key), then each
//                       key's count moves on: deterministic and stable;
//   bin_records_kernel  the packed rows as one record a slot (its 12 + 9 +
//                       3C words, padded to whole 32-byte sectors), 32
//                       slots a block through shared memory;
//   bin_gather_kernel   128 pair columns a block: their slots' records
//                       (m_dummy's past the last pair) staged in shared
//                       memory by 16-byte loads, then written out row by
//                       row, each row's 128 words at once.
//
// What bounds it on the card: bytes. It reads the packed arrays once
// (180 B a slot at C = 8) and writes the pair-order arrays (180 B a pair
// column, padding columns included): ~546 MB at stress4k, 0.163 ms at
// 3.35 TB/s. The counting passes touch 8 B a slot and 4 B a counter. The
// gather's reads are the hard part: a tile's slots lie far apart (a soup's
// triangles at stress4k), and a pair's words sit in 45 rows, so a gather
// straight from the rows reads a 32-byte sector for every word: 57 M
// sectors at stress4k, past the L2 when a thread copies a whole column
// (1.52 ms on an H100), and still 0.58 ms row by row with the row held in
// L2. Records turn a pair's 45 scattered words into 6 whole sectors, for
// one more pass over the packed arrays (read and written once, coalesced).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;  // bin tile width
constexpr int kCoarse = 4;   // a coarse tile is kCoarse x kCoarse fine tiles
constexpr int MINXY = 8, MAXXY = 9, NF_I = 12;
constexpr int kChunk = 64;         // record words a block stages at a time
constexpr int kRecSlots = 32;      // slots a block of the record pass transposes
constexpr int kGatherCols = 128;   // pair columns a block of the gather writes

// Words of a slot's record: its rows, padded to whole 32-byte sectors.
__host__ __device__ __forceinline__ int rec_words(const FrBinParams& p) { return (NF_I + p.rows_f + 7) / 8 * 8; }

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// A slot's pair keys: key j < n is offset + (y0 + j / ncols) * stride + x0 + j % ncols.
struct Keys {
  int offset, y0, x0, ncols, stride, n;
  __device__ __forceinline__ int operator()(int j) const { return offset + (y0 + j / ncols) * stride + x0 + j % ncols; }
};

// raster.bin_pairs' levels for slot s: its span of fine tiles if at most
// k, else of coarse tiles if at most kc, else the spill key; none where the
// bbox, shifted by the origin and clamped to the grid, is empty.
__device__ __forceinline__ Keys slot_keys(const FrBinParams& p, const int32_t* __restrict__ ti, int s) {
  const int lo = __ldg(ti + (size_t)MINXY * p.m + s), hi = __ldg(ti + (size_t)MAXXY * p.m + s);
  const int gw = p.ntx * kLanes, gh = p.nty * p.th;
  const int minx = clampi((lo & 0xFFFF) - p.ox, 0, gw), maxx = clampi((hi & 0xFFFF) - p.ox, 0, gw);
  const int miny = clampi((lo >> 16) - p.oy, 0, gh), maxy = clampi((hi >> 16) - p.oy, 0, gh);
  if (!(maxx > minx && maxy > miny)) return {0, 0, 0, 1, 0, 0};
  const int tx0 = minx / kLanes, tx1 = max(maxx - 1, minx) / kLanes;
  const int ty0 = miny / p.th, ty1 = max(maxy - 1, miny) / p.th;
  const int ncols = tx1 - tx0 + 1, span = ncols * (ty1 - ty0 + 1);
  if (span <= p.k) return {0, ty0, tx0, ncols, p.ntx, span};
  const int ntiles = p.ntx * p.nty, ntxc = cdiv(p.ntx, kCoarse);
  const int cx0 = tx0 / kCoarse, cy0 = ty0 / kCoarse;
  const int ncolsc = tx1 / kCoarse - cx0 + 1, cspan = ncolsc * (ty1 / kCoarse - cy0 + 1);
  if (cspan <= p.kc) return {ntiles, cy0, cx0, ncolsc, ntxc, cspan};
  return {ntiles + cdiv(p.nty, kCoarse) * ntxc, 0, 0, 1, 0, 1};
}

__device__ __forceinline__ int num_keys(const FrBinParams& p) {  // R: fine, coarse, spill
  return p.ntx * p.nty + cdiv(p.ntx, kCoarse) * cdiv(p.nty, kCoarse) + 1;
}

__global__ void __launch_bounds__(kThreads)
bin_count_kernel(FrBinParams p, const int32_t* __restrict__ ti, int32_t* counts) {
  const int lane = threadIdx.x & 31, w = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (w >= p.n_stripes) return;  // whole warps
  const int S = p.n_stripes;
  const int hi = min((w + 1) * p.stripe, p.m);
  for (int s = w * p.stripe + lane; s < hi; s += 32) {
    const Keys k = slot_keys(p, ti, s);
    for (int j = 0; j < k.n; ++j) atomicAdd(counts + (size_t)k(j) * S + w, 1);
  }
}

// 128 threads, 8 counters each a round: the exclusive scan of one key's
// row of counts over the stripes, in place; its total.
__global__ void __launch_bounds__(128)
bin_scan_kernel(FrBinParams p, int32_t* counts, int32_t* __restrict__ totals) {
  __shared__ int32_t warp_sums[4];
  const int S = p.n_stripes, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* row = counts + (size_t)blockIdx.x * S;
  int carry = 0;
  for (int base = 0; base < S; base += 128 * 8) {
    const int i0 = base + threadIdx.x * 8;
    int v[8], local = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = i0 + i < S ? row[i0 + i] : 0;
      local += v[i];
    }
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int run = carry + incl - local, round = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      run += w < warp ? warp_sums[w] : 0;
      round += warp_sums[w];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i0 + i < S) row[i0 + i] = run;
      run += v[i];
    }
    carry += round;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One block of 1024: off[t] = the pairs of keys below t, t = 0 .. R.
__global__ void __launch_bounds__(1024)
bin_offsets_kernel(FrBinParams p, const int32_t* __restrict__ totals, int32_t* __restrict__ off) {
  __shared__ int32_t warp_sums[32];
  const int n_keys = num_keys(p), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n_keys; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < n_keys ? totals[i] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0, round = 0;
    for (int w = 0; w < 32; ++w) {
      before += w < warp ? warp_sums[w] : 0;
      round += warp_sums[w];
    }
    if (i < n_keys) off[i] = carry + before + incl - v;
    carry += round;
    __syncthreads();
  }
  if (threadIdx.x == 0) off[n_keys] = carry;
}

// A warp a stripe; table: hash slots a warp (a power of two, at least
// twice the keys 32 slots can hold), keys then lane masks, in dynamic
// shared memory.
__global__ void __launch_bounds__(kThreads)
bin_pairs_kernel(FrBinParams p, const int32_t* __restrict__ ti, int32_t* counts, const int32_t* __restrict__ off,
                 int32_t* __restrict__ ptri, int table) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;
  if (w >= p.n_stripes) return;  // whole warps
  int32_t* tk = smem + (size_t)warp * 2 * table;
  uint32_t* tm = reinterpret_cast<uint32_t*>(tk + table);
  const int mask_bits = table - 1, S = p.n_stripes;
  const uint32_t below = (1u << lane) - 1u;
  for (int i = lane; i < table; i += 32) tk[i] = -1, tm[i] = 0u;
  __syncwarp();
  const int hi = min((w + 1) * p.stripe, p.m);
  for (int base = w * p.stripe; base < hi; base += 32) {
    const int s = base + lane;
    const Keys k = s < hi ? slot_keys(p, ti, s) : Keys{0, 0, 0, 1, 0, 0};
    for (int j = 0; j < k.n; ++j) {  // this chunk's keys, each with the lanes that hold it
      const int key = k(j);
      for (int h = key & mask_bits;; h = (h + 1) & mask_bits) {
        const int prev = atomicCAS(tk + h, -1, key);
        if (prev == -1 || prev == key) {
          atomicOr(tm + h, 1u << lane);
          break;
        }
      }
    }
    __syncwarp();
    for (int j = 0; j < k.n; ++j) {  // place: the key's pairs so far, then earlier lanes'
      const int key = k(j);
      int h = key & mask_bits;
      while (tk[h] != key) h = (h + 1) & mask_bits;
      ptri[off[key] + counts[(size_t)key * S + w] + __popc(tm[h] & below)] = s;
    }
    __syncwarp();
    for (int j = 0; j < k.n; ++j) {  // the key's lowest lane moves its count on
      const int key = k(j);
      int h = key & mask_bits;
      while (tk[h] != key) h = (h + 1) & mask_bits;
      const uint32_t lanes = tm[h];
      if ((lanes & below) == 0) counts[(size_t)key * S + w] += __popc(lanes);
    }
    __syncwarp();
    for (int i = lane; i < table; i += 32) tk[i] = -1, tm[i] = 0u;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
bin_records_kernel(FrBinParams p, const int32_t* __restrict__ ti, const float* __restrict__ tf,
                   int32_t* __restrict__ recs) {
  __shared__ int32_t tile[kRecSlots][kChunk + 1];
  const int rows = NF_I + p.rows_f, rec = rec_words(p), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * kRecSlots, s = s0 + lane, n_slots = min(kRecSlots, p.m - s0);
  for (int c0 = 0; c0 < rec; c0 += kChunk) {
    const int width = min(kChunk, rec - c0);
    for (int w = warp; w < width; w += kThreads / 32) {  // record word c0 + w: a packed row's, or padding
      const int r = c0 + w;
      int v = 0;
      if (s < p.m && r < rows) {
        v = r < NF_I ? __ldg(ti + (size_t)r * p.m + s) : __float_as_int(__ldg(tf + (size_t)(r - NF_I) * p.m + s));
      }
      tile[lane][w] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_slots * width; i += kThreads) {
      const int j = i / width, w = i - j * width;
      recs[(size_t)(s0 + j) * rec + c0 + w] = tile[j][w];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kGatherCols)
bin_gather_kernel(FrBinParams p, const int32_t* __restrict__ recs, const int32_t* __restrict__ off,
                  const int32_t* __restrict__ ptri, int32_t* __restrict__ oi, float* __restrict__ of) {
  __shared__ int32_t tile[kGatherCols][kChunk + 1];  // odd stride: a row's reads meet no bank twice
  __shared__ int32_t slot[kGatherCols];
  const int rows = NF_I + p.rows_f, rec = rec_words(p), t = threadIdx.x, q = blockIdx.x * kGatherCols + t;
  const int total = __ldg(off + num_keys(p));
  slot[t] = q < p.n_pad ? (q < total ? __ldg(ptri + q) : p.m_dummy) : -1;
  const size_t n = p.n_pad;
  for (int c0 = 0; c0 < rows; c0 += kChunk) {
    const int parts = min(kChunk, rec - c0) / 4;  // 16-byte pieces of a record's chunk
    __syncthreads();  // slot[] written; the last chunk's tile read
    for (int i = t; i < kGatherCols * parts; i += kGatherCols) {
      const int j = i / parts, part = i - j * parts, sj = slot[j];
      if (sj < 0) continue;
      const int4 v = __ldg(reinterpret_cast<const int4*>(recs + (size_t)sj * rec + c0) + part);
      int32_t* dst = &tile[j][part * 4];
      dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
    }
    __syncthreads();
    if (q < p.n_pad) {
      for (int r = c0; r < min(rows, c0 + kChunk); ++r) {
        const int v = tile[t][r - c0];
        if (r < NF_I) {
          oi[r * n + q] = v;
        } else {
          of[(r - NF_I) * n + q] = __int_as_float(v);
        }
      }
    }
  }
}

}  // namespace

extern "C" int fr_bin_pairs(FrBinParams p, const int32_t* tri_i32, const float* tri_f32, int32_t* counts,
                            int32_t* totals, int32_t* off, int32_t* ptri, int32_t* recs, int32_t* out_i32,
                            float* out_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_keys = p.ntx * p.nty + ((p.ntx + kCoarse - 1) / kCoarse) * ((p.nty + kCoarse - 1) / kCoarse) + 1;
  const int nk = p.k > p.kc ? p.k : p.kc;
  int table = 64;
  while (table < 64 * nk) table <<= 1;  // at least twice the 32 nk keys of a chunk
  int warps = 6144 / table;             // 48 KB of tables a block
  warps = warps < 1 ? 1 : (warps > kThreads / 32 ? kThreads / 32 : warps);
  if (table > 6144) return (int)cudaErrorInvalidValue;
  const int warp_blocks = (p.n_stripes + kThreads / 32 - 1) / (kThreads / 32);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * (size_t)n_keys * p.n_stripes, st);
  if (err != cudaSuccess) return (int)err;
  bin_count_kernel<<<warp_blocks, kThreads, 0, st>>>(p, tri_i32, counts);
  bin_scan_kernel<<<n_keys, 128, 0, st>>>(p, counts, totals);
  bin_offsets_kernel<<<1, 1024, 0, st>>>(p, totals, off);
  bin_pairs_kernel<<<(p.n_stripes + warps - 1) / warps, warps * 32, (size_t)warps * table * 8, st>>>(
      p, tri_i32, counts, off, ptri, table);
  bin_records_kernel<<<(p.m + kRecSlots - 1) / kRecSlots, kThreads, 0, st>>>(p, tri_i32, tri_f32, recs);
  bin_gather_kernel<<<(p.n_pad + kGatherCols - 1) / kGatherCols, kGatherCols, 0, st>>>(p, recs, off, ptri, out_i32,
                                                                                        out_f32);
  return (int)cudaGetLastError();
}
