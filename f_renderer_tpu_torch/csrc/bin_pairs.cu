// Binning and pair gather: the set-up's slot records sorted into per-tile
// pair lists, as a counting sort, and gathered into pair order.
//
// Replaces no Pallas kernel but XLA's fusions of the JAX package's binning
// and pair-order gather: raster_pallas.py:319 bin_pairs (the (tile,
// triangle) pair keys of the fine, coarse and spill levels, their sort and
// the searchsorted offsets) and fused.py:160 _pair_gather /
// fused.py:183 prep_fused_packed (every packed row gathered in pair order).
// The plain version is pipeline/raster.py:bin_packed_plain (bin_pairs and
// an index_select of the records); where it takes the packed 31-bit sort
// its offsets and pair columns equal the kernels' bit for bit, since both
// order the pairs by (key, slot). Where it takes the stable two-operand
// sort (keys past 31 bits) its pairs within a key follow the key slot j
// instead: the offsets are equal and each key's list is a permutation of
// the plain one (the raster's per-pixel (rhw, order) merge does not depend
// on the order).
//
// The input is a record a slot (rec_words: the 12 int32 rows, then the
// 9 + 3C float32 rows as bits, zeros to a whole number of 32-byte sectors),
// which the triangle set-up kernels write (csrc/tri_setup.cu), and each
// slot's bbox words (MINXY, MAXXY) at any strides: the set-up's (2, m_pad)
// array, or the rows' own two rows where PyTorch made the records from
// packed rows (raster.bin_rows: raster.prep_binned and the paths on it).
//
// The keys are few (ntiles + ntilesc + 1: 548 at phong1080, 1,094 at
// stress4k), so the sort counts. A stripe of consecutive slots is one
// block's (256 threads), and a key's count lives in shared memory:
//   bin_count_kernel  a block counts its stripe's pairs per key in shared
//                     memory (a warp's equal keys added once, found by
//                     __match_any_sync) and writes its row of counts, so no
//                     memset runs: counts[stripe][key];
//   bin_scan_kernel   32 keys a block of 32 warps: the exclusive scan of each
//                     key's counts over the stripes (in place), its total;
//   bin_pairs_kernel  a block a stripe: off (the exclusive scan of the
//                     totals; stripe 0 writes it) and each key's running
//                     place, off[key] + the pairs of earlier stripes, in
//                     shared memory. 256 slots at a time, in slot order: the
//                     chunk's pairs laid out slot-major (a block scan of the
//                     slots' key counts) and placed 256 at a time; a pair's
//                     place is its key's running place + the pairs of that
//                     key of earlier lanes (__match_any_sync) and of earlier
//                     warps (warp 0 moves each key's place on, warp by warp,
//                     in order): deterministic and stable in (key, slot);
//   bin_gather_kernel 64 pair columns a block: their slots' records copied
//                     into shared memory by cp.async (16 bytes, L2 only, no
//                     register staging), then written out row by row (two
//                     threads a column, each row's 64 words at once); 16
//                     blocks an SM, so one block's writes overlap the
//                     others' copies.
//                     The padding columns past the last pair take m_dummy's
//                     record, read once a block: a copy of it for each
//                     (~750 K columns at stress4k) sent every one to the
//                     same L2 lines and took the gather from 0.24 ms to
//                     1.37 ms on an H100 (PERF.md).
// Launched one after another with programmatic stream serialization: each
// kernel's blocks start while the one before ends, and wait for it
// (griddepcontrol.wait) before they read its output.
//
// What bounds it on the card: bytes. It reads the records once (192 B a
// slot at C = 8) and the bboxes, and writes the pair-order arrays (180 B a
// pair column, padding columns included): ~566 MB at stress4k. The counting
// passes touch 8 B a slot and 4 B a counter. A tile's slots lie far apart
// (a soup's triangles at stress4k), so the gather reads whole records: a
// pair's 45 words in 6 sectors, where the rows would put them in 45.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;  // a stripe's block
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;    // bin tile width
constexpr int kCoarse = 4;     // a coarse tile is kCoarse x kCoarse fine tiles
constexpr int NF_I = 12;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanKeys = 32;     // keys a block of the scan
constexpr int kGatherCols = 64;      // pair columns a block of the gather
constexpr int kGatherThreads = 128;  // two a column, each writing half its rows
constexpr int kGatherQ = 16;         // 16-byte pieces of a record a unit of the gather copies (64 words)

// Words of a slot's record: its rows, padded to whole 32-byte sectors.
__host__ __device__ __forceinline__ int rec_words(int rows_f) { return (NF_I + rows_f + 7) / 8 * 8; }

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

__host__ __device__ __forceinline__ int num_keys(const FrBinParams& p) {  // R: fine, coarse, spill
  return p.ntx * p.nty + cdiv(p.ntx, kCoarse) * cdiv(p.nty, kCoarse) + 1;
}

// A slot's pair keys: key j < n is offset + (y0 + j / ncols) * stride + x0 + j % ncols.
struct Keys {
  int offset, y0, x0, ncols, stride, n;
  __device__ __forceinline__ int operator()(int j) const { return offset + (y0 + j / ncols) * stride + x0 + j % ncols; }
};

// raster.bin_pairs' levels for slot s: its span of fine tiles if at most
// k, else of coarse tiles if at most kc, else the spill key; none where the
// bbox, shifted by the origin and clamped to the grid, is empty.
__device__ __forceinline__ Keys slot_keys(const FrBinParams& p, const int32_t* __restrict__ bb, int s) {
  const size_t at = (size_t)s * p.bb_slot;
  const int lo = __ldg(bb + at), hi = __ldg(bb + at + p.bb_max);
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

__device__ __forceinline__ Keys stripe_keys(const FrBinParams& p, const int32_t* __restrict__ bb, int s, int hi) {
  return s < hi ? slot_keys(p, bb, s) : Keys{0, 0, 0, 1, 0, 0};
}

// The exclusive scan of v over the block (every thread calls it; it
// syncs); *total: the sum.
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    sum += s;
  }
  *total = sum;
  return before + incl - v;
}

// counts (n_stripes, R): block b's row; cnt: R counters in dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
bin_count_kernel(FrBinParams p, const int32_t* __restrict__ bb, int32_t* __restrict__ counts) {
  extern __shared__ int32_t cnt[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::);  // the scan's blocks may start, and wait
  const int n_keys = num_keys(p), b = blockIdx.x, t = threadIdx.x, lane = t & 31;
  for (int i = t; i < n_keys; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const int lo = b * p.stripe, hi = min(lo + p.stripe, p.m);
  for (int base = lo; base < hi; base += kThreads) {
    const Keys k = stripe_keys(p, bb, base + t, hi);
    const int rounds = __reduce_max_sync(kFull, k.n);
    for (int j = 0; j < rounds; ++j) {
      const int key = j < k.n ? k(j) : -1;
      const unsigned same = __match_any_sync(kFull, key);
      if (key >= 0 && (same & ((1u << lane) - 1u)) == 0) atomicAdd(cnt + key, __popc(same));
    }
  }
  __syncthreads();
  int32_t* row = counts + (size_t)b * n_keys;
  for (int i = t; i < n_keys; i += kThreads) row[i] = cnt[i];
}

// kScanKeys keys a block, a lane a key; warp w takes a run of the stripes.
__global__ void __launch_bounds__(1024)
bin_scan_kernel(FrBinParams p, int32_t* __restrict__ counts, int32_t* __restrict__ totals) {
  __shared__ int32_t part[32][kScanKeys + 1];
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the counts
  const int n_keys = num_keys(p), lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int key = blockIdx.x * kScanKeys + lane;
  const bool on = key < n_keys;
  const int per = cdiv(p.n_stripes, 32), b0 = min(w * per, p.n_stripes), b1 = min(b0 + per, p.n_stripes);
  int sum = 0;
  if (on) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b) sum += counts[(size_t)b * n_keys + key];
  }
  part[w][lane] = sum;
  __syncthreads();
  if (w == 0) {
    int run = 0;
    for (int v = 0; v < 32; ++v) {
      const int c = part[v][lane];
      part[v][lane] = run;
      run += c;
    }
    if (on) totals[key] = run;
  }
  __syncthreads();
  if (on) {
    int run = part[w][lane];
#pragma unroll 8
    for (int b = b0; b < b1; ++b) {
      int32_t* c = counts + (size_t)b * n_keys + key;
      const int v = *c;
      *c = run;
      run += v;
    }
  }
}

// A block a stripe; run: R running places in dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
bin_pairs_kernel(FrBinParams p, const int32_t* __restrict__ bb, const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ totals, int32_t* __restrict__ off, int32_t* __restrict__ ptri) {
  extern __shared__ int32_t run[];
  __shared__ int32_t warp_sums[kWarps];
  __shared__ int32_t pre[kThreads];  // the chunk's pairs before each slot
  __shared__ int32_t k_off[kThreads], k_y0[kThreads], k_x0[kThreads], k_nc[kThreads], k_st[kThreads];
  __shared__ int32_t lead_key[kThreads], lead_cnt[kThreads], lead_base[kThreads];
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the scanned counts and the totals
  const int n_keys = num_keys(p), b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  {  // off: a run of keys a thread; run[key] = off[key] + the pairs of key in stripes before b
    const int per = cdiv(n_keys, kThreads), k0 = min(t * per, n_keys), k1 = min(k0 + per, n_keys);
    int sum = 0, total;
    for (int i = k0; i < k1; ++i) sum += __ldg(totals + i);
    int o = block_exclusive(sum, warp_sums, &total);
    const int32_t* row = counts + (size_t)b * n_keys;
    for (int i = k0; i < k1; ++i) {
      run[i] = o + __ldg(row + i);
      if (b == 0) off[i] = o;
      o += __ldg(totals + i);
    }
    if (b == 0 && t == 0) off[n_keys] = total;
  }
  __syncthreads();
  const int lo = b * p.stripe, hi = min(lo + p.stripe, p.m);
  for (int base = lo; base < hi; base += kThreads) {
    const Keys k = stripe_keys(p, bb, base + t, hi);
    int total;
    pre[t] = block_exclusive(k.n, warp_sums, &total);
    k_off[t] = k.offset, k_y0[t] = k.y0, k_x0[t] = k.x0, k_nc[t] = k.ncols, k_st[t] = k.stride;
    __syncthreads();
    for (int r = 0; r < total; r += kThreads) {  // pairs r .. r + 255 of the chunk, slot-major
      const int q = r + t;
      const bool on = q < total;
      int key = -1, slot = 0;
      if (on) {
        int l = 0;  // the last slot of the chunk whose pairs start at or before q
#pragma unroll
        for (int step = kThreads / 2; step > 0; step >>= 1) l += pre[l + step] <= q ? step : 0;
        const int j = q - pre[l];
        key = k_off[l] + (k_y0[l] + j / k_nc[l]) * k_st[l] + k_x0[l] + j % k_nc[l];
        slot = base + l;
      }
      const unsigned same = __match_any_sync(kFull, key);  // every lane: the lanes of equal key
      const int lead = __ffs(same) - 1;
      lead_key[t] = on && lead == lane ? key : -1;
      lead_cnt[t] = __popc(same);
      __syncthreads();
      if (warp == 0) {  // each key's running place moves on, warp by warp
        for (int w = 0; w < kWarps; ++w) {
          const int u = w * 32 + lane, kk = lead_key[u];
          if (kk >= 0) {
            const int v = run[kk];
            lead_base[u] = v;
            run[kk] = v + lead_cnt[u];
          }
          __syncwarp();
        }
      }
      __syncthreads();
      if (on) ptri[lead_base[warp * 32 + lead] + __popc(same & below)] = slot;
    }
    __syncthreads();  // pre, k_* and warp_sums read before the next chunk writes them
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Pieces of a record a unit stages (at most kGatherQ) and its odd stride in
// shared memory: a thread's 16-byte reads of its own record then meet each
// bank once among the 8 threads of a phase.
__host__ __device__ __forceinline__ int gather_stride(int rec) { return min(rec / 4, kGatherQ) | 1; }

// A block a unit: kGatherCols pair columns x at most kGatherQ pieces of
// their records (one unit a group where rec <= 64 words). Dynamic shared
// memory: kGatherCols x stride pieces, then the unit's pieces of m_dummy's
// record (13.5 KB at C = 8: 16 blocks an SM). The SM's other blocks overlap
// one block's row writes with their copies: double-buffering inside a
// block, with fewer blocks an SM, read slower at stress4k on an H100
// (PERF.md).
__global__ void __launch_bounds__(kGatherThreads)
bin_gather_kernel(FrBinParams p, const int32_t* __restrict__ recs, const int32_t* __restrict__ off,
                  const int32_t* __restrict__ ptri, int32_t* __restrict__ oi, float* __restrict__ of) {
  extern __shared__ int4 stage[];
  __shared__ int32_t slot[kGatherCols];
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // off and the pair columns
  const int rows = NF_I + p.rows_f, rec = rec_words(p.rows_f), nq = rec / 4, stride = gather_stride(rec);
  const int t = threadIdx.x, col = t % kGatherCols, half = t / kGatherCols, total = __ldg(off + num_keys(p));
  const int n_parts = cdiv(nq, kGatherQ), group = blockIdx.x / n_parts, q0 = (blockIdx.x % n_parts) * kGatherQ;
  const int width = min(kGatherQ, nq - q0), r0 = 4 * q0, q = group * kGatherCols + col;
  int4* dummy = stage + kGatherCols * stride;
  if (t < kGatherCols) slot[t] = q < total ? __ldg(ptri + q) : -1;  // -1: a padding column
  if (t < width) dummy[t] = __ldg(reinterpret_cast<const int4*>(recs + (size_t)p.m_dummy * rec) + q0 + t);
  __syncthreads();
  for (int i = t; i < kGatherCols * width; i += kGatherThreads) {
    const int j = i / width, c = i - j * width, sj = slot[j];
    if (sj >= 0) cp_async16(stage + j * stride + c, recs + (size_t)sj * rec + 4 * (q0 + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // this thread's pieces
  __syncthreads();                                          // and every thread's
  if (q >= p.n_pad) return;
  const size_t n = p.n_pad;
  const int pieces = cdiv(min(rows, r0 + 4 * width) - r0, 4), mine = cdiv(pieces, 2);
  const int4* src = q < total ? stage + col * stride : dummy;
  const int r1 = min(rows, r0 + 4 * min(pieces, (half + 1) * mine));
  for (int r = r0 + 4 * half * mine; r < r1; r += 4) {  // this thread's half of column q's pieces
    const int4 v = src[(r - r0) >> 2];
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r + i < r1) {  // a piece is all int rows or all float rows (NF_I = 12)
        if (r < NF_I) {
          oi[(size_t)(r + i) * n + q] = w[i];
        } else {
          of[(size_t)(r + i - NF_I) * n + q] = __int_as_float(w[i]);
        }
      }
    }
  }
}

// Launch behind the kernel before it on the stream, by programmatic
// stream serialization.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), int grid, int block, size_t smem, cudaStream_t st,
                         Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Dynamic shared memory above the default 48 KB needs the kernel's consent.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int fr_bin_pairs(FrBinParams p, const int32_t* recs, const int32_t* bbox, int32_t* counts,
                            int32_t* totals, int32_t* off, int32_t* ptri, int32_t* out_i32, float* out_f32,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_keys = num_keys(p), nq = rec_words(p.rows_f) / 4;
  const size_t key_smem = sizeof(int32_t) * (size_t)n_keys;
  const size_t gather_smem = sizeof(int4) * ((size_t)kGatherCols * gather_stride(4 * nq) + kGatherQ);
  cudaError_t err = allow_smem(bin_count_kernel, key_smem);
  if (err == cudaSuccess) err = allow_smem(bin_pairs_kernel, key_smem);
  if (err != cudaSuccess) return (int)err;
  bin_count_kernel<<<p.n_stripes, kThreads, key_smem, st>>>(p, bbox, counts);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_after(bin_scan_kernel, cdiv(n_keys, kScanKeys), 1024, 0, st, p, counts, totals);
  if (err == cudaSuccess) {
    err = launch_after(bin_pairs_kernel, p.n_stripes, kThreads, key_smem, st, p, bbox, (const int32_t*)counts,
                       (const int32_t*)totals, off, ptri);
  }
  if (err == cudaSuccess) {
    err = launch_after(bin_gather_kernel, cdiv(p.n_pad, kGatherCols) * cdiv(nq, kGatherQ), kGatherThreads,
                       gather_smem, st, p, recs, (const int32_t*)off, (const int32_t*)ptri, out_i32, out_f32);
  }
  return (int)err;
}
