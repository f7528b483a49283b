// SVO voxel ray march: one CUDA thread per ray through the densified r^3
// voxel table; the first hit wins.
//
// Replaces the TPU kernel f_renderer_tpu/voxel/raycast_pallas.py:393 (the
// pallas_call in march_pallas, "K5", body _march_kernel :54). The plain
// version is voxel/raycast.py:march_plain; the two take the same steps, so
// they make the same queries and write the same frame, bit for bit.
//
// Per ray (start s, direction d, t_max, alive), from t = 0 (sample index
// k = 0):
//   query the cell of p = s + t * d: a hit is the cell's bit in the hit
//   bitmap with p inside [0, length)^3, the cell index trunc(p / cell)
//   clamped to [0, r - 1] (a division, as the JAX jnp march divides);
//   stop on a hit or once t >= t_max; else step
//     dda:   t = min((t + dt) + eps, t_max), dt the exact distance to the
//            next cell boundary (raycast_pallas.py:133-166);
//     fixed: the reference's serial chain t = min(t + per_t, t_max)
//            (voxel.rs:336-355) visits t_k, k float32 additions of per_t.
//            After a miss, every sample closer than jump_dt (the distance
//            to the cell's boundary less eps_jump on each axis, and short
//            of t_max by eps_jump) lies in the same empty or outside cell:
//            the ray jumps k past them, to the first sample not proven to,
//            and reads the exact t_k from the times table. This is the TPU
//            kernel's empty-cell jump (raycast_pallas.py:167-225) with its
//            2-step margin replaced by one in length units, so a ray
//            spends about one query per cell it crosses instead of ~50.
//            A jump never passes the table's end (k + x + 1 <= kmax), and
//            NaN or infinite distances never jump. Every fixed-step march
//            jumps: march_constants admits fixed steps only where the
//            cube's faces lie on grid planes (r * cell == length), so that
//            a grid cell outside the cube is wholly outside it.
// and write (bgr | 0xFF000000) of the hit cell, read once at the final t,
// or the background where the ray misses or is not alive (:269-273). A
// per-ray loop takes the place of the TPU block's any() exit; max_steps
// bounds it as a watchdog where no real ray reaches it.
//
// What bounds it on the card: the latency of each ray's chain of queries
// (~25 operations each, three of them IEEE divisions) and jumps, with the
// rays of a warp diverging in query count; a fixed part (the hit-bit pass,
// one read of each ray's planes, one write) is about a fifth of it at
// voxel540. The design against that:
//  - the jump cuts the fixed step's queries ~23x at voxel540, to about the
//    dda step's count;
//  - 1 / |d| is taken once per ray, so a jump costs multiplications;
//  - the hit bitmap (r^3 / 8 bytes, built from the table by a first small
//    kernel in the same call) sits in each block's shared memory while it
//    fits (<= 32 KiB, up to level 5 at r = 64); from level 6 on it is read
//    through L1/L2 instead. The colour table is read once per ray
//    (__ldg); the times table (~2.4 K floats at level 3) once per jump,
//    through the read-only cache: copying it into every block's shared
//    memory as well measured slower (PERF.md);
//  - one thread per ray in row-major order, so a warp marches 32 pixels of
//    one row: an 8 x 4 pixel patch per warp measured the same at voxel540
//    (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;            // 8 warps per block
constexpr int kSharedBitsMax = 8192;     // bitmap words (32 KiB) kept in shared memory
constexpr float kFar = 3.0e38f;          // the JAX package's stand-in for +inf

// jnp.minimum: NaN if either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ int cell_of(const FrVoxelParams& p, float pos) {
  return min(max((int)(pos / p.cell), 0), p.r - 1);
}

// Flat table index of p, and whether p lies inside the cube.
__device__ __forceinline__ int flat_cell(const FrVoxelParams& p, float px, float py, float pz,
                                         bool& inside) {
  inside = px >= 0.0f && px < p.length && py >= 0.0f && py < p.length && pz >= 0.0f &&
           pz < p.length;
  return (cell_of(p, px) * p.r + cell_of(p, py)) * p.r + cell_of(p, pz);
}

// Distance along the ray to the next cell boundary on one axis (3D-DDA).
__device__ __forceinline__ float axis_dt(float pos, float d, float cell) {
  const float c = floorf(pos / cell);
  const float boundary = (c + (d > 0.0f ? 1.0f : 0.0f)) * cell;
  float tn = (boundary - pos) / d;
  if (d == 0.0f || isnan(tn)) tn = kFar;
  return fmaxf(tn, 0.0f);
}

// How far along the ray the point stays eps inside its cell on one axis
// (raycast.py:_jump_dt), inv_ad = 1 / |d|; negative where it is closer
// than eps.
__device__ __forceinline__ float axis_jump(float pos, float d, float inv_ad, float cell,
                                           float eps) {
  const float c = floorf(pos / cell);
  const bool up = d > 0.0f;
  const float boundary = (c + (up ? 1.0f : 0.0f)) * cell;
  const float dist = up ? boundary - pos : pos - boundary;
  float tn = (dist - eps) * inv_ad;
  if (d == 0.0f || isnan(tn)) tn = kFar;
  return tn;
}

// One bit per cell, 32 cells per word, little-endian within the word.
__global__ void hit_bits_kernel(const int32_t* __restrict__ table, int n_cells,
                                uint32_t* __restrict__ bits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool b = c < n_cells && ((table[c] >> 24) & 1) != 0;
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, b);
  if ((threadIdx.x & 31) == 0 && c < n_cells) bits[c >> 5] = word;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
voxel_march_kernel(const FrVoxelParams p, const float* __restrict__ sx,
                   const float* __restrict__ sy, const float* __restrict__ sz,
                   const float* __restrict__ dx, const float* __restrict__ dy,
                   const float* __restrict__ dz, const float* __restrict__ tmax,
                   const int32_t* __restrict__ alive, const int32_t* __restrict__ table,
                   const float* __restrict__ times, const uint32_t* __restrict__ bits_g,
                   int32_t* __restrict__ out) {
  extern __shared__ uint32_t s_bits[];
  const uint32_t* bits = bits_g;
  if (kShared) {
    const int n_words = (p.r * p.r * p.r + 31) >> 5;
    for (int w = threadIdx.x; w < n_words; w += kThreads) s_bits[w] = bits_g[w];
    __syncthreads();
    bits = s_bits;
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;

  bool hit = false;
  int flat = 0;
  if (alive[i] != 0) {
    const float s0 = sx[i], s1 = sy[i], s2 = sz[i];
    const float d0 = dx[i], d1 = dy[i], d2 = dz[i];
    const float tm = tmax[i];
    const int kmax = p.n_times - 1;
    const float i0 = 1.0f / fabsf(d0), i1 = 1.0f / fabsf(d1), i2 = 1.0f / fabsf(d2);
    float t = 0.0f;
    int k = 0;  // fixed mode: t == times[k] until t_max clamps it
    for (int it = 0; it < p.max_steps; ++it) {
      const float px = s0 + t * d0, py = s1 + t * d1, pz = s2 + t * d2;
      bool inside;
      flat = flat_cell(p, px, py, pz, inside);
      hit = inside && ((bits[flat >> 5] >> (flat & 31)) & 1u) != 0;
      if (hit || t >= tm) break;
      float next;
      if (p.dda) {
        const float dt = min_nan(min_nan(axis_dt(px, d0, p.cell), axis_dt(py, d1, p.cell)),
                                 axis_dt(pz, d2, p.cell));
        next = (t + dt) + p.eps;
      } else {
        next = t + p.per_t;
        int kn = k + 1;
        // skip samples k+1 .. k+x, all in this cell; land on k+x+1
        const float jdt = min_nan(min_nan(axis_jump(px, d0, i0, p.cell, p.eps_jump),
                                          axis_jump(py, d1, i1, p.cell, p.eps_jump)),
                                  axis_jump(pz, d2, i2, p.cell, p.eps_jump));
        const float reach = min_nan(jdt, (tm - t) - p.eps_jump);
        const float xs = floorf(reach * p.inv_per_t);
        if (xs >= 1.0f && xs <= (float)(kmax - 1 - k)) {
          kn = k + (int)xs + 1;
          next = __ldg(times + kn);
        }
        k = kn;
      }
      t = min_nan(next, tm);
    }
  }
  out[i] = hit ? (int32_t)(((uint32_t)__ldg(table + flat) & 0x00FFFFFFu) | 0xFF000000u)
               : p.bg_packed;
}

}  // namespace

extern "C" int fr_voxel_march(FrVoxelParams p, const float* sx, const float* sy,
                              const float* sz, const float* dx, const float* dy,
                              const float* dz, const float* tmax, const int32_t* alive,
                              const int32_t* table, const float* times, int32_t* bits,
                              int32_t* out, void* stream) {
  if (p.n <= 0) return (int)cudaSuccess;
  if (p.n_times < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_cells = p.r * p.r * p.r;
  uint32_t* words = reinterpret_cast<uint32_t*>(bits);
  hit_bits_kernel<<<(n_cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(table, n_cells, words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_words = (n_cells + 31) >> 5;
  const int grid = (p.n + kThreads - 1) / kThreads;
  if (n_words <= kSharedBitsMax) {
    voxel_march_kernel<true><<<grid, kThreads, n_words * sizeof(uint32_t), s>>>(
        p, sx, sy, sz, dx, dy, dz, tmax, alive, table, times, words, out);
  } else {
    voxel_march_kernel<false><<<grid, kThreads, 0, s>>>(p, sx, sy, sz, dx, dy, dz, tmax, alive,
                                                        table, times, words, out);
  }
  return (int)cudaGetLastError();
}
