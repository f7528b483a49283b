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
//   clamped to [0, r - 1] (p / cell as the JAX jnp march divides; taken
//   as p * (1 / cell) where that is the same float, below);
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
// What bounds it on the card: the instructions the rays' steps issue (at
// voxel540 ~3.4 queries a ray, 1.3x that for the slowest ray of a warp;
// 48 or 64 warps an SM keep the issue slots busy), then a fixed part (the
// hit-bit pass, one read of each ray's planes, one write; with every ray
// dead 0.0048 ms on an H100, 0.0061 before the launch overlap below). The
// dda step had three IEEE divisions (each a sequence with a slow-path
// branch), two branchy minima and three clamps; the design leaves 74 SASS
// instructions a step (tools/k4_trace.py) with nothing inexact:
//  - where cell is a power of two and r * cell == length (every table
//    octree.densify makes, at length 2.0) the host passes inv_cell: the
//    quotient p * inv_cell is p / cell bit for bit, and a point inside the
//    cube has its index in [0, r) with no clamp. Any other cell divides;
//  - one quotient per axis a step, shared by the cell index and the step;
//  - the dda distance (boundary - p) / d as float(double(boundary - p) *
//    (1 / double(d))), 1 / d once a ray: the same float as the division
//    (axis_dt); 1 / d (and the fixed step's 1 / |d|) is NaN where d == 0,
//    so one NaN test an axis gives kFar, as d == 0 or a NaN quotient does;
//  - no axis distance is NaN, so their minimum is fminf; the NaN-keeping
//    minimum of t is one min.NaN instruction, not a branch;
//  - the kernel is compiled for its traversal (no runtime branch; the dda
//    march takes no 1 / |d|);
//  - the march is launched behind the hit-bit pass by programmatic
//    dependent launch: its blocks read their rays while the pass runs;
//  - the jump cuts the fixed step's queries ~23x at voxel540, to about the
//    dda step's count;
//  - the hit bitmap (r^3 / 8 bytes, built from the table by a first small
//    kernel in the same call) sits in each block's shared memory while it
//    fits (<= 32 KiB, up to level 5 at r = 64); from level 6 on it is read
//    through L1/L2 instead. The colour table is read once per ray
//    (__ldg); the times table (~2.4 K floats at level 3) once per jump,
//    through the read-only cache: copying it into every block's shared
//    memory as well measured slower (PERF.md);
//  - one thread per ray in row-major order, so a warp marches 32 pixels of
//    one row: an 8 x 4 pixel patch per warp measured the same at voxel540,
//    and refetching rays from a counter in persistent blocks (the warps'
//    rays differ 1.3x in queries) measured 1.7-2x slower (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;            // 8 warps per block
constexpr int kSharedBitsMax = 8192;     // bitmap words (32 KiB) kept in shared memory
constexpr float kFar = 3.0e38f;          // the JAX package's stand-in for +inf
constexpr unsigned kFull = 0xFFFFFFFFu;

// jnp.minimum: NaN if either operand is NaN (one instruction; which NaN
// does not matter: a NaN t never hits and never ends its ray early).
__device__ __forceinline__ float min_nan(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// pos / cell. Where cell is a power of two the host passes inv_cell = 1 /
// cell (else 0): pos * inv_cell is then the correctly rounded value of the
// same real number as pos / cell, so the same float for every pos (zeros,
// subnormals, infinities and NaN included).
__device__ __forceinline__ float cell_q(const FrVoxelParams& p, float pos) {
  return p.inv_cell != 0.0f ? pos * p.inv_cell : pos / p.cell;
}

// The cell index of q = pos / cell on one axis, clamped to [0, r - 1] as
// the plain version clamps it. Where inv_cell is set the host has also
// checked r * cell == length, so a position inside the cube has q in
// [0, r) exactly and needs no clamp; the index of a position outside the
// cube is never read.
__device__ __forceinline__ unsigned cell_index(const FrVoxelParams& p, float q) {
  return p.inv_cell != 0.0f ? (unsigned)(int)q : (unsigned)min(max((int)q, 0), p.r - 1);
}

// Distance along the ray to the next cell boundary on one axis (3D-DDA);
// q = pos / cell, up = 1 where d > 0 (else 0). The quotient (boundary -
// pos) / d is taken as float(double(boundary - pos) * inv_d), inv_d = 1 /
// double(d): the same float, bit for bit (the double product is within
// 2^-52 of the quotient, which is never within 2^-49 of a float rounding
// boundary without lying on one; tests/test_torch_voxel.py). inv_d is NaN
// where d == 0, so that axis's quotient is NaN and gives kFar, as there.
__device__ __forceinline__ float axis_dt(float q, float pos, float up, double inv_d, float cell) {
  const float boundary = (floorf(q) + up) * cell;
  float tn = __double2float_rn((double)(boundary - pos) * inv_d);
  if (isnan(tn)) tn = kFar;
  return fmaxf(tn, 0.0f);  // never NaN
}

// How far along the ray the point stays eps inside its cell on one axis
// (raycast.py:_jump_dt), q = pos / cell, up as above, inv_ad = 1 / |d|
// (NaN where d == 0, which gives kFar); negative where it is closer than
// eps.
__device__ __forceinline__ float axis_jump(float q, float pos, float up, float inv_ad, float cell,
                                           float eps) {
  const float boundary = (floorf(q) + up) * cell;
  const float dist = up != 0.0f ? boundary - pos : pos - boundary;
  float tn = (dist - eps) * inv_ad;
  if (isnan(tn)) tn = kFar;
  return tn;  // never NaN
}

// One bit per cell, 32 cells per word, little-endian within the word.
__global__ void hit_bits_kernel(const int32_t* __restrict__ table, int n_cells,
                                uint32_t* __restrict__ bits) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);  // the march may start
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool b = c < n_cells && ((table[c] >> 24) & 1) != 0;
  const uint32_t word = __ballot_sync(kFull, b);
  if ((threadIdx.x & 31) == 0 && c < n_cells) bits[c >> 5] = word;
}

template <bool kDda, bool kShared>
__global__ void __launch_bounds__(kThreads)
voxel_march_kernel(const FrVoxelParams p, const float* __restrict__ sx,
                   const float* __restrict__ sy, const float* __restrict__ sz,
                   const float* __restrict__ dx, const float* __restrict__ dy,
                   const float* __restrict__ dz, const float* __restrict__ tmax,
                   const int32_t* __restrict__ alive, const int32_t* __restrict__ table,
                   const float* __restrict__ times, const uint32_t* __restrict__ bits_g,
                   int32_t* __restrict__ out) {
  extern __shared__ uint32_t s_bits[];
  // The ray is read while the hit-bit pass may still run (the march is its
  // programmatic dependent launch); the bitmap only after it.
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < p.n && alive[i] != 0;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, tm = 0.0f;
  if (live) {
    s0 = sx[i], s1 = sy[i], s2 = sz[i];
    d0 = dx[i], d1 = dy[i], d2 = dz[i];
    tm = tmax[i];
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const uint32_t* bits = bits_g;
  if (kShared) {
    const int n_words = (p.r * p.r * p.r + 31) >> 5;
    for (int w = threadIdx.x; w < n_words; w += kThreads) s_bits[w] = bits_g[w];
    __syncthreads();
    bits = s_bits;
  }
  if (i >= p.n) return;

  bool hit = false;
  unsigned flat = 0;
  if (live) {
    const int kmax = p.n_times - 1;
    // per axis, once a ray: up = 1 where d > 0, and the step's reciprocal
    // (dda: 1 / d in float64; fixed: 1 / |d|), NaN where d == 0
    const float u0 = d0 > 0.0f ? 1.0f : 0.0f, u1 = d1 > 0.0f ? 1.0f : 0.0f,
                u2 = d2 > 0.0f ? 1.0f : 0.0f;
    const double nan64 = __longlong_as_double(0x7FF8000000000000LL);
    const double r0 = d0 != 0.0f ? 1.0 / (double)d0 : nan64,
                 r1 = d1 != 0.0f ? 1.0 / (double)d1 : nan64,
                 r2 = d2 != 0.0f ? 1.0 / (double)d2 : nan64;
    const float nan32 = __int_as_float(0x7FC00000);
    const float i0 = d0 != 0.0f ? 1.0f / fabsf(d0) : nan32,
                i1 = d1 != 0.0f ? 1.0f / fabsf(d1) : nan32,
                i2 = d2 != 0.0f ? 1.0f / fabsf(d2) : nan32;
    float t = 0.0f;
    int k = 0;  // fixed mode: t == times[k] until t_max clamps it
    for (int it = 0; it < p.max_steps; ++it) {
      const float px = s0 + t * d0, py = s1 + t * d1, pz = s2 + t * d2;
      // one quotient per axis, shared by the cell index and the step
      const float qx = cell_q(p, px), qy = cell_q(p, py), qz = cell_q(p, pz);
      const bool inside = px >= 0.0f && px < p.length && py >= 0.0f && py < p.length &&
                          pz >= 0.0f && pz < p.length;
      flat = (cell_index(p, qx) * p.r + cell_index(p, qy)) * p.r + cell_index(p, qz);
      hit = inside && ((bits[flat >> 5] >> (flat & 31)) & 1u) != 0;
      if (hit || t >= tm) break;
      float next;
      if constexpr (kDda) {
        const float dt = fminf(fminf(axis_dt(qx, px, u0, r0, p.cell),
                                     axis_dt(qy, py, u1, r1, p.cell)),
                               axis_dt(qz, pz, u2, r2, p.cell));
        next = (t + dt) + p.eps;
      } else {
        next = t + p.per_t;
        int kn = k + 1;
        // skip samples k+1 .. k+x, all in this cell; land on k+x+1
        const float jdt = fminf(fminf(axis_jump(qx, px, u0, i0, p.cell, p.eps_jump),
                                      axis_jump(qy, py, u1, i1, p.cell, p.eps_jump)),
                                axis_jump(qz, pz, u2, i2, p.cell, p.eps_jump));
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
  const bool shared = n_words <= kSharedBitsMax;
  const size_t smem = shared ? n_words * sizeof(uint32_t) : 0;
  auto kernel = p.dda
      ? (shared ? voxel_march_kernel<true, true> : voxel_march_kernel<true, false>)
      : (shared ? voxel_march_kernel<false, true> : voxel_march_kernel<false, false>);
  // behind the hit-bit pass with programmatic stream serialization: the
  // march's blocks start, and read their rays, while the pass runs
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, p, sx, sy, sz, dx, dy, dz, tmax, alive, table, times,
                                 (const uint32_t*)words, out);
}
