// SVO voxel ray march: one CUDA thread per ray through the densified r^3
// voxel table; the first hit wins.
//
// Replaces the TPU kernel f_renderer_tpu/voxel/raycast_pallas.py:393 (the
// pallas_call in march_pallas, "K5", body _march_kernel :54). The plain
// version is voxel/raycast.py:march_plain.
//
// Per ray (start s, direction d, t_max, alive), from t = 0:
//   query the cell of p = s + t * d: a hit is table bit 24 with p inside
//   [0, length)^3, the cell index trunc(p / cell) clamped to [0, r - 1];
//   stop on a hit or once t >= t_max; else step
//     fixed: t = min(t + per_t, t_max)  (voxel.rs:336-355, the JAX jnp march)
//     dda:   t = min((t + dt) + eps, t_max), dt the exact distance to the
//            next cell boundary (raycast_pallas.py:133-166)
// and write (bgr | 0xFF000000) of the hit cell, or the background where the
// ray misses or is not alive (:269-273). The serial fixed-step chain is the
// JAX march's own, so the result is bit-equal by construction; the TPU
// kernel's empty-cell jump through its t_k table is a speed device left
// out. A per-ray loop takes the place of the TPU block's any() exit.
// max_steps bounds the loop as a watchdog; the wrapper sets it where no
// real ray can reach it (t_max <= 3 * length, each step >= its minimum).
//
// What bounds it on the card: operations, ~25 per march step, times the
// steps the rays of this frame take (data-dependent, a few hundred per ray
// in fixed mode at level 3); rays in a warp diverge in step count. The
// table (16 KiB at level 3) is read through the read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

// jnp.minimum: NaN if either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

struct Query {
  bool hit;
  int32_t v;
};

__device__ __forceinline__ Query query(const FrVoxelParams& p, const int32_t* __restrict__ table,
                                       float px, float py, float pz) {
  const bool inside = px >= 0.0f && px < p.length && py >= 0.0f && py < p.length &&
                      pz >= 0.0f && pz < p.length;
  if (!inside) return {false, 0};
  const int ix = min(max((int)(px / p.cell), 0), p.r - 1);
  const int iy = min(max((int)(py / p.cell), 0), p.r - 1);
  const int iz = min(max((int)(pz / p.cell), 0), p.r - 1);
  const int32_t v = __ldg(table + (ix * p.r + iy) * p.r + iz);
  return {((v >> 24) & 1) != 0, v};
}

// Distance along the ray to the next cell boundary on one axis (3D-DDA).
__device__ __forceinline__ float axis_dt(float pos, float d, float cell) {
  const float c = floorf(pos / cell);
  const float boundary = (c + (d > 0.0f ? 1.0f : 0.0f)) * cell;
  float tn = (boundary - pos) / d;
  if (d == 0.0f || isnan(tn)) tn = 3.0e38f;
  return fmaxf(tn, 0.0f);
}

__global__ void voxel_march_kernel(const FrVoxelParams p, const float* __restrict__ sx,
                                   const float* __restrict__ sy, const float* __restrict__ sz,
                                   const float* __restrict__ dx, const float* __restrict__ dy,
                                   const float* __restrict__ dz, const float* __restrict__ tmax,
                                   const int32_t* __restrict__ alive,
                                   const int32_t* __restrict__ table, int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  Query q = {false, 0};
  if (alive[i] != 0) {
    const float s0 = sx[i], s1 = sy[i], s2 = sz[i];
    const float d0 = dx[i], d1 = dy[i], d2 = dz[i];
    const float tm = tmax[i];
    float t = 0.0f;
    for (int k = 0; k < p.max_steps; ++k) {
      const float px = s0 + t * d0, py = s1 + t * d1, pz = s2 + t * d2;
      q = query(p, table, px, py, pz);
      if (q.hit || t >= tm) break;
      float next;
      if (p.dda) {
        const float dt = min_nan(min_nan(axis_dt(px, d0, p.cell), axis_dt(py, d1, p.cell)),
                                 axis_dt(pz, d2, p.cell));
        next = (t + dt) + p.eps;
      } else {
        next = t + p.per_t;
      }
      t = min_nan(next, tm);
    }
  }
  out[i] = q.hit ? (int32_t)(((uint32_t)q.v & 0x00FFFFFFu) | 0xFF000000u) : p.bg_packed;
}

}  // namespace

extern "C" int fr_voxel_march(FrVoxelParams p, const float* sx, const float* sy,
                              const float* sz, const float* dx, const float* dy,
                              const float* dz, const float* tmax, const int32_t* alive,
                              const int32_t* table, int32_t* out, void* stream) {
  if (p.n <= 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  const int blocks = (p.n + kThreads - 1) / kThreads;
  voxel_march_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p, sx, sy, sz, dx, dy, dz,
                                                                    tmax, alive, table, out);
  return (int)cudaGetLastError();
}
