// Voxel ray set-up: one CUDA thread per pixel unprojects its ray, intersects
// it with the root cube and writes the march's inputs.
//
// Replaces no Pallas kernel but the XLA fusion of the JAX package's ray
// set-up: the elementwise ops of f_renderer_tpu/voxel/raycast.py:34-264
// (_unproject_dir_planes, _cube_intersect_planes and the fmin chain of
// render_voxel_frame), which XLA compiles into fusions of its own, fenced in
// front of the march by optimization_barrier (raycast_pallas.py:310). The
// port ran them as ~2,500 separate PyTorch ops over (H, W) planes, each a
// node of the captured frame's graph. The plain version is
// voxel/raycast.py:prepare_rays_plain; the two are equal bit for bit (NaN
// equal to NaN, zeros with their signs), because the kernel takes the same
// float32 operations in the same order: no FMA (--fmad=false), IEEE
// division and sqrtf (nvcc's default -prec-div=true -prec-sqrt=true), the
// sums and cross products associated as there, products by the 0 / 1
// constants of the axis vectors taken as products (x * 0 is -0 or NaN for
// some x).
//
// Per pixel (x, y) of a width x height frame, with eye e and length L:
//   ndc = (x * 2 / W - 1, 1 - y * 2 / H); d_i = ((m_i0 ndc_x + m_i1 ndc_y)
//   + m_i2) + m_i3 for the rows i < 3 of inv_mvp; dir = d / sqrt((d_0^2 +
//   d_1^2) + d_2^2);
//   VoxelCube::intersect (voxel.rs:239-334) as _cube_intersect_planes runs
//   it: for each axis, the axis-parallel case (two points), then for each
//   of the axis's two faces the face's corner a where it lies on the ray's
//   line, else the hit b = e + dir * t if t >= 0 and b is in the cube. A
//   push writes slot min(cnt, 7) of eight and counts on, so a ninth point
//   would overwrite slot 7 (none comes: at most two points an axis, and a
//   ray parallel to one axis meets no face of the others). Then a stable
//   sort by distance to e, and for cnt > 2 the reference's scrambling
//   "dedupe" (i = 1; for j < cnt: if p[i] != p[j] { p[i] = p[j]; i = j });
//   start = p[0], end = p[cnt == 1 ? 0 : 1];
//   t_max = fmin(fmin(t_0, t_1), t_2), t_i = (end_i - start_i) / dir_i, with
//   jnp.fmin's rule (a if a < b or b is NaN, else b); alive = cnt > 0 and
//   t_max >= 0.
// The sort is the plain version's: rank_j = #{k : d_k < d_j or (d_k == d_j
// and k < j)} over the distances (3e38 for an empty slot), slot p takes
// the last j of rank p, and zeros where no slot has rank p. Where a
// distance is NaN two slots can share a rank, and no insertion sort gives
// that, so the ranks are counted as there. A ray with cnt <= 2 whose
// distances are below 3e38 (every ray that does not graze an edge or a
// corner of the cube, and every ray that misses it) takes a shortcut that
// is the same function there: one compare-and-swap, no dedupe.
//
// The frame's constants (e, inv_mvp) are read from device memory, never
// passed by value: under a captured frame they are the graph's input
// buffers, and a value passed at capture would freeze frame 0's camera.
// What each pixel derives from them alone (the reduced positions and the
// face corners) it computes itself: a few operations on values every
// thread of the warp reads from one address.
//
// What bounds it on the card: the bytes it writes. Seven float32 planes
// (start, dir, t_max) and one byte plane (alive) are 29 B a ray, 15.0 MB at
// 960 x 540: 0.0045 ms at 3.35 TB/s. Its operations: about 340 float32
// operations a ray on the shortcut (unprojection 30, each axis ~94, the
// two distances and t_max ~28; a division or a square root counted as one),
// 0.0026 ms at 67 T/s for 518,400 rays; a grazing ray takes ~1,000 more
// (the ranks, the selection, the dedupe), and a frame has few. The design
// keeps the bound on the stores: one thread a pixel in row-major order, so
// each warp writes 128 contiguous bytes of every plane; no shared memory,
// no synchronisation; the eight slots are registers (every loop over them
// unrolled over compile-time indices, a slot picked by selects), so the
// kernel takes no stack frame and no local memory. Measured on an H100
// (PERF.md) it takes ~6.6x that bound: the instructions behind the
// operations bound it (each IEEE division and square root is a sequence,
// each of the 18 pushes eight selects), with 80 registers a thread leaving
// room for 24 warps an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kSlots = 8;      // MAX_POINTS: the intersection's point slots
constexpr float kFar = 3.0e38f;  // the JAX package's stand-in for +inf in sorts

struct Slots {
  float x[kSlots], y[kSlots], z[kSlots];
};

// Append (x, y, z) where cond: slot min(cnt, 7) takes it, cnt counts on.
__device__ __forceinline__ void push(Slots& s, int& cnt, bool cond, float x, float y, float z) {
  const int idx = min(cnt, kSlots - 1);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (cond && idx == k) {
      s.x[k] = x;
      s.y[k] = y;
      s.z[k] = z;
    }
  }
  cnt += cond ? 1 : 0;
}

// jnp.fmin: a where a < b or b is NaN, else b (of two zeros, b).
__device__ __forceinline__ float fmin_jnp(float a, float b) {
  return (a < b || isnan(b)) ? a : b;
}

__device__ __forceinline__ float distance(float x, float y, float z, float e0, float e1, float e2) {
  const float dx = x - e0, dy = y - e1, dz = z - e2;
  return sqrtf((dx * dx + dy * dy) + dz * dz);
}

// The plain version's stable sort (ranks and one-hot selects) and its
// dedupe where cnt > 2 → the two points the ray keeps, in s slots 0 and 1.
__device__ __forceinline__ void sort_and_dedupe(Slots& s, int cnt, float e0, float e1, float e2) {
  float dk[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    dk[k] = k < cnt ? distance(s.x[k], s.y[k], s.z[k], e0, e1, e2) : kFar;
  }
  int rank[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    int r = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (k != j) r += (dk[k] < dk[j] || (dk[k] == dk[j] && k < j)) ? 1 : 0;
    }
    rank[j] = r;
  }
  Slots t;
#pragma unroll
  for (int p = 0; p < kSlots; ++p) {
    float x = 0.0f, y = 0.0f, z = 0.0f;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (rank[j] == p) x = s.x[j], y = s.y[j], z = s.z[j];
    }
    t.x[p] = x, t.y[p] = y, t.z[p] = z;
  }
  if (cnt > 2) {
    int i = 1;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (j < cnt) {
        float ix = 0.0f, iy = 0.0f, iz = 0.0f;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if (i == k) ix = t.x[k], iy = t.y[k], iz = t.z[k];
        }
        const float jx = t.x[j], jy = t.y[j], jz = t.z[j];
        if (ix != jx || iy != jy || iz != jz) {  // NaN differs from itself
#pragma unroll
          for (int k = 0; k < kSlots; ++k) {
            if (i == k) t.x[k] = jx, t.y[k] = jy, t.z[k] = jz;
          }
          i = j;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) s.x[k] = t.x[k], s.y[k] = t.y[k], s.z[k] = t.z[k];
}

__global__ void __launch_bounds__(kThreads)
voxel_setup_kernel(int width, int height, float length, const float* __restrict__ eye,
                   const float* __restrict__ inv_mvp, float* __restrict__ planes,
                   uint8_t* __restrict__ alive) {
  const int n = width * height;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int py = i / width, px = i - py * width;

  // unprojection (_unproject_dir_planes)
  const float ndc_x = ((float)px * 2.0f) / (float)width - 1.0f;
  const float ndc_y = 1.0f - ((float)py * 2.0f) / (float)height;
  float d[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = inv_mvp + 4 * r;
    d[r] = ((__ldg(m) * ndc_x + __ldg(m + 1) * ndc_y) + __ldg(m + 2)) + __ldg(m + 3);
  }
  const float norm = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  const float dx = d[0] / norm, dy = d[1] / norm, dz = d[2] / norm;
  const float e0 = __ldg(eye), e1 = __ldg(eye + 1), e2 = __ldg(eye + 2);
  const float L = length;

  // VoxelCube::intersect (_cube_intersect_planes)
  Slots s;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) s.x[k] = 0.0f, s.y[k] = 0.0f, s.z[k] = 0.0f;
  int cnt = 0;
  bool handled = false;  // the axis-parallel case was taken on an earlier axis
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const float n0 = axis == 0 ? 1.0f : 0.0f, n1 = axis == 1 ? 1.0f : 0.0f,
                n2 = axis == 2 ? 1.0f : 0.0f;
    const float u0 = 1.0f - n0, u1 = 1.0f - n1, u2 = 1.0f - n2;
    // dir x n == 0: the ray runs along the axis (voxel.rs:263-279)
    const float c0 = dy * n2 - dz * n1, c1 = dz * n0 - dx * n2, c2 = dx * n1 - dy * n0;
    const bool parallel = c0 == 0.0f && c1 == 0.0f && c2 == 0.0f && !handled;
    const float q0 = u0 * e0, q1 = u1 * e1, q2 = u2 * e2;  // the reduced position
    const bool inside = q0 >= 0.0f && q0 <= L && q1 >= 0.0f && q1 <= L && q2 >= 0.0f && q2 <= L;
    const bool cond = parallel && inside;
    push(s, cnt, cond, q0, q1, q2);
    push(s, cnt, cond, q0 + L * u0, q1 + L * u1, q2 + L * u2);
    handled = handled || cond;

    const float dn = axis == 0 ? dx : (axis == 1 ? dy : dz);
    const bool perp = dn == 0.0f;
#pragma unroll
    for (int face = 0; face < 2; ++face) {
      const float scale = L * (face == 0 ? 0.0f : 1.0f);
      const float a0 = n0 * scale, a1 = n1 * scale, a2 = n2 * scale;
      const float ap0 = a0 - e0, ap1 = a1 - e1, ap2 = a2 - e2;
      const float k0 = ap1 * dz - ap2 * dy, k1 = ap2 * dx - ap0 * dz, k2 = ap0 * dy - ap1 * dx;
      const bool on_line = k0 == 0.0f && k1 == 0.0f && k2 == 0.0f;
      push(s, cnt, !parallel && !perp && on_line, a0, a1, a2);  // a is the hit itself
      const float t = (axis == 0 ? ap0 : (axis == 1 ? ap1 : ap2)) / dn;
      const float b0 = e0 + dx * t, b1 = e1 + dy * t, b2 = e2 + dz * t;
      const bool in_bounds = b0 >= 0.0f && b0 <= L && b1 >= 0.0f && b1 <= L && b2 >= 0.0f && b2 <= L;
      push(s, cnt, !parallel && !perp && !on_line && t >= 0.0f && in_bounds, b0, b1, b2);
    }
  }

  // the sort (and dedupe) → start in slot 0, the second point in slot 1
  const float dist0 = distance(s.x[0], s.y[0], s.z[0], e0, e1, e2);
  const float dist1 = distance(s.x[1], s.y[1], s.z[1], e0, e1, e2);
  const bool shortcut = cnt == 0 || (cnt == 1 && dist0 < kFar) ||
                        (cnt == 2 && dist0 < kFar && dist1 < kFar);
  if (shortcut) {
    if (cnt == 2 && dist1 < dist0) {  // stable: equal distances keep their order
      const float x = s.x[0], y = s.y[0], z = s.z[0];
      s.x[0] = s.x[1], s.y[0] = s.y[1], s.z[0] = s.z[1];
      s.x[1] = x, s.y[1] = y, s.z[1] = z;
    }
  } else {
    sort_and_dedupe(s, cnt, e0, e1, e2);
  }
  const float sx = s.x[0], sy = s.y[0], sz = s.z[0];
  const float ex = cnt == 1 ? sx : s.x[1], ey = cnt == 1 ? sy : s.y[1], ez = cnt == 1 ? sz : s.z[1];

  // the ray_cast set-up (voxel.rs:336-343)
  const float t_max = fmin_jnp(fmin_jnp((ex - sx) / dx, (ey - sy) / dy), (ez - sz) / dz);
  planes[i] = sx;
  planes[n + i] = sy;
  planes[2 * n + i] = sz;
  planes[3 * n + i] = dx;
  planes[4 * n + i] = dy;
  planes[5 * n + i] = dz;
  planes[6 * n + i] = t_max;
  alive[i] = (cnt > 0 && t_max >= 0.0f) ? 1 : 0;
}

}  // namespace

extern "C" int fr_voxel_setup(int width, int height, float length, const float* eye,
                              const float* inv_mvp, float* planes, uint8_t* alive, void* stream) {
  if (width <= 0 || height <= 0) return (int)cudaSuccess;
  if ((long long)width * height > 0x7FFFFFFFLL - kThreads) return (int)cudaErrorInvalidValue;
  const int n = width * height;
  voxel_setup_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      width, height, length, eye, inv_mvp, planes, alive);
  return (int)cudaGetLastError();
}
