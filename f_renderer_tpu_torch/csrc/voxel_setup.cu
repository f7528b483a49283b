// Voxel ray set-up: one CUDA thread per pixel unprojects its ray, intersects
// it with the root cube and writes the march's inputs.
//
// Replaces no Pallas kernel but the XLA fusion of the JAX package's ray
// set-up: the elementwise ops of f_renderer_tpu/voxel/raycast.py:34-264
// (_unproject_dir_planes, _cube_intersect_planes and the fmin chain of
// render_voxel_frame), which XLA compiles into fusions of its own, fenced in
// front of the march by optimization_barrier (raycast_pallas.py:310). The
// plain version is voxel/raycast.py:prepare_rays_plain; the two are equal
// bit for bit (NaN equal to NaN, zeros with their signs), because the
// kernel takes the same float32 operations in the same order: no FMA
// (--fmad=false), IEEE division and sqrtf (nvcc's default -prec-div=true
// -prec-sqrt=true), the sums and cross products associated as there,
// products by the 0 / 1 constants of the axis vectors taken as products
// (x * 0 is -0 or NaN for some x; x * 1 is x and folds away).
//
// Per pixel (x, y) of a width x height frame, with eye e and length L:
//   ndc = (x * 2 / W - 1, 1 - y * 2 / H); d_i = ((m_i0 ndc_x + m_i1 ndc_y)
//   + m_i2) + m_i3 for the rows i < 3 of inv_mvp; dir = d / sqrt((d_0^2 +
//   d_1^2) + d_2^2);
//   VoxelCube::intersect (voxel.rs:239-334) as _cube_intersect_planes runs
//   it: for each axis, the axis-parallel case (two points), then for each
//   of the axis's two faces the face's corner a where it lies on the ray's
//   line, else the hit b = e + dir * t if t >= 0 and b is in the cube. The
//   plain version pushes a and b separately; the two conditions exclude
//   each other, so the kernel pushes the selected point once a face (12
//   pushes a ray, not 18). A push goes to slot min(cnt, 7) of eight and
//   counts on; then a stable sort by distance to e, and for cnt > 2 the
//   reference's scrambling "dedupe" (i = 1; for j < cnt: if p[i] != p[j]
//   { p[i] = p[j]; i = j }); start = p[0], end = p[cnt == 1 ? 0 : 1];
//   t_max = fmin(fmin(t_0, t_1), t_2), t_i = (end_i - start_i) / dir_i, with
//   jnp.fmin's rule (a if a < b or b is NaN, else b); alive = cnt > 0 and
//   t_max >= 0.
// The sort is the plain version's: rank_j = #{k : d_k < d_j or (d_k == d_j
// and k < j)} over the distances (3e38 for an empty slot), slot p takes
// the last j of rank p, and zeros where no slot has rank p. Where a
// distance is NaN or inf two slots can share a rank, which no insertion sort
// gives, so the ranks are counted as there.
//
// Two passes over the pushes. The two-slot pass keeps slots 0 and 1 and
// the count in registers, and flags the ray where it pushed more than two
// points or a kept distance is not below 3e38. An unflagged ray (every ray
// that misses the cube or crosses it through two faces: all but one of the
// bench's 5,184,000 orbit rays) needs the sort of two points only, one
// compare-and-swap, made on the squared distances (a root only where they
// are within 2^-20 of each other, closer()); a flagged ray (grazing an edge
// or a corner, or from an eye ~1e19 away) runs the eight-slot path: the
// pushes again, one axis at a time, into eight slots in the thread's column
// of shared memory, the ranks, and the dedupe streamed over the sorted
// slots.
//
// The frame's constants (e, inv_mvp) are read from device memory, never
// passed by value: under a captured frame they are the graph's input
// buffers, and a value passed at capture would freeze frame 0's camera.
// What each pixel derives from them alone (the reduced positions and the
// face corners) it computes itself, once: a few operations on values every
// thread of the warp reads from one address.
//
// What bounds it on the card: the bytes it writes. Seven float32 planes
// (start, dir, t_max) and one byte plane (alive) are 29 B a ray, 15.0 MB at
// 960 x 540: 0.0045 ms at 3.35 TB/s. Its operations: about 340 float32
// operations a ray on the two-slot pass (a division or a square root
// counted as one), 0.0026 ms at 67 T/s for 518,400 rays; a flagged ray
// takes ~1,000 more. The instructions behind them bound it: each IEEE
// division is a sequence with a range check and a branch, 14 of them a
// ray. Split by probe builds (tools/voxel_setup_split.py, 960 x 540, the
// mean of the 10 orbit views, NVIDIA H100 80GB HBM3, 700.00 W): the stores
// alone 0.0057 ms, + the unprojection 0.0063, + the two-slot pass's pushes
// 0.0104, the whole kernel 0.0146 (0.0138 with the eight-slot path never
// taken); the design before, 18 pushes into eight register slots, read
// 0.0058 / 0.0064 / 0.0267 / 0.0294 (0.0178 without its sort) at 80
// registers. The design: one thread a pixel, a block of 32 x 4 pixels, so
// that each warp writes 128 contiguous bytes of every plane of one row
// (and no pixel divides by the width); no synchronisation; a warp skips the
// axis-parallel case where none of its rays runs along the axis, and a
// face's push where none of its rays pushes; the eight-slot path's pushes
// are a loop over the axes, so that its registers stay within the
// two-slot pass's: 30 registers and 12 KB of shared memory a block, 16
// blocks (64 warps) an SM, no stack frame and no spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kCols = 32;  // a block's columns: each warp is 32 pixels of one row
constexpr int kRows = 4;   // a block's rows
constexpr int kThreads = kCols * kRows;
constexpr int kSlots = 8;        // MAX_POINTS: the intersection's point slots
constexpr float kFar = 3.0e38f;  // the JAX package's stand-in for +inf in sorts
constexpr float kApart = 1.0f - 0x1p-20f;  // closer(): squares this far apart need no root

// What every push of a ray reads: the eye, the direction, the cube's side.
struct Ray {
  float e0, e1, e2, dx, dy, dz, L;
};

// The two-slot pass: slots 0 and 1 and the count of points pushed.
struct TwoSlots {
  float x0 = 0.0f, y0 = 0.0f, z0 = 0.0f, x1 = 0.0f, y1 = 0.0f, z1 = 0.0f;
  int cnt = 0;
  __device__ __forceinline__ void push(bool cond, float x, float y, float z) {
    const bool to0 = cond && cnt == 0, to1 = cond && cnt == 1;
    x0 = to0 ? x : x0, y0 = to0 ? y : y0, z0 = to0 ? z : z0;
    x1 = to1 ? x : x1, y1 = to1 ? y : y1, z1 = to1 ? z : z1;
    cnt += cond ? 1 : 0;
  }
};

// The eight-slot path: slot min(cnt, 7) of eight takes the point, in the
// thread's own column of shared memory (coordinate c of slot k at
// col[(3 * k + c) * kThreads]: a warp's 32 lanes on 32 banks).
struct SharedSlots {
  float* col;
  int cnt = 0;
  __device__ __forceinline__ void push(bool cond, float x, float y, float z) {
    if (cond) {
      float* p = col + 3 * min(cnt, kSlots - 1) * kThreads;
      p[0] = x, p[kThreads] = y, p[2 * kThreads] = z;
      ++cnt;
    }
  }
  // slot k (0 <= k <= kSlots) as the plain version holds it: zeros where no
  // point came
  __device__ __forceinline__ void get(int k, float& x, float& y, float& z) const {
    const float* p = col + 3 * min(k, kSlots - 1) * kThreads;
    const bool full = k < cnt;
    x = full ? p[0] : 0.0f, y = full ? p[kThreads] : 0.0f, z = full ? p[2 * kThreads] : 0.0f;
  }
};

// jnp.fmin: a where a < b or b is NaN, else b (of two zeros, b).
__device__ __forceinline__ float fmin_jnp(float a, float b) {
  return (a < b || isnan(b)) ? a : b;
}

// The squared distance of (x, y, z) to the eye, summed as the plain version
// sums it; the distance is its sqrtf.
__device__ __forceinline__ float squared(float x, float y, float z, const Ray& r) {
  const float dx = x - r.e0, dy = y - r.e1, dz = z - r.e2;
  return (dx * dx + dy * dy) + dz * dz;
}

__device__ __forceinline__ float distance(float x, float y, float z, const Ray& r) {
  return sqrtf(squared(x, y, z, r));
}

// sqrtf(q1) < sqrtf(q0) for finite q0, q1 >= 0, with square roots only
// where q1 >= kApart * q0. Further apart, sqrt(q1) <= (1 - 2^-22) sqrt(q0)
// (the product rounds by at most 2^-21 of q0 where q0 >= 2^-129; below
// that q1 < q0 is a step of 2^-149, over 2^-20 of q0), more than the
// 2^-24 by which each root's rounding moves it: they cannot round to one
// float, and a zero q1 has the smaller root.
__device__ __forceinline__ bool closer(float q1, float q0) {
  return q1 < q0 && (q1 < q0 * kApart || sqrtf(q1) < sqrtf(q0));
}

// One axis of VoxelCube::intersect's pushes (_cube_intersect_planes), in
// order: the axis-parallel case's two points, then one push a face: the
// face's corner a where it lies on the ray's line, else the hit b. The two
// are exclusive (on_line / !on_line), so one push of the selected point is
// the plain version's two pushes. What a face takes from the eye and the
// side alone (a, a - e) it computes once. ``axis`` is a constant where the
// caller unrolls its loop over the axes (n's products by 1 fold away, its
// products by 0 stay), a register where it does not.
template <class Slots>
__device__ __forceinline__ void intersect_axis(const Ray& r, Slots& s, int axis, bool& handled) {
  const float n0 = axis == 0 ? 1.0f : 0.0f, n1 = axis == 1 ? 1.0f : 0.0f, n2 = axis == 2 ? 1.0f : 0.0f;
  const float u0 = 1.0f - n0, u1 = 1.0f - n1, u2 = 1.0f - n2;
  // dir x n == 0: the ray runs along the axis (voxel.rs:263-279)
  const float c0 = r.dy * n2 - r.dz * n1, c1 = r.dz * n0 - r.dx * n2, c2 = r.dx * n1 - r.dy * n0;
  const bool parallel = c0 == 0.0f && c1 == 0.0f && c2 == 0.0f && !handled;
  if (__any_sync(__activemask(), parallel)) {  // rare: the warp skips what no lane pushes
    const float q0 = u0 * r.e0, q1 = u1 * r.e1, q2 = u2 * r.e2;  // the reduced position
    const bool inside = q0 >= 0.0f && q0 <= r.L && q1 >= 0.0f && q1 <= r.L && q2 >= 0.0f && q2 <= r.L;
    const bool cond = parallel && inside;
    s.push(cond, q0, q1, q2);
    s.push(cond, q0 + r.L * u0, q1 + r.L * u1, q2 + r.L * u2);
    handled = handled || cond;
  }

  const float dn = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
  const bool perp = dn == 0.0f;
#pragma unroll
  for (int face = 0; face < 2; ++face) {
    const float scale = r.L * (face == 0 ? 0.0f : 1.0f);
    const float a0 = n0 * scale, a1 = n1 * scale, a2 = n2 * scale;
    const float ap0 = a0 - r.e0, ap1 = a1 - r.e1, ap2 = a2 - r.e2;
    const float k0 = ap1 * r.dz - ap2 * r.dy, k1 = ap2 * r.dx - ap0 * r.dz, k2 = ap0 * r.dy - ap1 * r.dx;
    const bool on_line = k0 == 0.0f && k1 == 0.0f && k2 == 0.0f;  // a is the hit itself
    const float t = (axis == 0 ? ap0 : (axis == 1 ? ap1 : ap2)) / dn;
    const float b0 = r.e0 + r.dx * t, b1 = r.e1 + r.dy * t, b2 = r.e2 + r.dz * t;
    const bool in_bounds = b0 >= 0.0f && b0 <= r.L && b1 >= 0.0f && b1 <= r.L && b2 >= 0.0f && b2 <= r.L;
    const bool hit = !parallel && !perp && (on_line || (t >= 0.0f && in_bounds));
    if (__any_sync(__activemask(), hit)) s.push(hit, on_line ? a0 : b0, on_line ? a1 : b1, on_line ? a2 : b2);
  }
}

// The eight-slot path, for a ray the two-slot pass flagged: the pushes again
// into eight slots; ranks over their distances (kFar for an empty slot);
// sorted slot p is the last slot of rank p, or zeros; where cnt > 2 the
// reference's dedupe over the sorted slots (i = 1; for j < cnt: if p[i] !=
// p[j] { p[i] = p[j]; i = j }), streamed: it writes only p[i] with i < j
// (or p[1] at j = 0) and reads p[j], so p[0], p[1] and the current p[i]
// are all it keeps → cnt, and sorted slots 0 and 1 after the dedupe. Its
// pushes go one axis at a time (a loop the compiler keeps), so that its
// registers stay within the two-slot pass's and the rays that never come
// here keep their occupancy.
__device__ __forceinline__ int eight_slots(const Ray& r, float* col, float& sx, float& sy, float& sz,
                                           float& ex, float& ey, float& ez) {
  SharedSlots s{col};
  bool handled = false;
#pragma unroll 1
  for (int axis = 0; axis < 3; ++axis) intersect_axis(r, s, axis, handled);
  const int cnt = s.cnt;
  float dk[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    float x, y, z;
    s.get(k, x, y, z);
    dk[k] = k < cnt ? distance(x, y, z, r) : kFar;
  }
  uint32_t ranks = 0;  // 4 bits a slot
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    uint32_t rank = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (k != j) rank += (dk[k] < dk[j] || (dk[k] == dk[j] && k < j)) ? 1u : 0u;
    }
    ranks |= rank << (4 * j);
  }
  auto sorted = [&](int p, float& x, float& y, float& z) {
    int last = kSlots;  // no slot: the empty slot's zeros
#pragma unroll
    for (int j = 0; j < kSlots; ++j) last = ((ranks >> (4 * j)) & 15u) == (uint32_t)p ? j : last;
    s.get(last, x, y, z);
  };
  sorted(0, sx, sy, sz);
  sorted(1, ex, ey, ez);
  if (cnt > 2) {
    int i = 1;
    float ix = ex, iy = ey, iz = ez;  // p[i]
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (j < cnt) {
        float jx, jy, jz;
        if (j == 0) {
          jx = sx, jy = sy, jz = sz;
        } else if (j == 1) {
          jx = ex, jy = ey, jz = ez;
        } else {
          sorted(j, jx, jy, jz);
        }
        if (ix != jx || iy != jy || iz != jz) {  // NaN differs from itself
          if (i == 0) sx = jx, sy = jy, sz = jz;
          if (i == 1) ex = jx, ey = jy, ez = jz;
          i = j, ix = jx, iy = jy, iz = jz;
        }
      }
    }
  }
  return cnt;
}

__global__ void __launch_bounds__(kThreads)
voxel_setup_kernel(int width, int height, float length, const float* __restrict__ eye,
                   const float* __restrict__ inv_mvp, float* __restrict__ planes,
                   uint8_t* __restrict__ alive) {
  __shared__ float slots[3 * kSlots * kThreads];  // the eight-slot path's, a column a thread
  const int px = blockIdx.x * kCols + threadIdx.x, py = blockIdx.y * kRows + threadIdx.y;
  if (px >= width || py >= height) return;
  const int n = width * height, i = py * width + px;

  // unprojection (_unproject_dir_planes)
  const float ndc_x = ((float)px * 2.0f) / (float)width - 1.0f;
  const float ndc_y = 1.0f - ((float)py * 2.0f) / (float)height;
  float d[3];
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const float* m = inv_mvp + 4 * row;
    d[row] = ((__ldg(m) * ndc_x + __ldg(m + 1) * ndc_y) + __ldg(m + 2)) + __ldg(m + 3);
  }
  const float norm = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  const float dx = d[0] / norm, dy = d[1] / norm, dz = d[2] / norm;
  const Ray r{__ldg(eye), __ldg(eye + 1), __ldg(eye + 2), dx, dy, dz, length};

  // VoxelCube::intersect (_cube_intersect_planes)
  TwoSlots s;
  bool handled = false;  // the axis-parallel case was taken on an earlier axis
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) intersect_axis(r, s, axis, handled);
  // the two-slot pass's verdict: more than two points, or a kept distance
  // not below kFar (sqrtf(q) < kFar exactly where q < inf: sqrtf of the
  // largest float is 1.8e19)
  const float sq0 = squared(s.x0, s.y0, s.z0, r), sq1 = squared(s.x1, s.y1, s.z1, r);
  const bool eight = s.cnt > 2 || (s.cnt >= 1 && !(sq0 < INFINITY)) || (s.cnt == 2 && !(sq1 < INFINITY));
  float sx = s.x0, sy = s.y0, sz = s.z0, ex = s.x1, ey = s.y1, ez = s.z1;
  int cnt = s.cnt;
  if (eight) {
    cnt = eight_slots(r, slots + threadIdx.y * kCols + threadIdx.x, sx, sy, sz, ex, ey, ez);
  } else if (cnt == 2 && closer(sq1, sq0)) {  // the sort of two: stable, equal distances keep their order
    sx = s.x1, sy = s.y1, sz = s.z1;
    ex = s.x0, ey = s.y0, ez = s.z0;
  }
  if (cnt == 1) ex = sx, ey = sy, ez = sz;

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
  const dim3 grid((width + kCols - 1) / kCols, (height + kRows - 1) / kRows);
  if ((long long)width * height > 0x7FFFFFFFLL || grid.y > 65535) return (int)cudaErrorInvalidValue;
  voxel_setup_kernel<<<grid, dim3(kCols, kRows), 0, (cudaStream_t)stream>>>(width, height, length, eye,
                                                                            inv_mvp, planes, alive);
  return (int)cudaGetLastError();
}
