// Triangle set-up: from the draws' attributes, or the vertex shader's
// outputs, to the slot records that the binning kernels read, one CUDA
// thread per slot.
//
// Replaces no Pallas kernel but the XLA fusions of the JAX package's
// triangle set-up: the builtin shaders' vertex stage
// (f_renderer_tpu/pipeline/geometry.py:287-308 over shaders/builtin.py:
// 52-166, whose _mat_vec4 chains XLA fuses), the chain after it in
// geometry.py:300-350 (the w and frustum masks, 1/w, the viewport and the
// saturating cast, _setup_core's winding repair and top-left flags),
// render.py:113-202 (the draws' concatenation and the ps boundary quirk) and
// raster_pallas.py:178 pack_setup (the edge coefficients in wrapped int32,
// the clamped bboxes, the float rows). The port ran them as several hundred
// PyTorch ops a frame, each a node of the captured frame's graph. The plain
// version is render.build_packed_plain: raster.slot_records of
// raster.pack_binned(render.build_triangles(...)); every record the kernels
// write equals it bit for bit (invalid and padding slots too; a NaN equal to
// any NaN, its payload kept, since a float is copied as its bits), and so
// does the (2, m_pad) bbox array, because they take its float32
// operations in its order: no FMA (--fmad=false), IEEE division and square
// root, the viewport left-associative ((nx + 1) * W) * 0.5, the Rust-style
// cast (NaN → 0, clamp to [-2^31, 2147483520], truncate), swap = nz > 0 (a
// NaN never swaps), the top-left rule on the integer coordinates, and the
// edge coefficients in uint32 arithmetic, which wraps as the JAX package's
// int32 does (signed overflow is undefined in C++).
//
// A frame's slots lie as TriangleBuffer.concat lays them: per draw d, its
// F_d path-A slots (one per face), then nb = clip_cap * MAX_FAN path-B
// slots (the fan triangles of its clipped faces); then the padding slots
// up to m_pad. A slot's record (m_pad records of rec words: the 12 int32
// rows, the 9 + 3C float32 rows as bits, zeros to whole 32-byte sectors, as
// csrc/bin_pairs.cu reads them) is staged in shared memory, a row of rec + 1
// words a thread (odd: a warp's stores meet each bank once), and each warp
// writes its 32 records out whole, rec words at a time; the bbox words go
// straight to the (2, m_pad) array, coalesced. A bulk copy
// (cp.async.bulk) would need the shared image to be the records' own
// layout, rec words a thread, and 48 words a slot put a warp's stores on
// two banks. One launch a frame where no face clips (the bench camera),
// three where one does:
//
//   tri_setup_kernel (a thread a slot): per face, its three corners' clip
//     positions and varyings, read from the vertex shader's planes
//     (kPlanes: a custom shader, run by PyTorch) or computed here by a
//     builtin's vertex stage from the draw's (F, 3, k) attributes and the
//     uniforms (kFlat, kTextured, kPhong, kGouraud: a template argument,
//     so the planes mode keeps its registers); then the masks (w != 0,
//     inside all six planes), the clip flag b (b_mask, and per draw the
//     number clipped), and the face's path-A slot. A vertex mode also
//     writes the planes the clip path gathers, at the corners of every
//     clipped face and of each draw's last face (its padding entries read
//     that face), and nowhere else. Every path-B slot gets the skip path's
//     values (zeros, invalid, order order_base), and every padding slot
//     zeros. The last block to finish (a ticket in the accumulator) reads
//     the frame's totals: it sets the condition of the frame's conditional
//     node (cudaGraphSetConditional, where the launch was captured with
//     one: some face clipped) and, where no face clipped, applies the ps
//     boundary quirk, whose per-draw partials are then whole;
//   tri_slots_kernel (the clip path's, after it: in the conditional node's
//     body): the path-B slots of each draw that clipped a face, from the fan
//     arrays the clip path wrote; a draw that clipped none keeps launch 1's;
//   tri_quirk_kernel (one block, after it): the ps boundary quirk from the
//     totals of both launches.
//
// Launch 1 and tri_slots_kernel reduce each draw's valid slots to a count
// and the least (order, slot) (an atomic maximum of its complement packed
// in 64 bits; orders are distinct among valid slots); the quirk's targets
// are the left searchsorted of each draw's start in the counts' cumulative
// sum, and the PS word of each draw's least slot takes its target. Where a
// face clipped, a fan slot may hold a draw's least slot, so the quirk waits
// for path B.
//
// The vertex stages take the plain shaders' float32 operations in their
// order: mvp = proj · (view · model), each entry summed left to right
// (math.mat_mul4), once a block into shared memory; clip = mvp · (x, y, z,
// 1) as math.mat_vec4's chain (the multiply by the 1.0 included, which
// keeps a NaN in m[i][3]); for phong and gouraud world = model · (x, y, z,
// 1); gouraud's _phong_lighting with normalize as v / sqrt(v · v) (IEEE
// __fsqrt_rn, __fdiv_rn), max0's rule for the lambert term (+0 for either
// zero, NaN kept), torch.clamp's before pow32 (five squarings), ambient +
// diff lc + (0.5 spec) lc left to right with the constants rounded to
// float32, and base · light where the draw has a colour.
//
// What bounds it on the card: bytes. In the planes mode it reads the vertex
// shader's four clip planes and 3C varying planes (per corner) and writes a
// record (4 rec bytes) and 8 bbox bytes per slot: 4 (4 + C) * 3 + 4 rec + 8
// bytes a face, ~344 MB at stress4k (a million faces, C = 8, rec = 48),
// 0.103 ms at 3.35 TB/s. The phong vertex mode reads 96 bytes a face of pos,
// uv and normal in their place (~296 MB, 0.088 ms), plus the planes of the
// few faces the clip path reads. Its ~150 operations a face (~400 with the
// phong stage) are far below the ALU rate. So one thread a slot, slots in
// column order: every warp reads 128 contiguous bytes of each plane, writes
// 32 records of consecutive slots, and reads a face's attribute record (36
// bytes of pos) beside its neighbours', the rest of each 128-byte line from
// L1. The per-draw sums are kept in registers across a thread's faces and reduced
// over the warp before their atomics, so a million faces of one draw make a
// few thousand atomics, not a million. At phong1080's size (6,424 faces,
// 10,112 slots, 1.9 MB) the launch is latency, not bytes: one launch where
// nothing clips (the clip path's kernels, and their nodes, run only on a
// frame that clips), the draw table in its parameters, a draw's four words
// side by side (no dependent loads to find a face's draw), and a tail of
// one acquire-release ticket a block and, in the last, one round of loads
// (a ticket that also summed the faces clipped, to spare the load of the
// total, left the phong mode an 8-byte stack frame). 128-thread blocks, because 32 and 64 were no faster at
// phong1080 and slower at stress4k; each corner's attributes loaded where
// they are used: loading a face's ahead of the uniforms' barrier took the
// phong mode from 90 to 128 registers and gouraud's to spills, and gained
// nothing (tools/setup_split.py).
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "kernels.h"

namespace {

// 4 warps a block: their staging rows (25 KB at C = 8) stay under the 48 KB
// a block gets without asking, and more blocks fit an SM (5 of launch 1's
// phong mode at 90 registers, where 256-thread blocks of 50 KB fit 2)
constexpr int kThreads = 128;
// grid-stride: 16 blocks an SM of an H100 (a grid of only the blocks the card
// holds at once, 6 an SM at stress4k, was slower there: tools/setup_split.py)
constexpr int kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxFan = 19;          // MAX_FAN: fan triangles of a clipped face
// tri_i32 rows (pipeline/raster.py); tri_f32: S0X..S2Y, RHW0..RHW2, then 3C varyings
constexpr int A01 = 0, B01 = 1, C01 = 2, A20 = 3, B20 = 4, C20 = 5, AREA2 = 6, ORDER = 7, MINXY = 8,
              MAXXY = 9, SLOT = 10, PS = 11, NF_I = 12;
constexpr int kCtx0 = 9;
// launch 1's inputs (shaders/builtin.py: VERTEX_KINDS): the vertex shader's planes, or a builtin's vertex stage
constexpr int kPlanes = 0, kFlat = 1, kTextured = 2, kPhong = 3, kGouraud = 4;
constexpr int kMaxCtx = 8;  // varyings a vertex stage carries in registers (a flat colour's width)
// a draw's words in FrTriSetupParams::draws
constexpr int kFaceOff = 0, kFaces = 1, kSlotBase = 2, kOrderBase = 3;

// Words of a slot's record (csrc/bin_pairs.cu: rec_words).
__host__ __device__ __forceinline__ int rec_words(int n_ctx) { return (NF_I + kCtx0 + 3 * n_ctx + 7) / 8 * 8; }

// This thread's staging row (rec + 1 words) in the block's dynamic shared memory.
__device__ __forceinline__ int32_t* staging_row(int32_t* stage, int rec) { return stage + threadIdx.x * (rec + 1); }

// Every lane of the warp calls this with its slot's column (-1: none),
// after staging its record: the warp's records written out whole, 32
// consecutive words a store. Where the 32 columns follow one another (a
// draw's slots) the warp writes its 32 records as one run of 32 rec words;
// magic = 2^32 / rec rounded up, so that __umulhi(i, magic) = i / rec for i
// < 32 rec (i rec < 2^32).
__device__ __forceinline__ void write_records(const int32_t* stage, int rec, unsigned magic, int col,
                                              int32_t* __restrict__ recs) {
  const int lane = threadIdx.x & 31;
  const int32_t* rows = stage + (threadIdx.x - lane) * (rec + 1);
  __syncwarp();
  const int c0 = __shfl_sync(kFull, col, 0);
  if (__all_sync(kFull, c0 >= 0 && col == c0 + lane)) {
    int32_t* dst = recs + (size_t)c0 * rec;
#pragma unroll 4
    for (int i = lane; i < 32 * rec; i += 32) dst[i] = rows[i + (int)__umulhi((unsigned)i, magic)];  // row j, word i - j rec
    __syncwarp();
    return;
  }
  for (int j = 0; j < 32; ++j) {
    const int cj = __shfl_sync(kFull, col, j);
    if (cj < 0) continue;
    int32_t* dst = recs + (size_t)cj * rec;
    for (int w = lane; w < rec; w += 32) dst[w] = rows[j * (rec + 1) + w];
  }
  __syncwarp();
}

struct PlanesIn {  // the vertex shader's clip (4, 3F) and ctx (C, 3F) planes
  const float* clip;
  const float* ctx;
};
template <int Kind>
using InputOf = std::conditional_t<Kind == kPlanes, PlanesIn, FrVertexArgs>;
// a vertex stage's varyings a corner: phong normal 3, pos 3, uv 2; gouraud colour 3; textured uv 2; flat up to 8
template <int Kind>
constexpr int kStageCtx = Kind == kTextured ? 2 : Kind == kGouraud ? 3 : kMaxCtx;

// Rust `f32 as i32` (geometry.f32_to_i32_sat): NaN → 0, saturate, truncate.
__device__ __forceinline__ int32_t sat_i32(float x) {
  x = isnan(x) ? 0.0f : x;
  x = fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
  return __float2int_rz(x);
}

// One slot's three vertices before the winding repair.
struct Tri {
  float nx[3], ny[3], sx[3], sy[3], rhw[3];
  int32_t ix[3], iy[3];
};

// A draw's running sums in one thread: faces clipped, valid slots, and the
// largest complement of (order, slot) (the least valid slot).
struct Partial {
  int d;
  int nclip, count;
  unsigned long long key;
};

struct Acc {  // views of the caller's zeroed accumulator (kernels.py: acc_layout)
  int32_t* nclip;              // [D]: faces clipped per draw
  int32_t* total;              // [1]: faces clipped in the frame
  uint32_t* ticket;            // [1]: blocks of launch 1 done
  int32_t* count;              // [D]: valid slots per draw
  unsigned long long* keys;    // [D]: max of ~((order ^ 2^31) << 32 | slot)
  __device__ Acc(int32_t* acc, int n_draws, int keys_word)
      : nclip(acc), total(acc + n_draws), ticket(reinterpret_cast<uint32_t*>(acc + n_draws + 1)),
        count(acc + n_draws + 2), keys(reinterpret_cast<unsigned long long*>(acc + keys_word)) {}
};

__device__ __forceinline__ void flush(const Partial& a, const Acc& acc) {
  if (a.d < 0) return;
  if (a.nclip) {
    atomicAdd(acc.nclip + a.d, a.nclip);
    atomicAdd(acc.total, a.nclip);
  }
  if (a.count) {
    atomicAdd(acc.count + a.d, a.count);
    atomicMax(acc.keys + a.d, a.key);
  }
}

// Every lane of the warp calls this last: where the lanes' sums are of one
// draw (or empty), one lane adds the warp's; else each lane adds its own.
__device__ __forceinline__ void flush_warp(Partial a, const Acc& acc) {
  const unsigned all = 0xffffffffu;
  const int d = __reduce_max_sync(all, a.d);
  if (!__all_sync(all, a.d == d || a.d < 0)) {
    flush(a, acc);
    return;
  }
  a.nclip = __reduce_add_sync(all, a.nclip);
  a.count = __reduce_add_sync(all, a.count);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long k = __shfl_xor_sync(all, a.key, o);
    a.key = k > a.key ? k : a.key;
  }
  a.d = d;
  if ((threadIdx.x & 31) == 0) flush(a, acc);
}

__device__ __forceinline__ void add_valid(Partial& a, int d, const Acc& acc, int32_t order, int col) {
  if (a.d != d) {
    flush(a, acc);
    a = {d, 0, 0, 0ull};
  }
  const unsigned long long key =
      (static_cast<unsigned long long>(static_cast<uint32_t>(order) ^ 0x80000000u) << 32) |
      static_cast<uint32_t>(col);
  a.count += 1;
  a.key = ~key > a.key ? ~key : a.key;
}

// _setup (winding repair, top-left flags) and pack_setup for one slot →
// its record, staged at w (its rec words, padding zeroed), and its bbox
// words bb[col], bb[m_pad + col]; ctx(v, c): varying c of vertex v, called with
// run-time indices where NC is 0 (a read from memory), else with
// compile-time ones (registers) for the first NC of the p.n_ctx varyings.
// Returns whether the slot is valid after the cull.
template <int NC, class Ctx>
__device__ __forceinline__ bool store_slot(const FrTriSetupParams& p, const Tri& t, bool valid, int32_t order,
                                           int32_t ps, int col, Ctx ctx, int32_t* __restrict__ w,
                                           int32_t* __restrict__ bb) {
  const float nz = (t.nx[1] - t.nx[0]) * (t.ny[2] - t.ny[0]) - (t.ny[1] - t.ny[0]) * (t.nx[2] - t.nx[0]);
  bool swap = nz > 0.0f;  // NaN → no swap
  if (p.cull) {
    valid = valid && !swap;
    swap = false;
  }
  // vertex v of the repaired winding: 0, then 1 and 2 exchanged where swap
  // (selects on compile-time indices, so the arrays stay in registers)
  const int src[3] = {0, swap ? 2 : 1, swap ? 1 : 2};
  const int32_t x[3] = {t.ix[0], swap ? t.ix[2] : t.ix[1], swap ? t.ix[1] : t.ix[2]};
  const int32_t y[3] = {t.iy[0], swap ? t.iy[2] : t.iy[1], swap ? t.iy[1] : t.iy[2]};
  // top-left rule on integer coords (renderer.rs:26-29): edges 0→1, 1→2, 2→0
  const int tl0 = ((y[0] == y[1] && x[0] < x[1]) || y[0] > y[1]) ? 1 : 0;
  const int tl1 = ((y[1] == y[2] && x[1] < x[2]) || y[1] > y[2]) ? 1 : 0;
  const int tl2 = ((y[2] == y[0] && x[2] < x[0]) || y[2] > y[0]) ? 1 : 0;
  int32_t mnx = 0, mny = 0, mxx = 0, mxy = 0;
  if (valid) {
    mnx = min(max(min(min(x[0], x[1]), x[2]), 0), p.width);
    mxx = min(max(max(max(x[0], x[1]), x[2]), 0), p.width);
    mny = min(max(min(min(y[0], y[1]), y[2]), 0), p.height);
    mxy = min(max(max(max(y[0], y[1]), y[2]), 0), p.height);
  }
  const uint32_t x0 = x[0], x1 = x[1], x2 = x[2], y0 = y[0], y1 = y[1], y2 = y[2];
  const uint32_t dy01 = y1 - y0, dx01 = x1 - x0, dy20 = y0 - y2, dx20 = x0 - x2;
  const uint32_t area2 = (dx01 * (y2 - y0) - dy01 * (x2 - x0)) - (uint32_t)((1 - tl0) + (1 - tl1) + (1 - tl2));
  const uint32_t c01 = (x0 * dy01 - y0 * dx01) - (uint32_t)(1 - tl0);
  const uint32_t c20 = (x2 * dy20 - y2 * dx20) - (uint32_t)(1 - tl2);
  w[A01] = (int32_t)(0u - dy01);
  w[B01] = (int32_t)dx01;
  w[C01] = (int32_t)c01;
  w[A20] = (int32_t)(0u - dy20);
  w[B20] = (int32_t)dx20;
  w[C20] = (int32_t)c20;
  w[AREA2] = (int32_t)area2;
  w[ORDER] = order;
  w[MINXY] = mnx | (mny << 16);
  w[MAXXY] = mxx | (mxy << 16);
  w[SLOT] = col;
  w[PS] = ps;
  bb[col] = mnx | (mny << 16);
  bb[(size_t)p.m_pad + col] = mxx | (mxy << 16);
  int32_t* tf = w + NF_I;  // the float rows, as bits
  const float sx[3] = {t.sx[0], swap ? t.sx[2] : t.sx[1], swap ? t.sx[1] : t.sx[2]};
  const float sy[3] = {t.sy[0], swap ? t.sy[2] : t.sy[1], swap ? t.sy[1] : t.sy[2]};
  const float rhw[3] = {t.rhw[0], swap ? t.rhw[2] : t.rhw[1], swap ? t.rhw[1] : t.rhw[2]};
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    tf[2 * v] = __float_as_int(sx[v]);
    tf[2 * v + 1] = __float_as_int(sy[v]);
    tf[6 + v] = __float_as_int(rhw[v]);
  }
  const int n_ctx = p.n_ctx;
  if constexpr (NC == 0) {
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      for (int c = 0; c < n_ctx; ++c) tf[kCtx0 + v * n_ctx + c] = __float_as_int(ctx(src[v], c));
    }
  } else {
#pragma unroll
    for (int v = 0; v < 3; ++v) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < n_ctx) {
          tf[kCtx0 + v * n_ctx + c] = __float_as_int(v == 0 ? ctx(0, c) : (swap ? ctx(3 - v, c) : ctx(v, c)));
        }
      }
    }
  }
  for (int r = NF_I + kCtx0 + 3 * n_ctx; r < rec_words(n_ctx); ++r) w[r] = 0;
  return valid;
}

// The draw that face i belongs to: the last d with its first face
// draws[d][kFaceOff] <= i (the table is in the launch's parameters, a
// draw's four words side by side: no load waits on another).
__device__ __forceinline__ int draw_of(const int32_t (*draws)[4], int n_draws, int i) {
  int lo = 0, hi = n_draws - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (draws[mid][kFaceOff] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The uniforms of a vertex stage, in shared memory: mvp = proj · (view ·
// model) as math.mat_mul4 sums each entry, model, and the eye (gouraud).
struct Uniforms {
  float mvp[16], model[16], eye[3];
};

__device__ __forceinline__ float mul4_entry(const float* a, const float* b, int i, int j) {
  return ((a[4 * i] * b[j] + a[4 * i + 1] * b[4 + j]) + a[4 * i + 2] * b[8 + j]) + a[4 * i + 3] * b[12 + j];
}

// Every thread of the block calls this (it syncs).
__device__ void load_uniforms(const FrVertexArgs& a, Uniforms& u, float* vm) {
  const int t = threadIdx.x;
  if (t < 16) {
    vm[t] = mul4_entry(a.view, a.model, t >> 2, t & 3);
    u.model[t] = a.model[t];
  }
  if (t < 3 && a.view_pos != nullptr) u.eye[t] = a.view_pos[t];
  __syncthreads();
  if (t < 16) u.mvp[t] = mul4_entry(a.proj, vm, t >> 2, t & 3);
  __syncthreads();
}

// Row i of math.mat_vec4(m, (x, y, z, 1)): the multiply by the 1.0 kept.
__device__ __forceinline__ float mat_row(const float* m, int i, float x, float y, float z) {
  return ((m[4 * i] * x + m[4 * i + 1] * y) + m[4 * i + 2] * z) + m[4 * i + 3] * 1.0f;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return (ax * bx + ay * by) + az * bz;
}

// math.normalize: v / sqrt(v · v), correctly rounded.
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n = __fsqrt_rn(dot3(x, y, z, x, y, z));
  x = __fdiv_rn(x, n);
  y = __fdiv_rn(y, n);
  z = __fdiv_rn(z, n);
}

// shaders/builtin.py:_phong_lighting at one vertex → light[3].
__device__ __forceinline__ void phong_lighting(const FrVertexArgs& a, const Uniforms& u, float nx, float ny, float nz,
                                               float wx, float wy, float wz, float light[3]) {
  normalize3(nx, ny, nz);
  float lx = a.light_pos[0] - wx, ly = a.light_pos[1] - wy, lz = a.light_pos[2] - wz;
  normalize3(lx, ly, lz);
  float diff = dot3(nx, ny, nz, lx, ly, lz);
  diff = (diff > 0.0f || isnan(diff)) ? diff : 0.0f;  // max0: +0 for either zero, NaN kept
  float vx = u.eye[0] - wx, vy = u.eye[1] - wy, vz = u.eye[2] - wz;
  normalize3(vx, vy, vz);
  // reflect(-light_dir, n) = normalize((2 (L·n)) n - L), L = -light_dir
  const float bx = -lx, by = -ly, bz = -lz;
  const float d2 = 2.0f * dot3(bx, by, bz, nx, ny, nz);
  float rx = d2 * nx - bx, ry = d2 * ny - by, rz = d2 * nz - bz;
  normalize3(rx, ry, rz);
  float spec = dot3(vx, vy, vz, rx, ry, rz);
  spec = spec < 0.0f ? 0.0f : spec;  // torch.clamp(min=0): NaN kept
#pragma unroll
  for (int k = 0; k < 5; ++k) spec = spec * spec;  // pow32
  const float s = 0.5f * spec;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lc = a.light_color[c];
    light[c] = (lc * 0.1f + diff * lc) + s * lc;
  }
}

// A builtin's vertex stage at corner v of face fl of draw d → its clip
// position and varyings, in codec order (sorted names).
template <int Kind>
__device__ __forceinline__ void vertex_corner(const FrVertexArgs& a, const Uniforms& u, int n_ctx, int d, int fl,
                                              int v, float clip[4], float* vary) {
  const size_t corner = (size_t)fl * 3 + v;
  const float* pos = a.attr[d][0] + corner * 3;
  const float x = __ldg(pos), y = __ldg(pos + 1), z = __ldg(pos + 2);
#pragma unroll
  for (int r = 0; r < 4; ++r) clip[r] = mat_row(u.mvp, r, x, y, z);
  if constexpr (Kind == kFlat) {  // color(k)
    const float* color = a.attr[d][1] + corner * n_ctx;
#pragma unroll
    for (int c = 0; c < kMaxCtx; ++c) vary[c] = c < n_ctx ? __ldg(color + c) : 0.0f;
  } else if constexpr (Kind == kTextured) {  // uv(2)
    const float* uv = a.attr[d][1] + corner * 2;
    vary[0] = __ldg(uv);
    vary[1] = __ldg(uv + 1);
  } else {
    const float wx = mat_row(u.model, 0, x, y, z), wy = mat_row(u.model, 1, x, y, z),
                wz = mat_row(u.model, 2, x, y, z);
    if constexpr (Kind == kPhong) {  // normal(3), pos(3), uv(2)
      const float* normal = a.attr[d][2] + corner * 3;
      const float* uv = a.attr[d][1] + corner * 2;
      vary[0] = __ldg(normal);
      vary[1] = __ldg(normal + 1);
      vary[2] = __ldg(normal + 2);
      vary[3] = wx;
      vary[4] = wy;
      vary[5] = wz;
      vary[6] = __ldg(uv);
      vary[7] = __ldg(uv + 1);
    } else {  // gouraud: color(3), base · light where the draw has a colour
      const float* normal = a.attr[d][1] + corner * 3;
      float light[3];
      phong_lighting(a, u, __ldg(normal), __ldg(normal + 1), __ldg(normal + 2), wx, wy, wz, light);
      const float* base = a.attr[d][2];
#pragma unroll
      for (int c = 0; c < 3; ++c) vary[c] = base != nullptr ? __ldg(base + corner * 3 + c) * light[c] : light[c];
    }
  }
}

// Every thread of the block calls this after its last atomic → whether its
// block is the last of the grid to finish (a ticket in the accumulator),
// where every block's sums are in. One thread's acquire-release add, after
// the block's barrier (as cooperative groups' grid sync fences after its
// barrier), orders the block's atomics and records before its arrival, and
// the last block's loads after every block's.
__device__ __forceinline__ bool last_block(const Acc& acc) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t arrived;
    asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;" : "=r"(arrived) : "l"(acc.ticket) : "memory");
    last = arrived == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// Shared memory of the quirk's totals: each draw's count (cumulated in
// place) and its least slot's key.
constexpr int kTotalsWords = 3 * FR_MAX_DRAWS;

// The accumulator's totals in one round of loads by every thread of one
// block, into smem (kTotalsWords words, 8-byte aligned): with p.quirk, each
// draw's count and key; with total, the frame's faces clipped beside them.
__device__ __forceinline__ void load_totals(const FrTriSetupParams& p, const Acc& acc, int32_t* smem,
                                            int32_t* total) {
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + FR_MAX_DRAWS);
  if (total != nullptr && threadIdx.x == 0) *total = __ldcg(acc.total);
  if (p.quirk) {
    for (int d = threadIdx.x; d < p.n_draws; d += blockDim.x) {
      smem[d] = __ldcg(acc.count + d);
      keys[d] = __ldcg(acc.keys + d);
    }
  }
  __syncthreads();
}

// The ps boundary quirk (render.apply_ps_quirk_totals) from the totals
// load_totals put in smem, by every thread of the block: the counts'
// cumulative sum, then the PS word of each draw's least valid slot takes
// the left searchsorted of the draw's start in it.
__device__ void apply_quirk(const FrTriSetupParams& p, int32_t* __restrict__ recs, int32_t* smem) {
  const int n_draws = p.n_draws;
  int32_t* offsets = smem;
  const unsigned long long* keys = reinterpret_cast<const unsigned long long*>(smem + FR_MAX_DRAWS);
  if (threadIdx.x == 0) {
    for (int e = 1; e < n_draws; ++e) offsets[e] += offsets[e - 1];  // cumsum, as int32
  }
  __syncthreads();
  const int rec = rec_words(p.n_ctx);
  for (int d = threadIdx.x; d < n_draws; d += blockDim.x) {
    const int32_t start = d ? offsets[d - 1] : 0;
    if (offsets[d] == start) continue;  // no valid slot (counts are >= 0, their sum < 2^31)
    int target = 0;  // searchsorted(offsets, start, side="left")
    while (target < n_draws && offsets[target] < start) ++target;
    recs[(size_t)(uint32_t)(~keys[d]) * rec + PS] = target;
  }
}

// A frame's slots, a thread each: the faces (path A), each draw's path-B
// slots (the skip path's values), the padding slots; the draw table in p.
template <int Kind>
__global__ void __launch_bounds__(kThreads)
tri_setup_kernel(const __grid_constant__ FrTriSetupParams p, const __grid_constant__ InputOf<Kind> in,
                 int32_t* __restrict__ recs, int32_t* __restrict__ bb, uint8_t* __restrict__ b_mask, int32_t* acc_words,
                 int keys_word, cudaGraphConditionalHandle cond) {
  constexpr int NC = Kind == kPlanes ? 0 : kStageCtx<Kind>;
  extern __shared__ int32_t stage[];
  const int n_draws = p.n_draws, n_ctx = p.n_ctx, n_faces = p.n_faces, n_b = n_draws * p.nb;
  const int n_slots = n_faces + n_b + (p.m_pad - p.m);
  const Acc acc(acc_words, n_draws, keys_word);
  const size_t nc = 3 * (size_t)n_faces;  // corners: a plane's length
  const float wf = (float)p.width, hf = (float)p.height;
  __shared__ Uniforms u;
  __shared__ float vm[16];
  const int rec = rec_words(n_ctx);
  const unsigned magic = 0xFFFFFFFFu / (unsigned)rec + 1u;
  int32_t* row = staging_row(stage, rec);
  Partial part = {-1, 0, 0, 0ull};
  if constexpr (Kind != kPlanes) load_uniforms(in, u, vm);
  // a warp's 32 slots at a time (the loop is warp-uniform: write_records syncs the warp)
  for (int i0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31); i0 < n_slots; i0 += gridDim.x * blockDim.x) {
    const int i = i0 + (threadIdx.x & 31);
    int col = -1;
    if (i < n_faces) {
      const int d = draw_of(p.draws, n_draws, i);
      const int32_t* draw = p.draws[d];
      const int f = draw[kFaces], fl = i - draw[kFaceOff];
      const size_t base = 3 * (size_t)draw[kFaceOff] + fl;  // corner v is base + v * f
      float cl[3][4];  // a vertex mode's clip positions, kept for the planes it writes
      float vary[3][NC > 0 ? NC : 1];
      Tri t;
      bool w_ok = true, all_in = true;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        if constexpr (Kind == kPlanes) {
#pragma unroll
          for (int r = 0; r < 4; ++r) cl[v][r] = in.clip[r * nc + base + (size_t)v * f];
        } else {
          vertex_corner<Kind>(in, u, n_ctx, d, fl, v, cl[v], vary[v]);
        }
        const float x = cl[v][0], y = cl[v][1], z = cl[v][2], w = cl[v][3];
        w_ok = w_ok && w != 0.0f;
        all_in = all_in && (x >= -w) && (x <= w) && (y <= w) && (y >= -w) && (z >= 0.0f) && (z <= w);
        const float r = 1.0f / w;
        t.rhw[v] = r;
        t.nx[v] = x * r;
        t.ny[v] = y * r;
        t.sx[v] = ((t.nx[v] + 1.0f) * wf) * 0.5f;
        t.sy[v] = ((1.0f - t.ny[v]) * hf) * 0.5f;
        t.ix[v] = sat_i32(t.sx[v] + 0.5f);
        t.iy[v] = sat_i32(t.sy[v] + 0.5f);
      }
      const bool clipped = w_ok && !all_in;
      b_mask[i] = clipped ? 1 : 0;
      if (clipped) {
        if (part.d != d) {
          flush(part, acc);
          part = {d, 0, 0, 0ull};
        }
        part.nclip += 1;
      }
      if constexpr (Kind != kPlanes) {
        if (clipped || fl == f - 1) {  // the planes the clip path gathers (geometry._clip_path)
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const size_t idx = base + (size_t)v * f;
#pragma unroll
            for (int r = 0; r < 4; ++r) in.clip[r * nc + idx] = cl[v][r];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              if (c < n_ctx) in.ctx[c * nc + idx] = vary[v][c];
            }
          }
        }
      }
      col = draw[kSlotBase] + fl;
      const int32_t order = (int32_t)((uint32_t)draw[kOrderBase] + (uint32_t)fl * (uint32_t)kMaxFan);
      bool valid;
      if constexpr (Kind == kPlanes) {
        valid = store_slot<0>(p, t, w_ok && all_in, order, d, col,
                              [&](int v, int c) { return in.ctx[(size_t)c * nc + base + (size_t)v * f]; }, row, bb);
      } else {
        valid = store_slot<NC>(p, t, w_ok && all_in, order, d, col, [&](int v, int c) { return vary[v][c]; }, row, bb);
      }
      if (p.quirk && valid) add_valid(part, d, acc, order, col);
    } else if (i < n_faces + n_b) {  // a path-B slot: the skip path's values (geometry._skip_clip_path)
      const int j = i - n_faces, d = j / p.nb;
      col = p.draws[d][kSlotBase] + p.draws[d][kFaces] + (j - d * p.nb);
      store_slot<0>(p, Tri{}, false, p.draws[d][kOrderBase], d, col, [](int, int) { return 0.0f; }, row, bb);
    } else if (i < n_slots) {  // a padding slot: zeros
      col = p.m + (i - n_faces - n_b);
      for (int r = 0; r < rec; ++r) row[r] = 0;
      bb[col] = 0;
      bb[(size_t)p.m_pad + col] = 0;
    }
    write_records(stage, rec, magic, col, recs);
  }
  flush_warp(part, acc);
  if (!last_block(acc)) return;
  __shared__ int32_t total;
  load_totals(p, acc, stage, &total);  // the staging rows hold at least 32 (24 + 1) >= kTotalsWords words
  if (threadIdx.x == 0 && p.cond) cudaGraphSetConditional(cond, total > 0 ? 1u : 0u);
  if (p.quirk && total == 0) apply_quirk(p, recs, stage);  // else after path B (the conditional node's body)
}

// The clip path's path-B slots (in the conditional node's body, after the
// clip path): fan holds per draw fan_words = nb (23 + 3C) int32 words, the
// clip path's arrays slot-major: ndc (nb, 3, 2) f32, spf (nb, 3, 2) f32, spi
// (nb, 3, 2) i32, rhw (nb, 3) f32, ctx (nb, 3, C) f32, valid (nb) i32, order
// (nb) i32, read only where the draw clipped a face (launch 1's skip-path
// slots stay elsewhere).
__global__ void __launch_bounds__(kThreads)
tri_slots_kernel(const __grid_constant__ FrTriSetupParams p, const int32_t* __restrict__ fan,
                 int32_t* __restrict__ recs, int32_t* __restrict__ bb, int32_t* acc_words, int keys_word) {
  extern __shared__ int32_t stage[];
  const int n_draws = p.n_draws, nb = p.nb, n_ctx = p.n_ctx;
  const Acc acc(acc_words, n_draws, keys_word);
  const size_t fan_words = (size_t)nb * (23 + 3 * n_ctx);
  const int n_b = n_draws * nb, rec = rec_words(n_ctx);
  const unsigned magic = 0xFFFFFFFFu / (unsigned)rec + 1u;
  int32_t* row = staging_row(stage, rec);
  Partial part = {-1, 0, 0, 0ull};
  for (int j0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31); j0 < n_b; j0 += gridDim.x * blockDim.x) {
    const int j = j0 + (threadIdx.x & 31);
    const int d = j < n_b ? j / nb : 0;
    int col = -1;
    if (j < n_b && acc.nclip[d] > 0) {
      const int s = j - d * nb;
      col = p.draws[d][kSlotBase] + p.draws[d][kFaces] + s;
      const int32_t* fd = fan + (size_t)d * fan_words;
      Tri t;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const size_t e = ((size_t)s * 3 + v) * 2;
        t.nx[v] = __int_as_float(fd[e]);
        t.ny[v] = __int_as_float(fd[e + 1]);
        t.sx[v] = __int_as_float(fd[6 * (size_t)nb + e]);
        t.sy[v] = __int_as_float(fd[6 * (size_t)nb + e + 1]);
        t.ix[v] = fd[12 * (size_t)nb + e];
        t.iy[v] = fd[12 * (size_t)nb + e + 1];
        t.rhw[v] = __int_as_float(fd[18 * (size_t)nb + (size_t)s * 3 + v]);
      }
      const int32_t* fctx = fd + 21 * (size_t)nb + (size_t)s * 3 * n_ctx;
      const bool valid_in = fd[(size_t)(21 + 3 * n_ctx) * nb + s] != 0;
      const int32_t order = fd[(size_t)(22 + 3 * n_ctx) * nb + s];
      const bool valid = store_slot<0>(p, t, valid_in, order, d, col,
                                       [&](int v, int c) { return __int_as_float(fctx[v * n_ctx + c]); }, row, bb);
      if (p.quirk && valid) add_valid(part, d, acc, order, col);
    }
    write_records(stage, rec, magic, col, recs);
  }
  flush_warp(part, acc);
}

// The ps boundary quirk after the clip path's slots; one block.
__global__ void __launch_bounds__(256)
tri_quirk_kernel(const __grid_constant__ FrTriSetupParams p, int32_t* __restrict__ recs, int32_t* acc_words,
                 int keys_word) {
  __shared__ unsigned long long smem[kTotalsWords / 2];
  int32_t* totals = reinterpret_cast<int32_t*>(smem);
  load_totals(p, Acc(acc_words, p.n_draws, keys_word), totals, nullptr);
  apply_quirk(p, recs, totals);
}

// The launch shape of a staging kernel over n slots: kThreads a block
// (fewer where the records are too long for their rows), a grid-stride
// grid, and its dynamic shared memory: rec + 1 words a thread.
struct Shape {
  int blocks, threads;
  size_t smem;
};

template <typename K>
cudaError_t staged_shape(K kernel, long long n, int rec, Shape* sh) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const size_t per_warp = 32 * sizeof(int32_t) * (size_t)(rec + 1);
  const long long warps = ((long long)optin - (long long)fa.sharedSizeBytes) / (long long)per_warp;
  if (warps < 1) return cudaErrorInvalidValue;
  sh->threads = 32 * (int)(warps < kThreads / 32 ? warps : kThreads / 32);
  sh->smem = per_warp * (size_t)(sh->threads / 32);
  const long long b = (n + sh->threads - 1) / sh->threads;
  sh->blocks = (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
  if (sh->smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh->smem);
}

template <int Kind, typename In>
cudaError_t launch_setup(const FrTriSetupParams& p, const In& in, int32_t* recs, int32_t* bbox, uint8_t* b_mask,
                         int32_t* acc, int keys_word, unsigned long long cond, cudaStream_t s) {
  Shape sh;
  const long long n = (long long)p.n_faces + (long long)p.n_draws * p.nb + (p.m_pad - p.m);
  cudaError_t err = staged_shape(tri_setup_kernel<Kind>, n, rec_words(p.n_ctx), &sh);
  if (err != cudaSuccess) return err;
  tri_setup_kernel<Kind><<<sh.blocks, sh.threads, sh.smem, s>>>(p, in, recs, bbox, b_mask, acc, keys_word,
                                                                  (cudaGraphConditionalHandle)cond);
  return cudaGetLastError();
}

bool bad_shape(const FrTriSetupParams& p) {
  return p.n_draws < 1 || p.n_draws > FR_MAX_DRAWS || p.m_pad <= p.m || p.n_faces < 0 || p.nb < 0;
}

}  // namespace

extern "C" int fr_tri_setup(FrTriSetupParams p, const float* clip, const float* ctx, int32_t* recs, int32_t* bbox,
                            uint8_t* b_mask, int32_t* acc, int keys_word, unsigned long long cond, void* stream) {
  if (bad_shape(p)) return (int)cudaErrorInvalidValue;
  return (int)launch_setup<kPlanes>(p, PlanesIn{clip, ctx}, recs, bbox, b_mask, acc, keys_word, cond,
                                    (cudaStream_t)stream);
}

extern "C" int fr_tri_setup_vertex(FrTriSetupParams p, const FrVertexArgs* args, int32_t* recs, int32_t* bbox,
                                   uint8_t* b_mask, int32_t* acc, int keys_word, unsigned long long cond,
                                   void* stream) {
  if (bad_shape(p) || p.n_ctx < 1 || p.n_ctx > kMaxCtx) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (args->kind) {
    case kFlat:
      return (int)launch_setup<kFlat>(p, *args, recs, bbox, b_mask, acc, keys_word, cond, s);
    case kTextured:
      return (int)launch_setup<kTextured>(p, *args, recs, bbox, b_mask, acc, keys_word, cond, s);
    case kPhong:
      return (int)launch_setup<kPhong>(p, *args, recs, bbox, b_mask, acc, keys_word, cond, s);
    case kGouraud:
      return (int)launch_setup<kGouraud>(p, *args, recs, bbox, b_mask, acc, keys_word, cond, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fr_tri_setup_slots(FrTriSetupParams p, const int32_t* fan, int32_t* recs, int32_t* bbox, int32_t* acc,
                                  int keys_word, void* stream) {
  if (bad_shape(p)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.n_draws * p.nb > 0) {
    Shape sh;
    cudaError_t err = staged_shape(tri_slots_kernel, (long long)p.n_draws * p.nb, rec_words(p.n_ctx), &sh);
    if (err != cudaSuccess) return (int)err;
    tri_slots_kernel<<<sh.blocks, sh.threads, sh.smem, s>>>(p, fan, recs, bbox, acc, keys_word);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!p.quirk) return (int)cudaSuccess;
  tri_quirk_kernel<<<1, 256, 0, s>>>(p, recs, acc, keys_word);
  return (int)cudaGetLastError();
}
