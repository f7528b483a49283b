// Plain C interface of the port's CUDA kernels (bound with ctypes in
// f_renderer_tpu_torch/kernels.py). Every entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError() as an int.
#pragma once
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// Mirrors kernels.FusedParams: int32 and float fields only (no padding).
typedef struct FrFusedParams {
  int32_t th;         // bin tile rows; the tile is th x 128
  int32_t ntx, nty;   // fine-tile grid
  int32_t w_pad;      // output row stride, ntx * 128
  int32_t n_pairs;    // row stride of tri_i32 / tri_f32 (pair columns)
  int32_t n_ctx;      // varying channels C (1..8)
  int32_t kind;       // 0 flat, 1 gouraud, 2 textured, 3 phong
  int32_t t_count;    // textures in the stack
  int32_t hmax, wmax; // stack extent
  int32_t opaque;     // every real texel has alpha 255
  int32_t bg_packed;  // background RGBA8
  float light_pos[3];
  float light_color[3];
  float ambient[3];   // 0.1 * light_color, rounded once to float
  int32_t oy, ox;     // the frame's pixel that the planes' first one is
} FrFusedParams;

// Fused raster + interpolate + shade + RGBA8 pack over a binned pair list.
// The outputs are the (nty*th, w_pad) rectangle of the frame whose top-left
// pixel is (p.oy, p.ox): the kernel rasterizes frame pixels (a row slab of a
// sharded frame is bit-equal to the crop of the whole frame).
//   off      (ntx*nty + ceil(ntx/4)*ceil(nty/4) + 2) pair-range offsets
//   tri_i32  (12, n_pairs) setup rows, tri_f32 (9 + 3C, n_pairs)
//   view_pos (3), dims (t_count, 2) (h, w), texels (t_count, hmax, wmax)
//   rgba / depth / winner: (nty*th, w_pad) outputs
//   tiles    (ntx*nty*(9 + 20*cap)) int32 scratch, 16-byte aligned: the
//            tile plan (raster_loop.cuh): each tile's descriptor, heaviest
//            first, its count of culled pairs and the staged records of at
//            most cap of its coarse and spill pairs
int fr_fused_raster(FrFusedParams p, const int32_t* off, const int32_t* tri_i32,
                    const float* tri_f32, const float* view_pos, const int32_t* dims,
                    const int32_t* texels, int32_t* rgba, float* depth,
                    int32_t* winner, int32_t* tiles, int cap, void* stream);

// Non-fused raster (K4) over the same binned pair list: depth / winner
// (nty*th, ntx*128) planes and, when ps is not null, the texture id plane and
// the (n_ctx, nty*th, ntx*128) varying planes (ctx may be null if n_ctx is 0)
// of the rectangle at the frame's pixel (oy, ox); tiles and cap as for
// fr_fused_raster.
int fr_raster_planes(int th, int ntx, int nty, int n_pairs, int n_ctx, int oy, int ox,
                     const int32_t* off,
                     const int32_t* tri_i32, const float* tri_f32, float* depth,
                     int32_t* winner, int32_t* ps, float* ctx, int32_t* tiles, int cap,
                     void* stream);

// Batched bilinear sampler (K3): n samples (ps, u, v) → out (4, n) f32.
int fr_sample_bilinear(const int32_t* dims, const int32_t* texels, int t_count, int hmax,
                       int wmax, int opaque, int replicate_clamp_bug, const int32_t* ps,
                       const float* u, const float* v, float* out, int64_t n,
                       void* stream);

// Mirrors kernels.VoxelParams: int32 and float fields only (no padding).
typedef struct FrVoxelParams {
  int32_t n;          // rays
  int32_t r;          // table resolution, the table is r^3
  int32_t dda;        // 0: fixed step per_t, 1: cell-exact steps
  int32_t max_steps;  // watchdog on the per-ray loop
  int32_t bg_packed;  // background BGRA8
  int32_t n_times;    // entries of the sample-time table
  float length;       // cube side
  float cell;         // length / r, the cell-index divisor
  float per_t;        // fixed step
  float eps;          // dda step pad, cell * 1e-3
  float inv_per_t;    // float32(1 / per_t)
  float eps_jump;     // a jump's margin in length units
  float inv_cell;     // 1 / cell where cell is a power of two and r * cell == length, else 0
} FrVoxelParams;

// Voxel march (K5): n rays (start, dir, t_max, alive; n values each) through table (r^3,) int32 (bit 24 = hit, BGR low) → out packed
// BGRA. times (n_times,) f32 is the fixed step's sample-time table; bits
// ((r^3 + 31) / 32,) int32 is scratch for the hit bitmap.
int fr_voxel_march(FrVoxelParams p, const float* sx, const float* sy, const float* sz,
                   const float* dx, const float* dy, const float* dz, const float* tmax,
                   const int32_t* alive, const int32_t* table, const float* times,
                   int32_t* bits, int32_t* out, void* stream);

// Voxel ray set-up: the width x height rays from eye (3,) f32 through
// inv_mvp (4, 4) f32 (both device pointers, read by the kernel) into a cube
// of side length → planes (7, height, width) f32: start x/y/z, dir x/y/z,
// t_max; alive (height, width) bytes, 0 or 1.
int fr_voxel_setup(int width, int height, float length, const float* eye, const float* inv_mvp,
                   float* planes, uint8_t* alive, void* stream);

// Mirrors kernels.TriSetupParams: int32 fields only (no padding).
typedef struct FrTriSetupParams {
  int32_t n_draws;    // D (1..256)
  int32_t n_faces;    // faces of all draws, F_0 + ... + F_{D-1}
  int32_t n_ctx;      // varying channels C
  int32_t nb;         // path-B slots a draw: clip_cap * MAX_FAN
  int32_t m;          // slots: the sum over draws of F_d + nb
  int32_t m_pad;      // columns of the packed arrays, > m
  int32_t width, height;
  int32_t cull;       // drop back faces instead of repairing their winding
  int32_t quirk;      // reduce the ps boundary quirk's per-draw partials
} FrTriSetupParams;

// Triangle set-up (csrc/tri_setup.cu), launch 1 of a frame: per face, its
// masks and its path-A column of tri_i32 (12, m_pad) / tri_f32 (9 + 3C,
// m_pad), from the vertex shader's clip (4, 3 n_faces) and ctx (C, 3
// n_faces) planes (draw d's corners at 3 face_off[d] + v F_d + i).
//   table   (4 D) int32: face_off, faces, slot_base, order_base per draw
//   b_mask  (n_faces) bytes: 1 where a face is clipped (w != 0, not inside)
//   acc     int32 words the caller zeroed: faces clipped per draw [D], in
//           the frame [1], valid slots per draw [D], a byte a draw (1 where
//           it clipped), and at word keys_word (even) D uint64 keys
int fr_tri_setup(FrTriSetupParams p, const int32_t* table, const float* clip, const float* ctx,
                 int32_t* tri_i32, float* tri_f32, uint8_t* b_mask, int32_t* acc, int keys_word,
                 void* stream);
#define FR_MAX_DRAWS 256

// Mirrors kernels.VertexArgs: a builtin's vertex stage for launch 1. Every
// pointer is a device pointer the kernel reads (or, clip and ctx, writes)
// on each run, so a captured graph's replay reads its input buffers afresh.
typedef struct FrVertexArgs {
  const float* model;     // (4, 4) row-major uniforms
  const float* view;
  const float* proj;
  const float* view_pos;  // (3,), gouraud's eye; null for the other kinds
  float* clip;            // (4, 3 n_faces) out: the clip path's corner planes,
  float* ctx;             // (C, 3 n_faces) out: written where it reads them
  // per draw: the (F_d, 3, k) float32 attributes the kind reads, in its
  // slots: flat pos, color; textured pos, uv; phong pos, uv, normal;
  // gouraud pos, normal, color (null where the draw has none)
  const float* attr[FR_MAX_DRAWS][3];
  float light_pos[3];     // gouraud's light, rounded to float32
  float light_color[3];
  int32_t kind;           // 1 flat, 2 textured, 3 phong, 4 gouraud
} FrVertexArgs;

// Launch 1 with a builtin's vertex stage in place of the planes: each
// corner's clip position and varyings computed from the draws' attributes
// and the uniforms (p.n_ctx varyings, 1..8), then as fr_tri_setup; the
// clip and ctx planes written at the corners of every clipped face and of
// each draw's last face, the entries the clip path reads, and nowhere else.
int fr_tri_setup_vertex(FrTriSetupParams p, const int32_t* table, const FrVertexArgs* args, int32_t* tri_i32,
                        float* tri_f32, uint8_t* b_mask, int32_t* acc, int keys_word, void* stream);
// Launches 2 and 3: the path-B and padding columns from fan (D, nb (23 +
// 3C)) int32 words, the clip path's arrays (read where the draw clipped a
// face), then, with p.quirk, the ps boundary quirk's rewrite of the PS row.
int fr_tri_setup_slots(FrTriSetupParams p, const int32_t* table, const int32_t* fan, int32_t* tri_i32,
                       float* tri_f32, int32_t* acc, int keys_word, void* stream);

// Mirrors kernels.BinParams: int32 fields only (no padding).
typedef struct FrBinParams {
  int32_t m;          // slot columns of the packed arrays
  int32_t rows_f;     // rows of tri_f32 (9 + 3C)
  int32_t th;         // bin tile rows (the tile is th x 128)
  int32_t ntx, nty;   // fine-tile grid of the rectangle
  int32_t k, kc;      // fine / coarse tiles a triangle may span
  int32_t oy, ox;     // the frame's pixel that the rectangle's first one is
  int32_t m_dummy;    // the empty-bbox column padding pairs point at
  int32_t n_pad;      // pair columns of the outputs
  int32_t stripe;     // slots of a stripe (a multiple of 32): one warp's
  int32_t n_stripes;
} FrBinParams;

// Binning and pair gather (csrc/bin_pairs.cu): a counting sort of the
// (tile key, slot) pairs of tri_i32 (12, m) by key, then by slot, and the
// packed columns gathered into pair order.
//   counts  (R, n_stripes) int32 scratch, R = ntx nty + ceil(ntx/4) ceil(nty/4) + 1 keys
//   totals  (R) int32 scratch; ptri (n_pad) int32 scratch; recs (m,
//           ceil((21 + 3C) / 8) * 8) int32 scratch: a record a slot
//   off     (R + 1) int32: off[t] .. off[t + 1] are key t's pairs
//   out_i32 (12, n_pad), out_f32 (rows_f, n_pad): the columns in pair order,
//           m_dummy's past the last pair
int fr_bin_pairs(FrBinParams p, const int32_t* tri_i32, const float* tri_f32, int32_t* counts,
                 int32_t* totals, int32_t* off, int32_t* ptri, int32_t* recs, int32_t* out_i32,
                 float* out_f32, void* stream);

// A conditional node (csrc/graph_cond.cu), for the graph `parent` is
// capturing: a kernel that sets its condition from the device bool *pred,
// then an `if` node that later captured work on `parent` depends on; `body`
// (not capturing) captures into the node's body until fr_if_node_end(body).
int fr_if_node_begin(const void* pred, void* parent, void* body);
int fr_if_node_end(void* body);
// A new non-blocking stream on the current device → *out.
int fr_stream_create(void** out);

// cudaGetErrorString for a code returned above.
const char* fr_error_string(int err);

#ifdef __cplusplus
}
#endif
