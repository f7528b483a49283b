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

// Mirrors kernels.ShadeParams: int32 and float fields only (no padding).
typedef struct FrShadeParams {
  int32_t h, w;         // the frame's rows and columns
  int32_t ctx_channel;  // element stride between ctx's channel planes
  int32_t ctx_row, ps_row, winner_row;  // row strides (the column stride is 1)
  int32_t kind;         // 0 flat, 1 gouraud, 2 textured, 3 phong
  int32_t color, normal, pos, uv;  // the first channel of each varying the kind reads
  int32_t t_count;      // textures in the stack
  int32_t hmax, wmax;   // stack extent
  int32_t opaque;       // every real texel has alpha 255
  int32_t bg_packed;    // background RGBA8
  float light_pos[3];
  float light_color[3];
  float ambient[3];     // 0.1 * light_color, rounded once to float
} FrShadeParams;

// Builtin shading of K4's planes: ctx (C, h, w) f32, ps and winner (h, w)
// int32, each through its strides → out (h, w) int32 RGBA8, contiguous;
// view_pos (3), dims (t_count, 2), texels (t_count, hmax, wmax).
int fr_shade_planes(FrShadeParams p, const float* ctx, const int32_t* ps, const int32_t* winner,
                    const float* view_pos, const int32_t* dims, const int32_t* texels,
                    int32_t* out, void* stream);

// Mirrors kernels.PackParams: int64 strides, then int32 fields (no padding).
typedef struct FrPackParams {
  int64_t color_channel, color_row, color_col;  // the colour's strides, in elements
  int64_t winner_row, winner_col;               // the key plane's strides, in elements
  int32_t h, w;                                 // the frame's rows and columns
  int32_t bg_packed;                            // background RGBA8
  int32_t slot_w;                               // 0: the key is the winner; else a slot map, the colour's columns
  int32_t slot_rows;                            // with a slot map: the colour's rows
  int32_t pad;
} FrPackParams;

// The RGBA8 pack of a user pixel shader's colour (csrc/pack_rgba8.cu):
// the (h, w) int32 key plane and the f32 colour, each through any strides
// → out (h, w) int32 RGBA8, contiguous: clip(c * 255, 0, 255) truncated a
// channel, NaN to 0, bg_packed where the key is < 0. With slot_w 0 the key
// is the winner and the colour (4, h, w), read at the pixel; else the key
// is a slot map (compact_planes) and the colour (4, slot_rows, slot_w), a
// covered pixel's read at its slot s: row s / slot_w, column s % slot_w; a
// slot past the colour's packs bg_packed (a rung too small for the frame,
// which a captured frame's warm-up runs and discards).
int fr_pack_rgba8(FrPackParams p, const float* color, const int32_t* key, int32_t* out, void* stream);

// The compaction of K4's planes to their covered pixels (csrc/compact_planes.cu).
#define FR_RUNGS 5                  // the ladder's rungs (pipeline/shade.py RUNGS); rung FR_RUNGS: the whole frame
#define FR_COMPACT_MAX_BLOCKS 4096  // the grid's most blocks: the block-count words after info's first two
#define FR_TALLY_WORDS (FR_RUNGS + 4)

// Mirrors kernels.CompactParams: int64 strides, the conditions, then int32
// fields (no padding).
typedef struct FrCompactParams {
  int64_t winner_row, winner_col, ps_row, ps_col;  // the planes' strides, in elements
  int64_t ctx_channel, ctx_row, ctx_col;
  unsigned long long cond[FR_RUNGS + 1];  // with conds: each rung's conditional node, the whole frame's last
  int32_t h, w, n_ctx;
  int32_t rmax;                           // the compact planes' rows: rows[FR_RUNGS - 1]
  int32_t rows[FR_RUNGS];                 // each rung's rows, ascending
  int32_t conds;                          // 1 where cond holds a capture's handles
  int32_t chunk;                          // pixels a block (set by fr_compact_planes)
  int32_t pad;
} FrCompactParams;

// winner, ps (h, w) int32 and ctx (n_ctx, h, w) f32, each through its
// strides → info[0] the covered pixels (winner >= 0), info[1] the rung: the
// first whose rows[k] * w slots hold them, else FR_RUNGS (info holds
// 2 + FR_COMPACT_MAX_BLOCKS words, the rest scratch); slots (h, w) int32,
// contiguous: a covered pixel's slot, in raster order, -1 elsewhere; on a
// rung k < FR_RUNGS, ps_c (rmax, w) int32 and ctx_c (n_ctx, rmax, w) f32,
// contiguous: the covered pixels' planes at their slots, then ps -1 and
// zeros to rows[k] * w; on the whole frame's rung they are not written.
// With p.conds, each condition set to whether its rung is the frame's;
// tally (FR_TALLY_WORDS) uint64, where not null: one more frame at the rung,
// then the covered pixels, the pixels shaded (the rung's slots, or h * w)
// and the frame's pixels added to words FR_RUNGS + 1 .. FR_RUNGS + 3.
int fr_compact_planes(FrCompactParams p, const int32_t* winner, const int32_t* ps, const float* ctx, int32_t* info,
                      int32_t* slots, int32_t* ps_c, float* ctx_c, unsigned long long* tally, void* stream);

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
                   const uint8_t* alive, const int32_t* table, const float* times,
                   int32_t* bits, int32_t* out, void* stream);

// Voxel ray set-up: the width x height rays from eye (3,) f32 through
// inv_mvp (4, 4) f32 (both device pointers, read by the kernel) into a cube
// of side length → planes (7, height, width) f32: start x/y/z, dir x/y/z,
// t_max; alive (height, width) bytes, 0 or 1.
int fr_voxel_setup(int width, int height, float length, const float* eye, const float* inv_mvp,
                   float* planes, uint8_t* alive, void* stream);

#define FR_MAX_DRAWS 256

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
  // the ps boundary quirk: 0 off; 1 the per-draw counts and least keys
  // accumulated and the quirk applied (launch 1's last block where no face
  // clipped, else after tri_slots_kernel); 2 accumulated only, for a face
  // shard of a sharded frame, which reduces them over its shards and then
  // applies the quirk itself (fr_tri_quirk)
  int32_t quirk;
  int32_t cond;       // launch 1 sets the condition it is given (it was captured with one)
  int32_t slot0;      // the first slot's global id (a face shard's slots follow the shards before it): SLOT words and keys
  // the draw table, per draw d < D: its first face, faces, first slot, first order
  int32_t draws[FR_MAX_DRAWS][4];
} FrTriSetupParams;

// Triangle set-up (csrc/tri_setup.cu), launch 1 of a frame: per face, its
// masks and its path-A slot, from the vertex shader's clip (4, 3 n_faces)
// and ctx (C, 3 n_faces) planes (draw d's corners at 3 face_off[d] + v F_d +
// i); every path-B slot with the skip path's values and every padding slot
// zeros. A slot is written as a record and its bbox words:
//   recs    (m_pad, rec) int32, rec = ceil((21 + 3C) / 8) * 8: the 12 int32
//           rows, then the 9 + 3C float32 rows as bits, then zeros
//   bbox    (2, m_pad) int32: MINXY, MAXXY (what the binning counts)
//   b_mask  (n_faces) bytes: 1 where a face is clipped (w != 0, not inside)
//   acc     int32 words the caller zeroed: faces clipped per draw [D], in
//           the frame [1], a ticket [1], valid slots per draw [D], and at
//           word keys_word (even) D uint64 keys
// The last block to finish sets cond (a cudaGraphConditionalHandle, where
// p.cond) to 1 where a face clipped, else 0, and where none clipped applies
// the ps boundary quirk (p.quirk).
int fr_tri_setup(FrTriSetupParams p, const float* clip, const float* ctx, int32_t* recs, int32_t* bbox,
                 uint8_t* b_mask, int32_t* acc, int keys_word, unsigned long long cond, void* stream);

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
int fr_tri_setup_vertex(FrTriSetupParams p, const FrVertexArgs* args, int32_t* recs, int32_t* bbox, uint8_t* b_mask,
                        int32_t* acc, int keys_word, unsigned long long cond, void* stream);
// The clip path's launches (a frame where a face clipped): the path-B
// slots' records and bboxes of each draw that clipped a face, from fan
// (D, nb (23 + 3C)) int32 words, the clip path's arrays, then, with
// p.quirk, the ps boundary quirk's rewrite of the PS word of each draw's
// least valid slot.
int fr_tri_setup_slots(FrTriSetupParams p, const int32_t* fan, int32_t* recs, int32_t* bbox, int32_t* acc,
                       int keys_word, void* stream);
// The ps boundary quirk alone (one block), from acc's per-draw counts and
// least keys, which a sharded frame has reduced over its face shards: the
// PS word of each draw's least valid slot takes its target where that slot
// (a global id, slot0 on) is one of recs' own m_pad.
int fr_tri_quirk(FrTriSetupParams p, int32_t* recs, int32_t* acc, int keys_word, void* stream);

// Mirrors kernels.InterpParams: int32 fields only (no padding).
typedef struct FrInterpParams {
  int32_t h, w;       // the planes' rows and columns
  int32_t oy, ox;     // the frame's pixel that the planes' first one is
  int32_t n_ctx;      // varying channels C
  int32_t rec;        // words of a record
  int32_t winner_row; // the winner plane's row stride (its column stride is 1)
} FrInterpParams;

// The winners' varyings from their slot records (csrc/interp_records.cu):
// per pixel, the record of slot max(winner, 0) (a global column of recs, (m,
// rec) int32), its screen coordinates, 1/w and 3C varyings read at the
// float words, the perspective-correct interpolation at the pixel's centre
// → ctx (C, h, w) f32 and ps (h, w) int32, both contiguous.
int fr_interp_records(FrInterpParams p, const int32_t* recs, const int32_t* winner, float* ctx, int32_t* ps,
                      void* stream);

// Mirrors kernels.MergeParams: int32 fields only (no padding).
typedef struct FrMergeParams {
  int32_t h, w;       // the accumulator's rows and columns (a slab)
  int32_t pitch;      // row stride of the round's planes (K4's w_pad)
  int32_t plane;      // channel stride of the round's ctx (K4's h_pad * w_pad)
  int32_t n_ctx;      // varying channels C
  int32_t rec;        // words of a record
  int32_t m;          // records of the held shard
  int32_t slot0;      // the held shard's first global slot id (owner * m)
  int32_t first;      // 1: write every pixel, read no accumulator (round 0)
} FrMergeParams;

// The stream mode's merge of one round (csrc/stream_merge.cu): per pixel of
// the (h, w) slab, the round's (depth, winner, ps, ctx) read at the pitch
// of K4's padded planes, its order the ORDER word of record winner - slot0
// of recs ((m, rec) int32; ORDER_NONE where winner < 0); where (depth,
// order) is above the accumulator's by (rhw, order), or everywhere with
// p.first, the five planes are written into the accumulator in place:
// acc_depth f32, acc_order / acc_winner / acc_ps int32 (h, w), acc_ctx (C,
// h, w) f32, all contiguous.
int fr_stream_merge(FrMergeParams p, const float* depth, const int32_t* winner, const int32_t* ps,
                    const float* ctx, const int32_t* recs, float* acc_depth, int32_t* acc_order,
                    int32_t* acc_winner, int32_t* acc_ps, float* acc_ctx, void* stream);

// Mirrors kernels.BinParams: int32 fields only (no padding).
typedef struct FrBinParams {
  int32_t m;          // slots: records
  int32_t rows_f;     // float rows of a record (9 + 3C)
  int32_t th;         // bin tile rows (the tile is th x 128)
  int32_t ntx, nty;   // fine-tile grid of the rectangle
  int32_t k, kc;      // fine / coarse tiles a triangle may span
  int32_t oy, ox;     // the frame's pixel that the rectangle's first one is
  int32_t m_dummy;    // the empty-bbox slot padding pairs point at
  int32_t n_pad;      // pair columns of the outputs
  int32_t stripe;     // slots of a stripe (a multiple of 256): one block's
  int32_t n_stripes;
  int32_t bb_slot;    // bbox words: slot s's MINXY at bbox[s * bb_slot],
  int32_t bb_max;     // its MAXXY bb_max words after it
} FrBinParams;

// Binning and pair gather (csrc/bin_pairs.cu): a counting sort of the
// (tile key, slot) pairs of the slots' bboxes by key, then by slot, and the
// records gathered into pair order.
//   recs    (m, ceil((21 + 3C) / 8) * 8) int32: a record a slot
//   bbox    the bbox words (see bb_slot, bb_max)
//   counts  (n_stripes, R) int32 scratch, R = ntx nty + ceil(ntx/4) ceil(nty/4) + 1 keys
//   totals  (R) int32 scratch; ptri (n_pad) int32 scratch
//   off     (R + 1) int32: off[t] .. off[t + 1] are key t's pairs
//   out_i32 (12, n_pad), out_f32 (rows_f, n_pad): the columns in pair order,
//           m_dummy's past the last pair
int fr_bin_pairs(FrBinParams p, const int32_t* recs, const int32_t* bbox, int32_t* counts,
                 int32_t* totals, int32_t* off, int32_t* ptri, int32_t* out_i32, float* out_f32,
                 void* stream);

// A conditional node (csrc/graph_cond.cu), for the graph `parent` is
// capturing: a kernel that sets its condition from the device bool *pred,
// then an `if` node that later captured work on `parent` depends on; `body`
// (not capturing) captures into the node's body until fr_if_node_end(body).
int fr_if_node_begin(const void* pred, void* parent, void* body);
// A condition of the graph `parent` is capturing → *out: 0 at the start of
// every launch of the graph, until a kernel sets it (cudaGraphSetConditional).
int fr_condition_create(void* parent, unsigned long long* out);
// As fr_if_node_begin, the node's condition `handle` (fr_condition_create),
// set by a kernel captured before it: no kernel of its own.
int fr_if_node_begin_handle(unsigned long long handle, void* parent, void* body);
int fr_if_node_end(void* body);
// A new non-blocking stream on the current device → *out.
int fr_stream_create(void** out);

// cudaGetErrorString for a code returned above.
const char* fr_error_string(int err);

#ifdef __cplusplus
}
#endif
