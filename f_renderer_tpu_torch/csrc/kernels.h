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
} FrFusedParams;

// Fused raster + interpolate + shade + RGBA8 pack over a binned pair list.
//   off      (ntx*nty + ceil(ntx/4)*ceil(nty/4) + 2) pair-range offsets
//   tri_i32  (12, n_pairs) setup rows, tri_f32 (9 + 3C, n_pairs)
//   view_pos (3), dims (t_count, 2) (h, w), texels (t_count, hmax, wmax)
//   rgba / depth / winner: (nty*th, w_pad) outputs
//   tiles    (ntx*nty*8) int32 scratch, 16-byte aligned: the tiles' pair
//            ranges, heaviest first (TileDesc, raster_loop.cuh)
int fr_fused_raster(FrFusedParams p, const int32_t* off, const int32_t* tri_i32,
                    const float* tri_f32, const float* view_pos, const int32_t* dims,
                    const int32_t* texels, int32_t* rgba, float* depth,
                    int32_t* winner, int32_t* tiles, void* stream);

// Non-fused raster (K4) over the same binned pair list: depth / winner
// (nty*th, ntx*128) planes and, when ps is not null, the texture id plane and
// the (n_ctx, nty*th, ntx*128) varying planes (ctx may be null if n_ctx is 0);
// tiles is scratch, as for fr_fused_raster.
int fr_raster_planes(int th, int ntx, int nty, int n_pairs, int n_ctx, const int32_t* off,
                     const int32_t* tri_i32, const float* tri_f32, float* depth,
                     int32_t* winner, int32_t* ps, float* ctx, int32_t* tiles, void* stream);

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

// cudaGetErrorString for a code returned above.
const char* fr_error_string(int err);

#ifdef __cplusplus
}
#endif
