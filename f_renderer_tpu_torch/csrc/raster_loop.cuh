// The per-tile raster loop shared by the fused kernel (K1, fused_raster.cu)
// and the non-fused raster kernel (K4, raster_planes.cu): one CUDA thread
// block per (th, 128) bin tile, 128 x 4 threads, each thread owning R = th/4
// rows of one pixel column.
//
// Over the tile's own fine pair range, its coarse-bin range and the shared
// spill range it computes, per pixel: affine int32 edges (wrapped: computed
// in uint32), e12 = area2 - e01 - e20, the sign-OR cover test against the
// exclusive bbox max, |cross| barycentrics with an s != 0 guard, rhw, and
// the strict (rhw, order) maximum, recording the winning pair. This is the
// loop of f_renderer_tpu/pipeline/raster_pallas.py:_make_kernel (the
// tri_body at :773-889); its plain version is
// pipeline/raster.py:raster_tiles_plain. With --fmad=false and IEEE
// division the results match the plain version to the bit. The cover test
// alone is exact, so the coarse and spill ranges need no bbox gate.
//
// What bounds it on the card: integer and float ALU work per (pair, pixel),
// ~40 operations for every pixel of the tile for every pair in its lists.
// The pair fields the loop reads (9 int32 + 9 float) are staged per chunk of
// 128 pairs in shared memory (9 KB) and read as broadcasts; each thread
// carries its R pixels' (depth, order, pair) in registers.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace fr {

// tri_i32 / tri_f32 rows (pipeline/raster.py)
constexpr int A01 = 0, B01 = 1, C01 = 2, A20 = 3, B20 = 4, C20 = 5, AREA2 = 6,
              ORDER = 7, MAXXY = 9, SLOT = 10, PS = 11;
constexpr int S0X = 0, S0Y = 1, S1X = 2, S1Y = 3, S2X = 4, S2Y = 5, RHW0 = 6,
              RHW1 = 7, RHW2 = 8, CTX0 = 9;
constexpr int PS_MASK = 0xFF;
constexpr int TW = 128;     // tile width = threads in x
constexpr int TY = 4;       // threads in y; each owns R = th / TY rows
constexpr int CHUNK = 128;  // pairs staged in shared memory at a time
constexpr int COARSE = 4;
constexpr int ORDER_NONE = INT32_MIN;
// shared-memory rows: the 8 int32 rows A01..ORDER, then MAXXY
constexpr int NS_I = 9, NS_F = 9;

// Walk this block's tile (blockIdx.x, blockIdx.y) and leave, for each of the
// thread's R pixels (column cx, rows row0 .. row0 + R - 1), the winning
// depth (0 if none) and pair column (-1 if none). Every thread of the block
// must call it (it synchronises the block).
template <int R>
__device__ __forceinline__ void raster_tile(const int32_t* __restrict__ off,
                                            const int32_t* __restrict__ tri_i32,
                                            const float* __restrict__ tri_f32, int ntx,
                                            int nty, size_t np, int cx, int row0,
                                            float (&dep)[R], int (&wpair)[R]) {
  __shared__ int32_t s_i[NS_I][CHUNK];
  __shared__ float s_f[NS_F][CHUNK];
  const int tid = threadIdx.y * TW + threadIdx.x;
  const float pcx = (float)cx + 0.5f;
  int word[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dep[r] = 0.0f;
    word[r] = ORDER_NONE;
    wpair[r] = -1;
  }

  const int tile_x = blockIdx.x, tile_y = blockIdx.y;
  const int ntiles = ntx * nty;
  const int ntxc = (ntx + COARSE - 1) / COARSE;
  const int ntilesc = ntxc * ((nty + COARSE - 1) / COARSE);
  const int t_lin = tile_y * ntx + tile_x;
  const int c_lin = ntiles + (tile_y / COARSE) * ntxc + tile_x / COARSE;
  const int s_lin = ntiles + ntilesc;
  const int starts[3] = {off[t_lin], off[c_lin], off[s_lin]};
  const int ends[3] = {off[t_lin + 1], off[c_lin + 1], off[s_lin + 1]};

  for (int range = 0; range < 3; ++range) {
    for (int base = starts[range]; base < ends[range]; base += CHUNK) {
      const int n = min(CHUNK, ends[range] - base);
      __syncthreads();  // the previous chunk is no longer read
      for (int k = tid; k < NS_I * CHUNK; k += TW * TY) {
        const int row = k / CHUNK, j = k % CHUNK;
        if (j < n) {
          const int src = row < 8 ? row : MAXXY;
          s_i[row][j] = tri_i32[src * np + base + j];
          s_f[row][j] = tri_f32[row * np + base + j];
        }
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const uint32_t a01 = (uint32_t)s_i[A01][j], b01 = (uint32_t)s_i[B01][j],
                       c01 = (uint32_t)s_i[C01][j], a20 = (uint32_t)s_i[A20][j],
                       b20 = (uint32_t)s_i[B20][j], c20 = (uint32_t)s_i[C20][j],
                       area2 = (uint32_t)s_i[AREA2][j];
        const int order = s_i[ORDER][j];
        const int maxxy = s_i[8][j];
        const int maxx = maxxy & 0xFFFF, maxy = maxxy >> 16;
        const float f0x = s_f[S0X][j], f0y = s_f[S0Y][j], f1x = s_f[S1X][j],
                    f1y = s_f[S1Y][j], f2x = s_f[S2X][j], f2y = s_f[S2Y][j];
        const float r0 = s_f[RHW0][j], r1 = s_f[RHW1][j], r2 = s_f[RHW2][j];
        const int32_t xbits = maxx - 1 - cx;
        const uint32_t ex01 = a01 * (uint32_t)cx + c01;
        const uint32_t ex20 = a20 * (uint32_t)cx + c20;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int cy = row0 + r;
          // wrapped int32 edges: e = (A cx + B cy) + C, e12 = area2 - e01 - e20
          const uint32_t e01 = ex01 + b01 * (uint32_t)cy;
          const uint32_t e20 = ex20 + b20 * (uint32_t)cy;
          const uint32_t e12 = area2 - e01 - e20;
          const uint32_t bits = e01 | e12 | e20 | (uint32_t)xbits | (uint32_t)(maxy - 1 - cy);
          if (bits & 0x80000000u) continue;  // not covered
          const float pcy = (float)cy + 0.5f;
          const float s0x = f0x - pcx, s0y = f0y - pcy;
          const float s1x = f1x - pcx, s1y = f1y - pcy;
          const float s2x = f2x - pcx, s2y = f2y - pcy;
          const float a = fabsf(s1x * s2y - s1y * s2x);
          const float b = fabsf(s2x * s0y - s2y * s0x);
          const float c = fabsf(s0x * s1y - s0y * s1x);
          const float s = (a + b) + c;
          if (s == 0.0f) continue;
          const float inv_s = 1.0f / s;
          const float rhw = (r0 * (a * inv_s) + r1 * (b * inv_s)) + r2 * (c * inv_s);
          if (rhw > dep[r] || (rhw >= dep[r] && order > word[r])) {
            dep[r] = rhw;
            word[r] = order;
            wpair[r] = base + j;
          }
        }
      }
    }
  }
}

// Perspective-correct interpolation weights of pair column ``pair`` at pixel
// centre (pcx, pcy) with final depth d (renderer.rs:368-378): the varying is
// (v0 * c0 + v1 * c1) + v2 * c2. The GPU form of the TPU kernel's
// _deferred_update (raster_pallas.py:1102-1149): the barycentrics are
// recomputed from the same fields that produced the accept.
__device__ __forceinline__ void interp_weights(const float* __restrict__ tri_f32, size_t np,
                                               int pair, float pcx, float pcy, float d,
                                               float& c0, float& c1, float& c2) {
  const float* f = tri_f32 + pair;
  const float s0x = f[S0X * np] - pcx, s0y = f[S0Y * np] - pcy;
  const float s1x = f[S1X * np] - pcx, s1y = f[S1Y * np] - pcy;
  const float s2x = f[S2X * np] - pcx, s2y = f[S2Y * np] - pcy;
  const float a = fabsf(s1x * s2y - s1y * s2x);
  const float b = fabsf(s2x * s0y - s2y * s0x);
  const float c = fabsf(s0x * s1y - s0y * s1x);
  const float inv_s = 1.0f / ((a + b) + c);
  const float w_corr = 1.0f / (d != 0.0f ? d : 1.0f);
  c0 = (f[RHW0 * np] * (a * inv_s)) * w_corr;
  c1 = (f[RHW1 * np] * (b * inv_s)) * w_corr;
  c2 = (f[RHW2 * np] * (c * inv_s)) * w_corr;
}

// Varying channel ch of C interpolated with the weights above.
__device__ __forceinline__ float interp_channel(const float* __restrict__ tri_f32, size_t np,
                                                int pair, int n_ctx, int ch, float c0,
                                                float c1, float c2) {
  const float* f = tri_f32 + pair;
  return (f[(CTX0 + ch) * np] * c0 + f[(CTX0 + n_ctx + ch) * np] * c1) +
         f[(CTX0 + 2 * n_ctx + ch) * np] * c2;
}

}  // namespace fr
