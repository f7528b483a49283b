// Fused raster + varying interpolation + shading + RGBA8 pack, one CUDA
// thread block per (th, 128) bin tile.
//
// Replaces the TPU kernel f_renderer_tpu/pipeline/fused.py:525 (the
// pallas_call in render_fused_prepared, "K1"), whose body is
// raster_pallas._make_kernel in its binned + deferred form plus the shading
// epilogue fused._make_epilogue; the texture sampler it calls (K2) is
// sampler.cuh. The plain version is pipeline/fused.py:render_fused_plain.
//
// What it computes, per pixel of the tile:
//  - over the tile's own fine pair range, its coarse-bin range and the shared
//    spill range: affine int32 edges (wrapped: computed in uint32), e12 =
//    area2 - e01 - e20, the sign-OR cover test against the exclusive bbox
//    max, |cross| barycentrics with an s != 0 guard, rhw, and the strict
//    (rhw, order) maximum recording the winning pair;
//  - once, for the winner: perspective-correct interpolation of the C
//    varyings with the final depth (the GPU form of _deferred_update);
//  - flat / gouraud / textured / phong shading, clip-and-truncate RGBA8
//    pack, background fill.
// The arithmetic follows the JAX kernel expression by expression; with
// --fmad=false and IEEE division/sqrt the results match the plain version
// to the bit. The cover test alone is exact, so the coarse and spill ranges
// need no bbox gate and no rounding to chunks.
//
// What bounds it on the card: integer and float ALU work per (pair, pixel)
// — ~40 operations for every pixel of the tile for every pair in its lists.
// The design keeps that loop lean: the pair fields it reads (9 int32 + 9
// float) are staged per chunk of 128 pairs in shared memory (9 KB) and read
// as broadcasts; each thread carries its R = th/4 pixels' (depth, order,
// pair) in registers; the varyings (3C floats per pair) and the shading
// inputs are read from device memory once per pixel, after the loop.
// cp.async/TMA staging and persistent blocks are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"
#include "sampler.cuh"

namespace {

// tri_i32 / tri_f32 rows (pipeline/raster.py)
constexpr int A01 = 0, B01 = 1, C01 = 2, A20 = 3, B20 = 4, C20 = 5, AREA2 = 6,
              ORDER = 7, MAXXY = 9, SLOT = 10, PS = 11;
constexpr int S0X = 0, S0Y = 1, S1X = 2, S1Y = 3, S2X = 4, S2Y = 5, RHW0 = 6,
              RHW1 = 7, RHW2 = 8, CTX0 = 9;
constexpr int TW = 128;       // tile width = threads in x
constexpr int TY = 4;         // threads in y; each owns R = th / TY rows
constexpr int CHUNK = 128;    // pairs staged in shared memory at a time
constexpr int MAX_CTX = 8;
constexpr int COARSE = 4;
constexpr int ORDER_NONE = INT32_MIN;
// shared-memory rows: the 8 int32 rows A01..ORDER, then MAXXY
constexpr int NS_I = 9, NS_F = 9;

__device__ __forceinline__ float nanmax0(float x) {
  // jnp.maximum(x, 0): NaN propagates
  return isnan(x) ? x : fmaxf(x, 0.0f);
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  // 1/sqrtf (two correctly rounded steps), not rsqrtf: the plain version
  // computes the same, bit for bit, on any device.
  const float inv = 1.0f / sqrtf((x * x + y * y) + z * z);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float pow32(float x) {
  // lax.integer_pow(x, 32): five squarings, not powf
#pragma unroll
  for (int i = 0; i < 5; ++i) x = x * x;
  return x;
}

__device__ __forceinline__ int u8_of(float p) {
  // clip(p * 255, 0, 255) truncated; NaN gives 0
  return (int)fminf(fmaxf(p * 255.0f, 0.0f), 255.0f);
}

__device__ void shade(const FrFusedParams& p, const float* __restrict__ view_pos,
                      const int32_t* __restrict__ dims, const int32_t* __restrict__ texels,
                      int ps, const float* ctx, float col[4]) {
  if (p.kind == 0) {  // flat
    col[0] = ctx[0]; col[1] = ctx[1]; col[2] = ctx[2]; col[3] = ctx[3];
  } else if (p.kind == 1) {  // gouraud
    col[0] = ctx[0]; col[1] = ctx[1]; col[2] = ctx[2]; col[3] = 1.0f;
  } else if (p.kind == 2) {  // textured
    fr_sample(dims, texels, p.t_count, p.hmax, p.wmax, p.opaque != 0, ps, ctx[0], ctx[1], col);
  } else {  // phong: normal ctx[0..2], world pos ctx[3..5], uv ctx[6..7]
    float nx = ctx[0], ny = ctx[1], nz = ctx[2];
    const float px = ctx[3], py = ctx[4], pz = ctx[5];
    normalize3(nx, ny, nz);
    float ldx = p.light_pos[0] - px, ldy = p.light_pos[1] - py, ldz = p.light_pos[2] - pz;
    normalize3(ldx, ldy, ldz);
    const float diff = nanmax0((nx * ldx + ny * ldy) + nz * ldz);
    float vdx = view_pos[0] - px, vdy = view_pos[1] - py, vdz = view_pos[2] - pz;
    normalize3(vdx, vdy, vdz);
    // reflect(-light_dir, n) = normalize(2 (L.N) N - L), L = -light_dir
    const float d = -((ldx * nx + ldy * ny) + ldz * nz);
    float rx = (2.0f * d) * nx + ldx, ry = (2.0f * d) * ny + ldy, rz = (2.0f * d) * nz + ldz;
    normalize3(rx, ry, rz);
    const float spec = pow32(nanmax0((vdx * rx + vdy * ry) + vdz * rz));
    float tex[4];
    fr_sample(dims, texels, p.t_count, p.hmax, p.wmax, p.opaque != 0, ps, ctx[6], ctx[7], tex);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lc = p.light_color[c];
      const float light = (p.ambient[c] + diff * lc) + (0.5f * spec) * lc;
      col[c] = tex[c] * light;
    }
    col[3] = tex[3];
  }
}

template <int R>
__global__ void __launch_bounds__(TW * TY)
fused_raster_kernel(const FrFusedParams p, const int32_t* __restrict__ off,
                    const int32_t* __restrict__ tri_i32, const float* __restrict__ tri_f32,
                    const float* __restrict__ view_pos, const int32_t* __restrict__ dims,
                    const int32_t* __restrict__ texels, int32_t* __restrict__ rgba,
                    float* __restrict__ depth_out, int32_t* __restrict__ winner_out) {
  __shared__ int32_t s_i[NS_I][CHUNK];
  __shared__ float s_f[NS_F][CHUNK];

  const int tile_x = blockIdx.x, tile_y = blockIdx.y;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int cx = tile_x * TW + threadIdx.x;
  const int row0 = tile_y * p.th + threadIdx.y * R;
  const float pcx = (float)cx + 0.5f;
  const size_t np = (size_t)p.n_pairs;

  float dep[R];
  int word[R];
  int wpair[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dep[r] = 0.0f;
    word[r] = ORDER_NONE;
    wpair[r] = -1;
  }

  const int ntiles = p.ntx * p.nty;
  const int ntxc = (p.ntx + COARSE - 1) / COARSE;
  const int ntilesc = ntxc * ((p.nty + COARSE - 1) / COARSE);
  const int t_lin = tile_y * p.ntx + tile_x;
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

  // Interpolate the winner's varyings once, shade, pack. (Unrolled, so the
  // per-pixel carries stay in registers: a dynamic index would put them in
  // local memory for the whole kernel.)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int cy = row0 + r;
    const size_t o = (size_t)cy * p.w_pad + cx;
    const int pair = wpair[r];
    depth_out[o] = dep[r];
    if (pair < 0) {
      winner_out[o] = -1;
      rgba[o] = p.bg_packed;
      continue;
    }
    const float pcy = (float)cy + 0.5f;
    const float* f = tri_f32 + pair;
    const float s0x = f[S0X * np] - pcx, s0y = f[S0Y * np] - pcy;
    const float s1x = f[S1X * np] - pcx, s1y = f[S1Y * np] - pcy;
    const float s2x = f[S2X * np] - pcx, s2y = f[S2Y * np] - pcy;
    const float a = fabsf(s1x * s2y - s1y * s2x);
    const float b = fabsf(s2x * s0y - s2y * s0x);
    const float c = fabsf(s0x * s1y - s0y * s1x);
    const float inv_s = 1.0f / ((a + b) + c);
    const float d = dep[r];
    const float w_corr = 1.0f / (d != 0.0f ? d : 1.0f);
    const float c0 = (f[RHW0 * np] * (a * inv_s)) * w_corr;
    const float c1 = (f[RHW1 * np] * (b * inv_s)) * w_corr;
    const float c2 = (f[RHW2 * np] * (c * inv_s)) * w_corr;
    float ctx[MAX_CTX];
#pragma unroll
    for (int ch = 0; ch < MAX_CTX; ++ch) {
      ctx[ch] = 0.0f;
      if (ch < p.n_ctx) {
        ctx[ch] = (f[(CTX0 + ch) * np] * c0 + f[(CTX0 + p.n_ctx + ch) * np] * c1) +
                  f[(CTX0 + 2 * p.n_ctx + ch) * np] * c2;
      }
    }
    const int ps = tri_i32[PS * np + pair] & 0xFF;
    winner_out[o] = tri_i32[SLOT * np + pair];
    float col[4];
    shade(p, view_pos, dims, texels, ps, ctx, col);
    const uint32_t packed = (uint32_t)u8_of(col[0]) | ((uint32_t)u8_of(col[1]) << 8) |
                            ((uint32_t)u8_of(col[2]) << 16) | ((uint32_t)u8_of(col[3]) << 24);
    rgba[o] = (int32_t)packed;
  }
}

template <int R>
cudaError_t launch(const FrFusedParams& p, const int32_t* off, const int32_t* tri_i32,
                   const float* tri_f32, const float* view_pos, const int32_t* dims,
                   const int32_t* texels, int32_t* rgba, float* depth, int32_t* winner,
                   cudaStream_t stream) {
  const dim3 grid(p.ntx, p.nty), block(TW, TY);
  fused_raster_kernel<R><<<grid, block, 0, stream>>>(p, off, tri_i32, tri_f32, view_pos,
                                                      dims, texels, rgba, depth, winner);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fr_fused_raster(FrFusedParams p, const int32_t* off, const int32_t* tri_i32,
                               const float* tri_f32, const float* view_pos,
                               const int32_t* dims, const int32_t* texels, int32_t* rgba,
                               float* depth, int32_t* winner, void* stream) {
  if (p.n_ctx < 1 || p.n_ctx > MAX_CTX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.th) {
    case 4: return (int)launch<1>(p, off, tri_i32, tri_f32, view_pos, dims, texels, rgba, depth, winner, s);
    case 8: return (int)launch<2>(p, off, tri_i32, tri_f32, view_pos, dims, texels, rgba, depth, winner, s);
    case 16: return (int)launch<4>(p, off, tri_i32, tri_f32, view_pos, dims, texels, rgba, depth, winner, s);
    case 32: return (int)launch<8>(p, off, tri_i32, tri_f32, view_pos, dims, texels, rgba, depth, winner, s);
    case 64: return (int)launch<16>(p, off, tri_i32, tri_f32, view_pos, dims, texels, rgba, depth, winner, s);
    case 128: return (int)launch<32>(p, off, tri_i32, tri_f32, view_pos, dims, texels, rgba, depth, winner, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
