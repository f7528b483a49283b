// The RGBA8 pack of a user pixel shader's colour: per pixel, the (4, h, w)
// f32 colour to one RGBA8 word, clip(c * 255, 0, 255) truncated a channel
// with NaN to 0, and the background where no triangle won.
//
// Replaces no TPU kernel: XLA's fusion of the pack at the end of the JAX
// package's non-fused shading (f_renderer_tpu/pipeline/shade.py:112-…,
// fused there with the user's shader). On the card PyTorch ran it as seven
// eager kernels after the shader (x 255, clamp, isnan, where, the u8 cast,
// winner >= 0 and the where with the background), each a pass over the
// frame: ~318 MB at 1920 x 1080. The arithmetic is shade.cuh's u8_of and
// pack_rgba8, which the builtin shading's pack (K1, shade_planes_kernel)
// runs too; the plain version is pipeline/shade.py:_pack, bit for bit.
//
// What bounds it on the card: bytes. Read once and written once at 1920 x
// 1080, the colour (33.18 MB), the winner (8.29 MB) and the output (8.29
// MB) are 49.77 MB, 0.0149 ms at 3.35 TB/s; a background pixel needs no
// colour, so the least bytes are the winner and the output on every pixel
// and 16 B of colour on a covered one. Design: one thread a pixel, a block
// 128 pixels of a row, so a warp reads 32 neighbouring words of the winner
// and of each channel plane where their column stride is 1; the planes are
// read through their strides, whatever they are (a colour that is a view
// is not copied); a background pixel reads no colour; each pixel's four
// bytes go out as one 32-bit store, a warp's 128 contiguous bytes. The
// grid's rows step over the frame's rows, so any height launches.
//
// Its slot form (slot_w > 0) packs a colour that a user's shader computed on
// the compacted covered pixels (compact_planes.cu): the key plane is the
// slot map, -1 on a background pixel, and a covered pixel reads its colour
// at its slot, row s / slot_w and column s % slot_w of the (4, R, slot_w)
// colour; a slot past its R · slot_w packs the background (a rung too small
// for the frame: a captured frame's warm-up runs every rung and keeps one).
// Neighbouring covered pixels hold neighbouring slots, so a warp still
// reads runs of neighbouring words.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"
#include "shade.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridRows = 65535;  // gridDim.y's limit

__global__ void __launch_bounds__(kThreads)
pack_rgba8_kernel(const FrPackParams p, const float* __restrict__ color,
                  const int32_t* __restrict__ key, int32_t* __restrict__ out) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= p.w) return;
  for (int y = blockIdx.y; y < p.h; y += gridDim.y) {
    const size_t o = (size_t)y * p.w + x;
    const int32_t k = __ldg(key + y * p.winner_row + x * p.winner_col);
    const int r = p.slot_w > 0 ? k / p.slot_w : y;  // with a slot map, k is the pixel's slot
    if (k < 0 || (p.slot_w > 0 && r >= p.slot_rows)) {
      out[o] = p.bg_packed;
      continue;
    }
    const float* px = p.slot_w > 0 ? color + r * p.color_row + (k - r * p.slot_w) * p.color_col
                                    : color + y * p.color_row + x * p.color_col;
    const float col[4] = {__ldg(px), __ldg(px + p.color_channel), __ldg(px + 2 * p.color_channel),
                          __ldg(px + 3 * p.color_channel)};
    out[o] = fr::pack_rgba8(col);
  }
}

}  // namespace

extern "C" int fr_pack_rgba8(FrPackParams p, const float* color, const int32_t* key, int32_t* out,
                             void* stream) {
  if (p.h < 0 || p.w < 0 || p.slot_w < 0 || p.slot_rows < 0) return (int)cudaErrorInvalidValue;
  if (p.h == 0 || p.w == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((p.w + kThreads - 1) / kThreads), (unsigned)(p.h < kMaxGridRows ? p.h : kMaxGridRows));
  pack_rgba8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p, color, key, out);
  return (int)cudaGetLastError();
}
