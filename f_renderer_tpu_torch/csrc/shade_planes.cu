// Builtin shading of K4's planes: per pixel, the builtin pixel shader
// (flat / gouraud / textured / phong, with the bilinear sampler) on the
// winner's interpolated varyings, the clip-and-truncate RGBA8 pack, and the
// background where no triangle won.
//
// Replaces no TPU kernel: XLA's fusion of the JAX package's non-fused
// shading, f_renderer_tpu/pipeline/shade.py:80 shade_from_planes over the
// builtin pixel shaders (shaders/builtin.py:67-163) and the sampler
// (shaders/texture.py:155; the K3 pallas_call where the stack fits VMEM).
// On the card PyTorch ran it as ~120 graph nodes and one K3 launch over the
// whole frame. The shading and the pack are shade.cuh, the device functions
// of the fused kernel's epilogue (K1); the plain version is
// pipeline/shade.py:shade_planes_plain.
//
// Design: one thread a pixel, a block 128 pixels of a row, so a warp reads
// 32 neighbouring floats of each plane. The planes are read through their
// strides (K4's padded planes cropped to the frame, any channel count), and
// only the channels the kind reads, at the offsets the wrapper takes from
// the context codec. Where winner < 0 the thread writes the background and
// reads nothing else. What bounds it on the card: bytes, the winner and the
// output on every pixel, the texture id and the kind's channels on covered
// pixels, and the texels they sample (through L2).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"
#include "shade.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
shade_planes_kernel(const FrShadeParams p, const float* __restrict__ ctx,
                    const int32_t* __restrict__ ps, const int32_t* __restrict__ winner,
                    const float* __restrict__ view_pos, const int32_t* __restrict__ dims,
                    const int32_t* __restrict__ texels, int32_t* __restrict__ out) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= p.w) return;
  const size_t o = (size_t)y * p.w + x;
  if (__ldg(winner + (size_t)y * p.winner_row + x) < 0) {
    out[o] = p.bg_packed;
    return;
  }
  const float* px = ctx + (size_t)y * p.ctx_row + x;
  const size_t channel = (size_t)p.ctx_channel;
  float col[4];
  fr::shade(p, view_pos, dims, texels, __ldg(ps + (size_t)y * p.ps_row + x),
            [&](int ch) { return __ldg(px + ch * channel); },
            fr::Varyings{p.color, p.normal, p.pos, p.uv}, col);
  out[o] = fr::pack_rgba8(col);
}

}  // namespace

extern "C" int fr_shade_planes(FrShadeParams p, const float* ctx, const int32_t* ps,
                               const int32_t* winner, const float* view_pos, const int32_t* dims,
                               const int32_t* texels, int32_t* out, void* stream) {
  if (p.h < 0 || p.w < 0 || p.h > 65535 || p.kind < 0 || p.kind > 3) return (int)cudaErrorInvalidValue;
  if (p.h == 0 || p.w == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((p.w + kThreads - 1) / kThreads), (unsigned)p.h);
  shade_planes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p, ctx, ps, winner, view_pos, dims,
                                                                 texels, out);
  return (int)cudaGetLastError();
}
