// Standalone batched bilinear texture sampler: (texture id, u, v) per
// sample → 4 float planes, one CUDA thread per sample.
//
// Replaces the TPU kernel f_renderer_tpu/shaders/texture_pallas.py:497 (the
// pallas_call in sample_bilinear_pallas, "K3", body _sample_kernel :416).
// The arithmetic is the device function fr_sample (sampler.cuh), the one
// the fused kernel's epilogue calls; the plain version is
// shaders/texture_sampler.py:sample_packed_plain.
//
// On the TPU the packed stack sat in VMEM and each (bs, 128) block looped
// over the texture rows and pages its samples touch. Here a thread reads its
// sample's four texels straight from the (T, Hmax, Wmax) stack in device
// memory; neighbouring samples read neighbouring texels, so the reads mostly
// hit L2. What bounds it on the card: bytes, 12 in and 16 out per sample
// plus the texels the samples touch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"
#include "sampler.cuh"

namespace {

__global__ void sample_bilinear_kernel(const int32_t* __restrict__ dims,
                                       const int32_t* __restrict__ texels, int t_count,
                                       int hmax, int wmax, bool opaque,
                                       bool replicate_clamp_bug,
                                       const int32_t* __restrict__ ps,
                                       const float* __restrict__ u,
                                       const float* __restrict__ v, float* __restrict__ out,
                                       int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float col[4];
  fr_sample(dims, texels, t_count, hmax, wmax, opaque, replicate_clamp_bug, ps[i], u[i], v[i],
            col);
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c * n + i] = col[c];
}

}  // namespace

extern "C" int fr_sample_bilinear(const int32_t* dims, const int32_t* texels, int t_count,
                                  int hmax, int wmax, int opaque, int replicate_clamp_bug,
                                  const int32_t* ps, const float* u, const float* v,
                                  float* out, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sample_bilinear_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      dims, texels, t_count, hmax, wmax, opaque != 0, replicate_clamp_bug != 0, ps, u, v, out,
      n);
  return (int)cudaGetLastError();
}
