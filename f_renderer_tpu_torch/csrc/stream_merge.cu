// The stream mode's per-round merge: a round's raster (K4's padded planes)
// merged into the slab's accumulated planes, in place, by the lexicographic
// (rhw, order) maximum.
//
// Replaces no Pallas kernel: XLA's fusion of the JAX package's merge of a
// round (f_renderer_tpu/parallel/sharding.py:224-245): the winners' orders
// taken from the held shard, `better = (d > depth) | ((d >= depth) & (o >
// worder))`, and five `where`s. The port ran it as ~21 PyTorch operations a
// round. The plain version is parallel/sharding.py:stream_merge_plain,
// bit-equal: the compares are float compares, as there (-0.0 equals 0.0, a
// NaN depth is never better), and every plane is copied, not computed.
//
// The round's winner is K4's as it is: the records' SLOT words are already
// global (shard d's are d * m on), so -1 stays -1; its order is the ORDER
// word of the held shard's record winner - slot0. With p.first (round 0)
// the accumulator is written everywhere and read nowhere: K4 leaves depth
// +0.0, winner -1, ps 0 and every channel 0 where no pair won, and a pixel
// K4 gave a winner has depth >= 0 and an order above ORDER_NONE, so this is
// the merge against the start's fills (0, ORDER_NONE, -1, 0, 0) bit for bit
// (tests/test_torch_stream_merge.py) without the fills.
//
// Design: one thread a pixel, 128 a block along a row, as
// csrc/interp_records.cu; a warp reads 32 neighbouring pixels of each plane
// as one 128-byte line. A pixel reads the round's depth and winner, its
// winner's ORDER word (neighbouring pixels mostly share a winner, so the
// record's sector comes from L1) and the accumulator's depth and order;
// only where the round is better does it read the round's ps and C
// varyings and write the five planes. What bounds it on the card: bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 128;
constexpr int ORDER = 7;                        // raster.ORDER: the record's order word
constexpr int32_t kOrderNone = INT32_MIN;       // raster.ORDER_NONE

__global__ void __launch_bounds__(kThreads)
stream_merge_kernel(const FrMergeParams p, const float* __restrict__ depth, const int32_t* __restrict__ winner,
                    const int32_t* __restrict__ ps, const float* __restrict__ ctx, const int32_t* __restrict__ recs,
                    float* __restrict__ acc_depth, int32_t* __restrict__ acc_order, int32_t* __restrict__ acc_winner,
                    int32_t* __restrict__ acc_ps, float* __restrict__ acc_ctx) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= p.w) return;
  const size_t i = (size_t)y * p.pitch + x;  // the round's padded planes
  const size_t o = (size_t)y * p.w + x;      // the accumulator
  const float d = __ldg(depth + i);
  const int32_t win = __ldg(winner + i);
  int32_t ord = kOrderNone;
  if (win >= 0) {
    const int local = min(max(win - p.slot0, 0), p.m - 1);
    ord = __ldg(recs + (size_t)local * p.rec + ORDER);
  }
  if (!p.first) {
    const float a = acc_depth[o];
    if (!(d > a || (d >= a && ord > acc_order[o]))) return;
  }
  acc_depth[o] = d;
  acc_order[o] = ord;
  acc_winner[o] = win;
  acc_ps[o] = __ldg(ps + i);
  const size_t acc_plane = (size_t)p.h * p.w;
  for (int ch = 0; ch < p.n_ctx; ++ch) {
    acc_ctx[ch * acc_plane + o] = __ldg(ctx + ch * (size_t)p.plane + i);
  }
}

}  // namespace

extern "C" int fr_stream_merge(FrMergeParams p, const float* depth, const int32_t* winner, const int32_t* ps,
                               const float* ctx, const int32_t* recs, float* acc_depth, int32_t* acc_order,
                               int32_t* acc_winner, int32_t* acc_ps, float* acc_ctx, void* stream) {
  if (p.h < 0 || p.w < 0 || p.h > 65535 || p.pitch < p.w || p.n_ctx < 0 || p.plane < p.h * p.pitch ||
      p.rec <= ORDER || p.m < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.h == 0 || p.w == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((p.w + kThreads - 1) / kThreads), (unsigned)p.h);
  stream_merge_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p, depth, winner, ps, ctx, recs, acc_depth,
                                                                   acc_order, acc_winner, acc_ps, acc_ctx);
  return (int)cudaGetLastError();
}
