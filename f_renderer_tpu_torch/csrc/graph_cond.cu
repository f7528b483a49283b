// A conditional node of a CUDA graph under capture: the counterpart of
// lax.cond inside a compiled program (pipeline/geometry.py: clip_or_skip,
// packed_geometry).
//
// fr_if_node_begin adds, to the graph that `parent` is capturing, a kernel
// that sets the node's condition from a device bool and, after it, an `if`
// conditional node; work captured on `parent` afterwards depends on the
// node. fr_if_node_begin_handle adds the node alone, on a condition made
// beforehand (fr_condition_create) that a kernel captured ahead of it sets
// itself (the triangle set-up's launch 1 does: no kernel of its own, so no
// node and no launch). `body` then captures into the node's body graph until
// fr_if_node_end. On a replay the body runs only where the condition is 1;
// it is 0 at the start of every launch of the graph (cudaGraphCondAssignDefault).
// `body` is a stream of its own (fr_stream_create): one of PyTorch's pooled
// streams may be the capturing stream itself.
#include <cuda_runtime.h>

#include "kernels.h"

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// A failed call's code, with the runtime's last error cleared: the kernel
// wrappers return cudaGetLastError() after their launches, and must not
// report this failure as theirs.
static int failed(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

// The graph `s` is capturing into (*graph) and its current dependencies.
static int capture_info(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n_deps);
  if (err != cudaSuccess) return failed(err);
  if (status != cudaStreamCaptureStatusActive)
    return (int)(status == cudaStreamCaptureStatusInvalidated ? cudaErrorStreamCaptureInvalidated
                                                              : cudaErrorIllegalState);
  return 0;
}

// The `if` node on `handle` after the capture's current dependencies; work
// captured on `s` afterwards depends on it; `body` captures its body.
static int add_if_node(cudaStream_t s, cudaGraphConditionalHandle handle, void* body) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  int rc = capture_info(s, &graph, &deps, &n_deps);
  if (rc != 0) return rc;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return failed(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return failed(err);
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  return err == cudaSuccess ? 0 : failed(err);
}

extern "C" int fr_condition_create(void* parent, unsigned long long* out) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  int rc = capture_info((cudaStream_t)parent, &graph, &deps, &n_deps);
  if (rc != 0) return rc;
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return failed(err);
  *out = (unsigned long long)handle;
  return 0;
}

extern "C" int fr_if_node_begin(const void* pred, void* parent, void* body) {
  cudaStream_t s = (cudaStream_t)parent;
  unsigned long long handle;
  int rc = fr_condition_create(parent, &handle);
  if (rc != 0) return rc;
  set_condition_kernel<<<1, 1, 0, s>>>((cudaGraphConditionalHandle)handle, (const bool*)pred);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return failed(err);
  return add_if_node(s, (cudaGraphConditionalHandle)handle, body);  // after the kernel
}

extern "C" int fr_if_node_begin_handle(unsigned long long handle, void* parent, void* body) {
  return add_if_node((cudaStream_t)parent, (cudaGraphConditionalHandle)handle, body);
}

extern "C" int fr_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return failed(err);
  *out = (void*)s;
  return 0;
}

extern "C" int fr_if_node_end(void* body) {
  cudaGraph_t graph;
  cudaError_t err = cudaStreamEndCapture((cudaStream_t)body, &graph);
  return err == cudaSuccess ? 0 : failed(err);
}
