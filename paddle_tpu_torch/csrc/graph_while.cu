// A data-dependent loop inside a CUDA graph: a WHILE conditional node
// (CUDA 12.4 or later), for `while` ops under Executor.bind and run_fused
// (core/graphs.py `run_while`, ops/control_flow_ops.py).
//
// Replaces no TPU kernel. The JAX package lowers a `while` op without a
// gradient to `lax.while_loop`, which XLA runs on the TPU with the
// condition read on the device. A captured step on the card has no host
// read either: the loop is one conditional node whose body graph runs while
// the node's condition handle is nonzero.
//
// graph_while_begin, on a stream that is capturing:
//   1. creates the node's condition handle in the graph being captured;
//   2. captures `set_condition` (one thread), which loads the handle from
//      the loop's condition tensor before the node;
//   3. adds the WHILE node after the stream's current dependencies and
//      makes it the stream's only dependency, so that what the stream
//      captures next runs after the loop;
//   4. starts capturing `body_stream` into the node's body graph.
// The caller then runs one iteration of the body on `body_stream`, which
// ends with the new condition in a device tensor, and graph_while_end
// captures `set_condition` from that tensor as the body's last node and
// ends the body's capture. The device evaluates the handle when the node
// starts and after each run of the body.
//
// A body that draws random numbers: each trip of the node must draw what
// an eager run draws in that trip. A captured random kernel draws at the
// generator's device offset plus an offset fixed at capture
// (csrc/philox_offset.cu), so `add_offset` (one thread) adds the body's
// capture-time increment to the device offset at the end of each trip,
// and once more with its negative after the node: the ops after the loop
// were captured one body's increment further on. At T trips they then
// draw T increments on, as an eager run does, at 0 trips too.
//
// Bound: launch latency; each kernel reads at most one byte or word and
// writes one, once before the node and once an iteration.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const uint8_t* __restrict__ cond) {
  cudaGraphSetConditional(handle, cond[0] ? 1u : 0u);
}

__global__ void clear_condition(cudaGraphConditionalHandle handle) {
  cudaGraphSetConditional(handle, 0u);
}

__global__ void add_offset(int64_t* __restrict__ offset, int64_t delta) {
  offset[0] += delta;
}

}  // namespace

extern "C" {

// Adds `delta` to the one-element int64 device tensor `offset` on
// `stream` (captured when the stream is capturing).
int graph_offset_add(void* stream, void* offset, long long delta) {
  add_offset<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(offset), static_cast<int64_t>(delta));
  return static_cast<int>(cudaGetLastError());
}

int graph_stream_create(void** out) {
  return static_cast<int>(cudaStreamCreateWithFlags(
      reinterpret_cast<cudaStream_t*>(out), cudaStreamNonBlocking));
}

int graph_while_begin(void* stream, void* body_stream, const void* cond,
                      unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t e =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const uint8_t*>(cond));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return static_cast<int>(e);
  *handle_out = handle;
  return 0;
}

// `cond` is null when the body's capture is abandoned (the body raised):
// the body then ends the loop, so that the graph stays well formed until
// its capture fails.
int graph_while_end(void* body_stream, const void* cond,
                    unsigned long long handle) {
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  if (cond != nullptr)
    set_condition<<<1, 1, 0, b>>>(handle, static_cast<const uint8_t*>(cond));
  else
    clear_condition<<<1, 1, 0, b>>>(handle);
  cudaError_t e = cudaGetLastError();
  cudaGraph_t body;
  cudaError_t e2 = cudaStreamEndCapture(b, &body);
  return static_cast<int>(e != cudaSuccess ? e : e2);
}

}  // extern "C"
