// A CUDA graph conditional WHILE node, bound into a stream capture by hand,
// written for Hopper (sm_90a).  It replaces no TPU kernel: it is the exact
// device loop that stands in for a data-dependent `lax.while_loop` of the
// JAX package (the OCC active-writer fixed point,
// deneva_tpu/cc/occ.py:291-292) in a captured tick, where the loop cannot
// read its condition on the host.  The torch of the H100 host has no
// conditional nodes of its own (no `begin_capture_to_while_node`).
//
// Three calls, made by deneva_tpu_torch/ops/device_loop.py:
//
//   dn_while_begin(capture, body)   on a stream that is capturing: a
//       conditional handle (default 1, reset to it at every launch of the
//       graph, so every replay runs the body at least once, as the
//       reference's loop starts with "changed"), a WHILE node of one body
//       graph on the capture's current dependencies, the node made the
//       capture's only dependency, and `body` capturing into the node's
//       body graph;
//   dn_while_set(body, handle, flag) the body's last node: a one-thread
//       kernel that sets the condition to *flag != 0 ("another pass");
//   dn_while_end(body)              ends the body's capture.
//
// The loop then runs on the device until the body sets 0: no bound and no
// host read.  The set-condition kernel reads one byte and computes nothing
// of the loop; its cost is a launch inside the body per pass.
//
// Needs CUDA 12.3 or later (conditional nodes, capture to a graph).
// Plain C interface, loaded through ctypes; every call returns an error
// code (0 on success, -1 if the capture stream is not capturing).

#include <cuda_runtime.h>

#include <cstdint>

#if CUDART_VERSION < 12030
#error "graph_while.cu needs CUDA 12.3 or later"
#endif

namespace {

constexpr int kNotCapturing = -1;

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const unsigned char* flag) {
  cudaGraphSetConditional(handle, flag[0] != 0 ? 1u : 0u);
}

}  // namespace

extern "C" {

int dn_while_begin(void* capture_stream, void* body_stream,
                   unsigned long long* handle_out) {
  auto cap = static_cast<cudaStream_t>(capture_stream);
  auto body = static_cast<cudaStream_t>(body_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t rc = cudaStreamGetCaptureInfo(cap, &status, nullptr, &graph,
                                            &deps, nullptr, &n_deps);
#else
  cudaError_t rc = cudaStreamGetCaptureInfo(cap, &status, nullptr, &graph,
                                            &deps, &n_deps);
#endif
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (status != cudaStreamCaptureStatusActive) return kNotCapturing;

  cudaGraphConditionalHandle handle;
  rc = cudaGraphConditionalHandleCreate(&handle, graph, 1,
                                        cudaGraphCondAssignDefault);
  if (rc != cudaSuccess) return static_cast<int>(rc);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  rc = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  rc = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];

#if CUDART_VERSION >= 13000
  rc = cudaStreamUpdateCaptureDependencies(cap, &node, nullptr, 1,
                                           cudaStreamSetCaptureDependencies);
#else
  rc = cudaStreamUpdateCaptureDependencies(cap, &node, 1,
                                           cudaStreamSetCaptureDependencies);
#endif
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaStreamBeginCaptureToGraph(body, body_graph, nullptr, nullptr, 0,
                                     cudaStreamCaptureModeRelaxed);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *handle_out = handle;
  return 0;
}

int dn_while_set(void* body_stream, unsigned long long handle,
                 const void* flag) {
  set_condition_kernel<<<1, 1, 0, static_cast<cudaStream_t>(body_stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const unsigned char*>(flag));
  return static_cast<int>(cudaGetLastError());
}

int dn_while_end(void* body_stream) {
  cudaGraph_t body_graph = nullptr;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                           &body_graph));
}

const char* dn_while_error_string(int rc) {
  if (rc == kNotCapturing) return "the capture stream is not capturing";
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
