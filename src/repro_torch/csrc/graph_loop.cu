// The device-resident loop: `jax.lax.while_loop` as a conditional WHILE
// node of a CUDA graph (CUDA >= 12.4).
//
// Replaces no Pallas kernel.  It is the counterpart of the reference's
// `lax.while_loop`: every local phase (src/repro/exec/local_phase.py) and,
// with `device_loop=True`, the whole run (src/repro/exec/driver.py,
// `while_engine`) loop on the device, and the host reads nothing until the
// loop has ended.
//
// Two pieces:
//   * `graphhp_set_condition`, a one-thread kernel: it reads a device flag
//     (a 0-d int32 tensor at a fixed address, written by the loop's
//     condition) and sets the WHILE node's condition from it.  One launch
//     before the node (a condition false on entry runs zero trips, as
//     `lax.while_loop` does) and one at the end of every trip.
//   * the host entries that build the node.  `graphhp_while_in_capture`
//     inserts it into the graph that a stream is capturing (torch's
//     `CUDAGraph`), after the stream's current dependencies, and makes the
//     node the stream's only dependency; `graphhp_while_in_graph` adds one
//     inside another loop's body.  The body is filled from the host with
//     child-graph nodes of pre-captured bodies (`graphhp_add_child`) and
//     nested loops, and closed with the set-condition kernel
//     (`graphhp_add_set_condition`).
//
// Bound on the H100: one 4-byte read and one launch a trip; the loop's
// cost is its body's kernels plus the node's scheduling.  Nothing here
// allocates: the flag and every buffer a body touches are torch tensors.
#include <cuda_runtime.h>

namespace {

__global__ void graphhp_set_condition(cudaGraphConditionalHandle handle,
                                      const int* flag) {
  cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

cudaError_t add_set_condition(cudaGraph_t graph, const cudaGraphNode_t* deps,
                              size_t n_deps, cudaGraphConditionalHandle handle,
                              const int* flag, cudaGraphNode_t* node) {
  void* args[] = {&handle, &flag};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(graphhp_set_condition);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

// set-condition kernel after `deps`, then the WHILE node after it
cudaError_t add_while(cudaGraph_t graph, const cudaGraphNode_t* deps,
                      size_t n_deps, const int* flag, cudaGraphNode_t* node,
                      cudaGraph_t* body, cudaGraphConditionalHandle* handle) {
  cudaError_t e = cudaGraphConditionalHandleCreate(handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  cudaGraphNode_t set;
  e = add_set_condition(graph, deps, n_deps, *handle, flag, &set);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = *handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(node, graph, &set, nullptr, 1, &p);
#else
  e = cudaGraphAddNode(node, graph, &set, 1, &p);
#endif
  if (e != cudaSuccess) return e;
  *body = p.conditional.phGraph_out[0];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// A WHILE node in the graph `stream` is capturing.  Returns the node, its
// (empty) body graph and its condition handle.
int graphhp_while_in_capture(void* stream, const void* flag, void** node,
                             void** body, unsigned long long* handle) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                           nullptr, &n_deps);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                           &n_deps);
#endif
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphNode_t w;
  cudaGraph_t b;
  cudaGraphConditionalHandle h;
  e = add_while(graph, deps, n_deps, static_cast<const int*>(flag), &w, &b, &h);
  if (e != cudaSuccess) return e;
#if CUDART_VERSION >= 13000
  e = cudaStreamUpdateCaptureDependencies(s, &w, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaStreamUpdateCaptureDependencies(s, &w, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return e;
  *node = w;
  *body = b;
  *handle = h;
  return cudaSuccess;
}

// A WHILE node in `graph` (another loop's body) after `dep` (null: none).
int graphhp_while_in_graph(void* graph, void* dep, const void* flag,
                           void** node, void** body,
                           unsigned long long* handle) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t w;
  cudaGraph_t b;
  cudaGraphConditionalHandle h;
  cudaError_t e = add_while(static_cast<cudaGraph_t>(graph), d ? &d : nullptr,
                            d ? 1 : 0, static_cast<const int*>(flag), &w, &b,
                            &h);
  if (e != cudaSuccess) return e;
  *node = w;
  *body = b;
  *handle = h;
  return cudaSuccess;
}

// A child-graph node of `child` (cloned) in `graph` after `dep`.
int graphhp_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t n;
  cudaError_t e = cudaGraphAddChildGraphNode(
      &n, static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0,
      static_cast<cudaGraph_t>(child));
  if (e != cudaSuccess) return e;
  *node = n;
  return cudaSuccess;
}

// The set-condition kernel of `handle` from `flag`, in `graph` after `dep`:
// the last node of a loop's body.
int graphhp_add_set_condition(void* graph, void* dep,
                              unsigned long long handle, const void* flag,
                              void** node) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t n;
  cudaError_t e = add_set_condition(static_cast<cudaGraph_t>(graph),
                                    d ? &d : nullptr, d ? 1 : 0, handle,
                                    static_cast<const int*>(flag), &n);
  if (e != cudaSuccess) return e;
  *node = n;
  return cudaSuccess;
}

}  // extern "C"
