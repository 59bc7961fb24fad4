// WHILE nodes for CUDA graphs that PyTorch captures (sm_90a, CUDA >= 12.4).
//
// Counterpart of the JAX package's leaf loop in inference/nuts_batched.py,
// a lax.while_loop on `(j < num_leaves) & any(alive)` (:222-223, :323): XLA
// keeps the loop on the device; a CUDA graph keeps it there with a WHILE
// conditional node, whose body the device runs again while a condition handle
// is non-zero. A kernel sets the handle: upstream of the node in the same
// graph for the first test, inside the body for the next ones (the NUTS
// leaf's commit kernel L2, csrc/nuts_leaf.cu, sets it from its pair counter and
// the chains' alive flags). PyTorch's own binding of conditional nodes is
// newer than some installed versions, so the port binds them here, through a
// plain C interface (ctypes, no PyTorch headers):
//
//   graph_cond_handle(stream, &handle)
//       a new conditional handle on the graph being captured on `stream`,
//       reset to 0 at every launch of the graph (cudaGraphCondAssignDefault);
//   graph_while_begin(stream, handle, body_stream)
//       a WHILE node on `handle` after the work captured so far on `stream`,
//       which becomes the stream's capture dependency; the node's body graph
//       is then captured from body_stream;
//   graph_while_end(body_stream, &n_nodes)
//       ends the body's capture and gives the number of nodes in it;
//   graph_capture_nodes(stream, &n_nodes)
//       the number of top-level nodes of the graph being captured on stream;
//   graph_while_probe(stream, handle, counter, limit)
//       launches a one-thread kernel that advances the device int *counter
//       and sets `handle` to (*counter < *limit): the body with which
//       chip_smoke.py's [graph-if] checks and times the WHILE node.
//
// Each returns a cudaError_t (0 on success); no call falls back.

#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(cudaGraphConditionalHandle handle, int* counter, const int* limit) {
  const int k = *counter + 1;
  *counter = k;
  cudaGraphSetConditional(handle, k < *limit ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, nullptr,
                                             n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" {

int graph_cond_handle(void* stream_ptr, unsigned long long* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream_ptr), &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, cudaGraphCondAssignDefault);
  *handle = h;
  return err;
}

int graph_while_begin(void* stream_ptr, unsigned long long handle, void* body_stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream_ptr),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
}

int graph_while_end(void* body_stream_ptr, unsigned long long* n_nodes) {
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream_ptr), &body);
  if (err != cudaSuccess) return err;
  size_t n = 0;
  err = cudaGraphGetNodes(body, nullptr, &n);
  *n_nodes = n;
  return err;
}

int graph_capture_nodes(void* stream_ptr, unsigned long long* n_nodes) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream_ptr), &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *n_nodes = n;
  return err;
}

int graph_while_probe(void* stream_ptr, unsigned long long handle, void* counter,
                      const void* limit) {
  probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      handle, static_cast<int*>(counter), static_cast<const int*>(limit));
  return cudaGetLastError();
}

}  // extern "C"
