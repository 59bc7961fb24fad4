// IF nodes for CUDA graphs that PyTorch captures (sm_90a, CUDA >= 12.4).
//
// Counterpart of the JAX package's lax.while_loop conditions in
// inference/nuts_batched.py (the leaf loop's `(j < num_leaves) & any(alive)`):
// XLA keeps such a loop on the device; a CUDA graph keeps it there with a
// conditional node, whose body the device runs or skips at each replay by a
// flag that a kernel of the same graph sets. PyTorch's own binding of these
// nodes is newer than some installed versions, so the port binds them here,
// through a plain C interface (ctypes, no PyTorch headers):
//
//   graph_if_begin(stream, pred, body_stream)
//       on the graph being captured on `stream`: a one-thread kernel that sets
//       a new conditional handle from the device bool *pred, then an IF node
//       on that handle after it, which becomes the stream's capture
//       dependency; the node's body graph is then captured from body_stream;
//   graph_if_end(body_stream, &n_nodes)
//       ends the body's capture and gives the number of nodes in it;
//   graph_capture_nodes(stream, &n_nodes)
//       the number of top-level nodes of the graph being captured on stream.
//
// Each returns a cudaError_t (0 on success). The set kernel is one thread
// reading one byte: its cost is its launch within the graph (bound by neither
// bytes nor operations).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
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

int graph_if_begin(void* stream_ptr, const void* pred, void* body_stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dependencies now end at the set kernel
  err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
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

int graph_if_end(void* body_stream_ptr, unsigned long long* n_nodes) {
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

}  // extern "C"
