// The device-side branch of a captured frame program (counterpart of the
// jax.lax.cond at mcslam_tpu/tracking_kernels.py:306 inside the jitted
// frame step; no Pallas kernel of the JAX package corresponds to it).
//
// mc_graph_add_if is called while a CUDA stream is capturing a graph: it
// appends to that graph a one-thread kernel that reads a device bool and
// sets a conditional handle from it, then an IF conditional node that
// depends on that kernel and whose body is a copy of `body` (a graph
// captured beforehand), and makes the new node the stream's capture
// dependency, so the work captured next runs after the branch. On replay
// the body runs only where the bool is true; the host never reads it.
//
// The body is embedded as a child graph node, not captured in place: a
// capture into the conditional node's own body graph would need a second
// stream whose allocations the caching allocator would not route to the
// graph's memory pool. Conditional nodes need CUDA 12.4 or later.

#include <cuda_runtime.h>

__global__ void mc_set_cond_kernel(cudaGraphConditionalHandle handle,
                                   const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int mc_graph_add_if(const void* pred, void* body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                           &deps, &n_deps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle handle;
  // the condition resets to 0 at every launch; the kernel sets it
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return e;
  mc_set_cond_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t cond;
  e = cudaGraphAddNode(&cond, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return e;
  cudaGraphNode_t child;
  e = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                 nullptr, 0, static_cast<cudaGraph_t>(body));
  if (e != cudaSuccess) return e;
  return cudaStreamUpdateCaptureDependencies(
      s, &cond, 1, cudaStreamSetCaptureDependencies);
}
