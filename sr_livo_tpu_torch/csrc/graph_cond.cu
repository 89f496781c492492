// Conditional nodes (CUDA 12.3 and later) built into a CUDA graph while a
// stream captures it: the glue of `utils/graphs.py::while_loop` and `cond`.
//
// Replaces no TPU kernel: XLA runs the JAX package's `lax.while_loop` and
// `lax.cond` on the device by itself, and a CUDA graph holds a fixed
// sequence of nodes, so a loop in a captured program either runs every
// round up to its bound (masked rounds) or sits in a WHILE node, whose body
// graph the device relaunches while a condition value holds.  PyTorch does
// not expose such nodes, so this file builds them:
//
//   cond_begin  (on a stream that is capturing graph P)
//     - creates a conditional handle on P and captures `set_condition`,
//       which copies the device flag (a bool) into the handle's value;
//     - adds an IF or WHILE node after it (`cudaGraphAddNode`);
//     - ends the stream's capture of P and begins capturing the node's body
//       graph on the same stream (`cudaStreamBeginCaptureToGraph`), so what
//       the caller launches next lands in the body.
//   cond_end
//     - for a WHILE node captures `set_condition` once more, at the body's
//       end, from the flag the body wrote;
//     - ends the body's capture and resumes capturing P after the node.
//   cond_abort: cond_end without the flag, for a body that raised.
//
// The same stream keeps capturing throughout, so the caller's library
// handles and workspaces (cuBLAS's is kept per stream) are those of the
// enclosing capture.  Bound: one thread reads one byte and sets one value;
// a node costs its launch, a few microseconds.  Built by `kernels.load`
// (nvcc, sm_90a) and bound with ctypes; every function returns a
// cudaError_t.

#include <cuda_runtime.h>

#include <cstring>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// The stream's capture: its status, graph and current dependencies.
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr,
                                  n_deps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n_deps);
#endif
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t n_deps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(node, graph, deps, n_deps, params);
#endif
}

// The port's programs capture in thread-local mode (`Program._capture`).
constexpr cudaStreamCaptureMode kMode = cudaStreamCaptureModeThreadLocal;

// Ends the capture of the body and resumes that of `parent` after `node`;
// the first error of the two.
cudaError_t resume(cudaStream_t s, cudaGraph_t parent, cudaGraphNode_t node) {
  cudaGraph_t body = nullptr;
  const cudaError_t ended = cudaStreamEndCapture(s, &body);
  const cudaError_t begun =
      cudaStreamBeginCaptureToGraph(s, parent, &node, nullptr, 1, kMode);
  return ended != cudaSuccess ? ended : begun;
}

}  // namespace

extern "C" {

// Adds an IF (`loop` 0) or WHILE (`loop` 1) node on the device bool at
// `flag` to the graph `stream` captures, and switches the stream to the
// node's body graph.  Out: the handle, the parent graph, the node and the
// body graph, for cond_end.
int cond_begin(void* stream, int loop, const void* flag,
               unsigned long long* handle_out, void** parent_out,
               void** node_out, void** body_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t parent;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(s, &status, &parent, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) {
    return cudaErrorIllegalState;
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, parent, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, s>>>(handle,
                                static_cast<const unsigned char*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(s, &status, &parent, &deps, &n_deps);
  if (err != cudaSuccess) return err;

  // zeroed storage: C++ deletes the union's default constructor
  alignas(cudaGraphNodeParams) unsigned char raw[sizeof(cudaGraphNodeParams)];
  std::memset(raw, 0, sizeof(raw));
  cudaGraphNodeParams* params = reinterpret_cast<cudaGraphNodeParams*>(raw);
  params->type = cudaGraphNodeTypeConditional;
  params->conditional.handle = handle;
  params->conditional.type =
      loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params->conditional.size = 1;
  cudaGraphNode_t node;
  err = add_node(&node, parent, deps, n_deps, params);
  if (err != cudaSuccess) return err;
  cudaGraph_t body = params->conditional.phGraph_out[0];

  cudaGraph_t ended = nullptr;
  err = cudaStreamEndCapture(s, &ended);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(s, body, nullptr, nullptr, 0, kMode);
  if (err != cudaSuccess) {
    // back to the parent, so that its capture can end
    cudaStreamBeginCaptureToGraph(s, parent, &node, nullptr, 1, kMode);
    return err;
  }
  *handle_out = handle;
  *parent_out = parent;
  *node_out = node;
  *body_out = body;
  return cudaSuccess;
}

// Closes the body that cond_begin opened: for a WHILE node (`loop` 1) the
// condition is set again from `flag`, then the stream captures the parent
// graph again, after the node.
int cond_end(void* stream, int loop, unsigned long long handle,
             const void* flag, void* parent, void* node) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (loop) {
    set_condition<<<1, 1, 0, s>>>(handle,
                                  static_cast<const unsigned char*>(flag));
    err = cudaGetLastError();
  }
  const cudaError_t back = resume(s, static_cast<cudaGraph_t>(parent),
                                  static_cast<cudaGraphNode_t>(node));
  return err != cudaSuccess ? err : back;
}

// Closes a body whose capture failed (the caller reports its error).
int cond_abort(void* stream, void* parent, void* node) {
  return resume(static_cast<cudaStream_t>(stream),
                static_cast<cudaGraph_t>(parent),
                static_cast<cudaGraphNode_t>(node));
}

const char* cond_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
