// The solve as one CUDA graph with a device-side loop: a WHILE conditional
// node (CUDA 12.4+) around one BiCGSTABwr iteration.
//
// Replaces nothing of the TPU package's kernels: it is the counterpart of
// the lax.while_loop that eddy_currents_3d_tpu/solvers/bicgstab.py:182
// runs on the device.  torch captures three graphs of static tensors
// (setup, one iteration, finish; solvers/bicgstab.py DeviceLoop) and hands
// their cudaGraph_t here; solve_graph_build joins them as
//
//   setup -> flag -> WHILE (flag != 0) { iteration -> flag } -> finish
//
// where flag is a one-thread kernel that sets the loop's condition to
// (!done && it <= itmax), JAX's cond, from the iteration's device scalars.
// A launch of the result runs the whole solve with no host round trip; the
// iterations after done are never launched.  Bound by launch latency: the
// flag kernel reads 5 bytes.
#include <cuda_runtime.h>

namespace {

__global__ void loop_flag(cudaGraphConditionalHandle handle,
                          const bool* done, const int* it, int itmax) {
  cudaGraphSetConditional(handle, (!*done && *it <= itmax) ? 1u : 0u);
}

cudaError_t add_flag(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t ndeps,
                     cudaGraphConditionalHandle* handle, const bool** done,
                     const int** it, int* itmax) {
  void* args[] = {handle, done, it, itmax};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_flag);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, deps, ndeps, &p);
}

}  // namespace

#define CHECK(call)                   \
  do {                                \
    cudaError_t e_ = (call);          \
    if (e_ != cudaSuccess) {          \
      cudaGraphDestroy(graph);        \
      return static_cast<int>(e_);    \
    }                                 \
  } while (0)

// setup and finish may be null.  Returns a cudaError_t; on success *exec
// holds the instantiated graph (solve_graph_destroy frees it).
extern "C" int solve_graph_build(void* setup, void* body, void* finish,
                                 const void* done_ptr, const void* it_ptr,
                                 int itmax, void** exec) {
  cudaGraph_t graph;
  cudaError_t e0 = cudaGraphCreate(&graph, 0);
  if (e0 != cudaSuccess) return static_cast<int>(e0);
  const bool* done = static_cast<const bool*>(done_ptr);
  const int* it = static_cast<const int*>(it_ptr);
  cudaGraphConditionalHandle handle;
  CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));

  cudaGraphNode_t last = nullptr;
  if (setup != nullptr)
    CHECK(cudaGraphAddChildGraphNode(&last, graph, nullptr, 0,
                                     static_cast<cudaGraph_t>(setup)));
  cudaGraphNode_t flag0;
  CHECK(add_flag(&flag0, graph, last ? &last : nullptr, last ? 1 : 0,
                 &handle, &done, &it, &itmax));

  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  CHECK(cudaGraphAddNode(&loop, graph, &flag0, 1, &cp));
  cudaGraph_t inner = cp.conditional.phGraph_out[0];
  cudaGraphNode_t iter, flag1;
  CHECK(cudaGraphAddChildGraphNode(&iter, inner, nullptr, 0,
                                   static_cast<cudaGraph_t>(body)));
  CHECK(add_flag(&flag1, inner, &iter, 1, &handle, &done, &it, &itmax));

  if (finish != nullptr) {
    cudaGraphNode_t fin;
    CHECK(cudaGraphAddChildGraphNode(&fin, graph, &loop, 1,
                                     static_cast<cudaGraph_t>(finish)));
  }
  cudaGraphExec_t ex;
  CHECK(cudaGraphInstantiate(&ex, graph, 0));
  cudaGraphDestroy(graph);
  *exec = ex;
  return 0;
}

extern "C" int solve_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int solve_graph_destroy(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
