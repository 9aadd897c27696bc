// A device-side while loop over a captured Gauss-Newton iteration, for
// Hopper (sm_90a).  Bound through ctypes by ops/tracking_gn.py.
//
// Replaces: the lax.while_loop of mast3r_slam_tpu/ops/tracking_gn.py
// _gn_loop, which XLA runs on the device: the iteration repeats while the
// solve is ok, has not converged and has run fewer than max_iters times,
// and the host reads nothing between iterations.
//
// Design: a CUDA graph of two nodes.  The first is a child graph, the
// prologue (torch's capture of the problem's set-up and the loop state's
// initial values, iters = 0 among them).  The second is a WHILE
// conditional node (CUDA 12.4+) whose body is a child graph, one
// iteration (torch's capture, updating the loop state in place), then the
// one-thread kernel below, which counts the iteration and sets the
// node's condition from the iteration's `active` flag.  The condition
// starts at its default, 1 (the loop's first test always passes for
// max_iters >= 1), at every launch.  One graph launch runs the whole loop
// and stops after the last active iteration, so a converged solve costs
// only the iterations it took.

#include <cuda_runtime.h>

namespace {

__global__ void gn_while_continue(cudaGraphConditionalHandle handle, const bool* active,
                                  int* iters, int max_iters) {
  const int it = *iters + 1;
  *iters = it;
  cudaGraphSetConditional(handle, (*active && it < max_iters) ? 1u : 0u);
}

}  // namespace

// Builds and instantiates [prologue] -> WHILE { [body] -> continue } from
// two captured graphs (cloned, so the caller keeps ownership).  `active`
// (bool) and `iters` (int32) are device scalars that the prologue sets and
// the body updates.  Returns 0, or 10000 x the failing step (1-7, in the
// order below) + its CUDA error code; *exec_out is the executable graph.
extern "C" int gn_while_build(void* prologue, void* body, const void* active, void* iters,
                              int max_iters, void** exec_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return 10000 + err;
  cudaGraphNode_t pro = nullptr;
  err = cudaGraphAddChildGraphNode(&pro, graph, nullptr, 0,
                                   reinterpret_cast<cudaGraph_t>(prologue));
  if (err != cudaSuccess) return 20000 + err;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 1, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return 30000 + err;
  cudaGraphNodeParams cond = {};
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = handle;
  cond.conditional.type = cudaGraphCondTypeWhile;
  cond.conditional.size = 1;
  cudaGraphNode_t loop = nullptr;
  err = cudaGraphAddNode(&loop, graph, &pro, 1, &cond);
  if (err != cudaSuccess) return 40000 + err;
  cudaGraph_t loop_body = cond.conditional.phGraph_out[0];

  cudaGraphNode_t step = nullptr;
  err = cudaGraphAddChildGraphNode(&step, loop_body, nullptr, 0,
                                   reinterpret_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return 50000 + err;
  const bool* active_p = static_cast<const bool*>(active);
  int* iters_p = static_cast<int*>(iters);
  void* args[] = {&handle, &active_p, &iters_p, &max_iters};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(gn_while_continue);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t next = nullptr;
  err = cudaGraphAddKernelNode(&next, loop_body, &step, 1, &kp);
  if (err != cudaSuccess) return 60000 + err;

  cudaGraphExec_t exec = nullptr;
  err = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (err != cudaSuccess) return 70000 + err;
  *exec_out = exec;
  return cudaSuccess;
}

// Launches the executable graph on `stream`.
extern "C" int gn_while_launch(void* exec, void* stream) {
  return cudaGraphLaunch(reinterpret_cast<cudaGraphExec_t>(exec),
                         reinterpret_cast<cudaStream_t>(stream));
}

// Debug: the node count of each type (index cudaGraphNodeType, < 16) in a
// graph, child graphs counted as one node.
extern "C" int gn_while_node_types(void* graph, int* counts) {
  size_t n = 0;
  cudaGraph_t g = reinterpret_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err == cudaSuccess && t < 16) counts[t] += 1;
  }
  delete[] nodes;
  return err;
}
