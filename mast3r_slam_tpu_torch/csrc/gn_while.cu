// Device-side while loops over captured Gauss-Newton pieces, for Hopper
// (sm_90a).  Bound through ctypes by ops/gn_program.py, for
// ops/tracking_gn.py and ops/global_gn.py.
//
// Replaces: the lax.while_loops of mast3r_slam_tpu/ops/tracking_gn.py
// _gn_loop and of mast3r_slam_tpu/ops/global_gn.py _gn_core (the GN loop,
// :724-753) and _assemble_and_solve_pcg (its CG loop, :500-518), which XLA
// runs on the device: a loop repeats while its condition holds and has run
// fewer than its count, and the host reads nothing between iterations.
//
// Design: CUDA graphs of captured pieces (torch's captures, added as child
// graphs) joined by WHILE conditional nodes (CUDA 12.4+).
//   - gn_while_build (the tracking GN): [prologue] -> WHILE { [body] ->
//     continue }.  The prologue sets the loop state's initial values,
//     iters = 0 among them; the body is one iteration, updating the state
//     in place; `continue` (the one-thread kernel below) counts the
//     iteration and sets the node's condition from the iteration's
//     `active` flag.  The condition starts at its default, 1 (the loop's
//     first test always passes for max_iters >= 1), at every launch.
//   - gn_while_build_nested (the global GN on the PCG route): [prologue] ->
//     WHILE { [pre] -> test -> WHILE { [step] -> continue } -> [post] ->
//     continue }.  `pre` is an outer iteration up to the CG loop's state
//     (it zeroes the CG count), `test` sets the inner node's condition from
//     the CG loop's first test (which may fail: a residual already below
//     the tolerance), `step` is one CG iteration, `post` the rest of the
//     outer iteration.  The inner handle belongs to the outer body graph,
//     which holds the inner node, and is set by a kernel in that graph
//     before the inner node runs, on every outer iteration.
// One graph launch runs the whole loop and stops after the last active
// iteration, so a converged solve costs only the iterations it took.

#include <cuda_runtime.h>

namespace {

__global__ void gn_while_continue(cudaGraphConditionalHandle handle, const bool* active,
                                  int* iters, int max_iters) {
  const int it = *iters + 1;
  *iters = it;
  cudaGraphSetConditional(handle, (*active && it < max_iters) ? 1u : 0u);
}

// The loop's test before its first iteration: the count so far (0) and the flag.
__global__ void gn_while_test(cudaGraphConditionalHandle handle, const bool* active,
                              int* iters, int max_iters) {
  cudaGraphSetConditional(handle, (*active && *iters < max_iters) ? 1u : 0u);
}

// A WHILE node in `graph` after `deps`; its body graph into *body.
cudaError_t add_while(cudaGraph_t graph, const cudaGraphNode_t* deps, size_t n_deps,
                      unsigned flags, cudaGraphConditionalHandle* handle,
                      cudaGraphNode_t* node, cudaGraph_t* body) {
  cudaError_t err = cudaGraphConditionalHandleCreate(handle, graph, 1, flags);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams cond = {};
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = *handle;
  cond.conditional.type = cudaGraphCondTypeWhile;
  cond.conditional.size = 1;
  err = cudaGraphAddNode(node, graph, deps, n_deps, &cond);
  if (err != cudaSuccess) return err;
  *body = cond.conditional.phGraph_out[0];
  return cudaSuccess;
}

// A one-thread kernel node `func(handle, active, iters, max_iters)` after `dep`.
cudaError_t add_flag_kernel(cudaGraph_t graph, cudaGraphNode_t dep, void* func,
                            cudaGraphConditionalHandle handle, const void* active,
                            void* iters, int max_iters, cudaGraphNode_t* node) {
  const bool* active_p = static_cast<const bool*>(active);
  int* iters_p = static_cast<int*>(iters);
  void* args[] = {&handle, &active_p, &iters_p, &max_iters};
  cudaKernelNodeParams kp = {};
  kp.func = func;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, &dep, 1, &kp);
}

cudaError_t add_child(cudaGraph_t graph, const cudaGraphNode_t* dep, void* child,
                      cudaGraphNode_t* node) {
  return cudaGraphAddChildGraphNode(node, graph, dep, dep ? 1 : 0,
                                    reinterpret_cast<cudaGraph_t>(child));
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
  err = add_child(graph, nullptr, prologue, &pro);
  if (err != cudaSuccess) return 20000 + err;

  cudaGraphConditionalHandle handle;
  cudaGraphNode_t loop = nullptr;
  cudaGraph_t loop_body = nullptr;
  err = add_while(graph, &pro, 1, cudaGraphCondAssignDefault, &handle, &loop, &loop_body);
  if (err != cudaSuccess) return 40000 + err;

  cudaGraphNode_t step = nullptr;
  err = add_child(loop_body, nullptr, body, &step);
  if (err != cudaSuccess) return 50000 + err;
  cudaGraphNode_t next = nullptr;
  err = add_flag_kernel(loop_body, step, reinterpret_cast<void*>(gn_while_continue), handle,
                        active, iters, max_iters, &next);
  if (err != cudaSuccess) return 60000 + err;

  cudaGraphExec_t exec = nullptr;
  err = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (err != cudaSuccess) return 70000 + err;
  *exec_out = exec;
  return cudaSuccess;
}

// Builds and instantiates [prologue] -> WHILE { [pre] -> test -> WHILE {
// [step] -> continue } -> [post] -> continue } from four captured graphs
// (cloned).  The outer loop runs while `active` holds, counted in `iters`
// against max_iters (its first test passes, as above); the inner loop
// while `inner_active` holds, counted in `inner_iters` against inner_max,
// which `pre` sets to 0.  Returns 0, or 10000 x the failing step (1-12, in
// the order below) + its CUDA error code; *exec_out is the executable graph.
extern "C" int gn_while_build_nested(void* prologue, void* pre, void* step, void* post,
                                     const void* active, void* iters, int max_iters,
                                     const void* inner_active, void* inner_iters,
                                     int inner_max, void** exec_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return 10000 + err;
  cudaGraphNode_t pro = nullptr;
  err = add_child(graph, nullptr, prologue, &pro);
  if (err != cudaSuccess) return 20000 + err;

  cudaGraphConditionalHandle outer;
  cudaGraphNode_t outer_node = nullptr;
  cudaGraph_t outer_body = nullptr;
  err = add_while(graph, &pro, 1, cudaGraphCondAssignDefault, &outer, &outer_node,
                  &outer_body);
  if (err != cudaSuccess) return 30000 + err;

  cudaGraphNode_t pre_node = nullptr;
  err = add_child(outer_body, nullptr, pre, &pre_node);
  if (err != cudaSuccess) return 40000 + err;
  // the inner handle on the graph that holds the inner node; `test` sets it
  // on every outer iteration, so its default is never read
  cudaGraphConditionalHandle inner;
  cudaGraphNode_t test = nullptr, inner_node = nullptr;
  cudaGraph_t inner_body = nullptr;
  err = cudaGraphConditionalHandleCreate(&inner, outer_body, 0, 0);
  if (err != cudaSuccess) return 50000 + err;
  err = add_flag_kernel(outer_body, pre_node, reinterpret_cast<void*>(gn_while_test), inner,
                        inner_active, inner_iters, inner_max, &test);
  if (err != cudaSuccess) return 60000 + err;
  cudaGraphNodeParams cond = {};
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = inner;
  cond.conditional.type = cudaGraphCondTypeWhile;
  cond.conditional.size = 1;
  err = cudaGraphAddNode(&inner_node, outer_body, &test, 1, &cond);
  if (err != cudaSuccess) return 70000 + err;
  inner_body = cond.conditional.phGraph_out[0];

  cudaGraphNode_t step_node = nullptr, inner_next = nullptr;
  err = add_child(inner_body, nullptr, step, &step_node);
  if (err != cudaSuccess) return 80000 + err;
  err = add_flag_kernel(inner_body, step_node, reinterpret_cast<void*>(gn_while_continue),
                        inner, inner_active, inner_iters, inner_max, &inner_next);
  if (err != cudaSuccess) return 90000 + err;

  cudaGraphNode_t post_node = nullptr, outer_next = nullptr;
  err = add_child(outer_body, &inner_node, post, &post_node);
  if (err != cudaSuccess) return 100000 + err;
  err = add_flag_kernel(outer_body, post_node, reinterpret_cast<void*>(gn_while_continue),
                        outer, active, iters, max_iters, &outer_next);
  if (err != cudaSuccess) return 110000 + err;

  cudaGraphExec_t exec = nullptr;
  err = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (err != cudaSuccess) return 120000 + err;
  *exec_out = exec;
  return cudaSuccess;
}

// Launches the executable graph on `stream`.
extern "C" int gn_while_launch(void* exec, void* stream) {
  return cudaGraphLaunch(reinterpret_cast<cudaGraphExec_t>(exec),
                         reinterpret_cast<cudaStream_t>(stream));
}

// Frees an executable graph (a program dropped from its cache).
extern "C" int gn_while_destroy(void* exec) {
  return cudaGraphExecDestroy(reinterpret_cast<cudaGraphExec_t>(exec));
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
