// The K-cycle dispatch as one CUDA graph: the port's counterpart of the
// `lax.while_loop` of the JAX engine's `loop_fns`
// (tpu_tree_search/engine/resident.py), whose condition stops on the
// device. Not a TPU kernel: the host loop's half of the resident engine.
//
// The graph, built once a (program, K rung) by `ops/dispatch.py`:
//   1. `dispatch_init`: zero tree, sol, cycles and the body's runs in the
//      loop state `st` (cycle_common.cuh layout) and set the while node's
//      condition;
//   2. a `while` conditional node whose body is one cycle: the launches
//      of a fused or streamed cycle entry (cycle_lb1.cu, cycle_lb2.cu,
//      cycle_nqueens.cu, tiled_*.cu), captured by calling that entry on a
//      stream in cudaStreamBeginCaptureToGraph mode, then
//      `dispatch_cond`, which counts the body's run in st[ST_RUNS] and
//      sets the condition again from `st`. The host reads the runs as the
//      cycle's launches; a run past termination would show as more runs
//      than cycles.
// The condition is the engine's: size >= m, size + M*n <= C (the
// headroom of one fan-out) and cycles < K. So one dispatch is one
// cudaGraphLaunch, and a cycle past termination is never launched.
//
// The capture runs in relaxed mode: a cycle entry may set a kernel's
// shared-memory attribute and query its occupancy the first time it sees
// a shape (tts_smem_optin, tts_lb2p_shape), which are not stream work.
// Every cycle entry enqueues kernels only (no memset, memcpy or
// synchronisation), so its launches become the body's kernel nodes; the
// graph bakes in their arguments, so the pool, `st`, the scratch and the
// tables must keep their addresses for the graph's life (the engine
// copies a re-uploaded frontier into its existing tensors).
//
// Conditional nodes need CUDA 12.4 or later; where the installation is
// older, dispatch_graph_create returns the error.
#include "cycle_common.cuh"

__device__ __forceinline__ unsigned dispatch_active(const int* st, int m,
                                                    long long Mn, int C,
                                                    int K) {
  const int size = st[ST_SIZE];
  return size >= m && static_cast<long long>(size) + Mn <= C &&
         st[ST_CYCLES] < K;
}

__global__ void dispatch_init(int* st, cudaGraphConditionalHandle h, int m,
                              long long Mn, int C, int K) {
  st[ST_TREE] = 0;
  st[ST_SOL] = 0;
  st[ST_CYCLES] = 0;
  st[ST_RUNS] = 0;
  cudaGraphSetConditional(h, dispatch_active(st, m, Mn, C, K));
}

// The body's last node: counts the body's run (the cycle launched once)
// and sets the condition.
__global__ void dispatch_cond(int* st, cudaGraphConditionalHandle h, int m,
                              long long Mn, int C, int K) {
  st[ST_RUNS] += 1;
  cudaGraphSetConditional(h, dispatch_active(st, m, Mn, C, K));
}

// A new graph: the init node, then the while node with an empty body.
// Returns the graph, the body graph to capture the cycle into, and the
// condition's handle. Returns the CUDA error, 0 on success.
extern "C" int dispatch_graph_create(void* st, int m, long long Mn, int C,
                                     int K, void** graph_out, void** body_out,
                                     unsigned long long* handle_out) {
  cudaGraph_t g = nullptr;
  cudaError_t err = cudaGraphCreate(&g, 0);
  if (err) return static_cast<int>(err);
  cudaGraphConditionalHandle h = 0;
  err = cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault);
  cudaGraphNode_t init = nullptr, loop = nullptr;
  if (!err) {
    void* args[] = {&st, &h, &m, &Mn, &C, &K};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(dispatch_init);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&init, g, nullptr, 0, &kp);
  }
  cudaGraphNodeParams cp = {};
  if (!err) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = h;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&loop, g, &init, nullptr, 1, &cp);
#else
    err = cudaGraphAddNode(&loop, g, &init, 1, &cp);
#endif
  }
  if (err) {
    cudaGraphDestroy(g);
    return static_cast<int>(err);
  }
  *graph_out = g;
  *body_out = cp.conditional.phGraph_out[0];
  *handle_out = h;
  return 0;
}

// Start capturing `stream`'s work into the while node's body.
extern "C" int dispatch_graph_begin_body(void* body, void* stream) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(body),
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed));
}

// End the body: with `ok`, enqueue `dispatch_cond` after the captured cycle
// first; without (the cycle's capture failed), only end the capture.
extern "C" int dispatch_graph_end_body(void* stream, int ok, void* st,
                                       unsigned long long h, int m,
                                       long long Mn, int C, int K) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (ok) {
    dispatch_cond<<<1, 1, 0, s>>>(static_cast<int*>(st), h, m, Mn, C, K);
    err = cudaGetLastError();
  }
  cudaGraph_t out = nullptr;
  const cudaError_t end = cudaStreamEndCapture(s, &out);
  return static_cast<int>(err ? err : end);
}

extern "C" int dispatch_graph_instantiate(void* graph, void** exec_out) {
  cudaGraphExec_t exec = nullptr;
  const cudaError_t err =
      cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0);
  *exec_out = exec;
  return static_cast<int>(err);
}

// One dispatch on `stream`.
extern "C" int dispatch_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int dispatch_graph_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (!err) err = e2;
  }
  return static_cast<int>(err);
}
