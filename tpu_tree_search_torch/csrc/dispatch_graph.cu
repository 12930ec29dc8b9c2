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
//      stream in cudaStreamBeginCaptureToGraph mode, and nothing else: the
//      entry, given the node's handle (cycle_common.cuh TtsCond), has its
//      emit's last block count the body's run in st[ST_RUNS] and set the
//      condition from the state it has just written.
//      A body the cycle does not end that way (the unfused cycle, torch
//      operations of `engine/resident.py`) ends with `dispatch_cond`, a
//      node that counts the run and sets the condition from `st`. The
//      host reads the runs as the cycle's launches; a run past termination
//      would show as more runs than cycles.
// The condition is the engine's: size >= m, size + M*n <= C (the
// headroom of one fan-out) and cycles < K (cycle_common.cuh
// tts_loop_active, one function for every node and cycle that sets it).
// So one dispatch is one cudaGraphLaunch, and a cycle past termination is
// never launched.
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
// Telemetry (obs/counters.py, obs/phases.py) builds its own graphs; off,
// the graph is the one above, node for node:
//   - counters (TTS_OBS=1): `dispatch_init` also zeroes the counter block
//     st[ST_CTR..ST_CTR_SOL], and the body's last node is
//     `dispatch_cond_obs` (after a fused cycle too, which then sets no
//     condition), which folds the cycle into the block before it does what
//     `dispatch_cond` does: the counterpart of
//     `obs_counters.update` in the JAX `lax.while_loop` body
//     (tpu_tree_search/engine/resident.py:284-292). Not a TPU kernel.
//   - the phase clock (TTS_PHASEPROF=1, phase_clock.cuh): a seed
//     `phase_mark` between the init node and the while node, and the
//     cycle's marks inside the body, enqueued by the cycle entry itself
//     (its `clk` argument).
// Both blocks ride the state the host reads once a dispatch.
//
// The batched dispatch (`batch_init`, a body of B captured cycles,
// `batch_cond`) is built by batch_graph_create and batch_graph_end_body,
// below, an unfused slot's cycle under an `if` node of its own after a
// `slot_gate` (slot_gate_begin, slot_gate_end); the mesh dispatch (rounds of the batched init and while node, each
// followed by a captured balance step) by mesh_graph_create,
// mesh_graph_add_round and mesh_graph_end_child.
//
// Conditional nodes need CUDA 12.4 or later; where the installation is
// older, dispatch_graph_create returns the error.
#include <cuda.h>

#include <vector>

#include "cycle_common.cuh"
#include "phase_clock.cuh"

__device__ __forceinline__ unsigned dispatch_active(const int* st, int m,
                                                    long long Mn, int C,
                                                    int K) {
  return tts_loop_active(st[ST_SIZE], st[ST_CYCLES], m, Mn, C, K);
}

__global__ void dispatch_init(int* st, cudaGraphConditionalHandle h, int m,
                              long long Mn, int C, int K, int obs) {
  st[ST_TREE] = 0;
  st[ST_SOL] = 0;
  st[ST_CYCLES] = 0;
  st[ST_RUNS] = 0;
  if (obs)
    for (int i = ST_CTR; i <= ST_CTR_SOL; ++i) st[i] = 0;
  cudaGraphSetConditional(h, dispatch_active(st, m, Mn, C, K));
}

// The last node of a body whose cycle does not set the condition itself
// (the unfused cycle): counts the body's run (the cycle launched once) and
// sets the condition.
__global__ void dispatch_cond(int* st, cudaGraphConditionalHandle h, int m,
                              long long Mn, int C, int K) {
  st[ST_RUNS] += 1;
  cudaGraphSetConditional(h, dispatch_active(st, m, Mn, C, K));
}

// The counter block's update after one cycle of the body (the plain
// version: `ops/dispatch.py` `dispatch_cond_obs_plain`), in obs/counters.py
// SLOTS order: popped += cnt; pushed and leaves += the cycle's tree and sol
// increments (st[2], st[3] less the values the block last saw); pruned +=
// cnt*n - both; overflow += 0 (the fused cycle has no overflow branch: the
// loop condition reserves M*n rows); pool_hwm = max(size); surv_hwm =
// max(tree increment); push_rows += M*n, as the JAX one-kernel cycle
// reports it. A dispatch's counts fit int32 (the K clamp: K*M*n < 2**31).
// One thread: a cache line of loads and stores, its cost a graph node.
__device__ __forceinline__ void obs_count_cycle(int* st, int n, long long Mn) {
  const int tree = st[ST_TREE], sol = st[ST_SOL], cnt = st[ST_CNT];
  const int tree_inc = tree - st[ST_CTR_TREE];
  const int sol_inc = sol - st[ST_CTR_SOL];
  int* c = st + ST_CTR;
  c[0] += cnt;
  c[1] += tree_inc;
  c[2] += sol_inc;
  c[3] += cnt * n - tree_inc - sol_inc;
  c[5] = max(c[5], st[ST_SIZE]);
  c[6] = max(c[6], tree_inc);
  c[7] += static_cast<int>(Mn);
  st[ST_CTR_TREE] = tree;
  st[ST_CTR_SOL] = sol;
}

// `dispatch_cond` with the counter block (TTS_OBS=1): the body's last node.
__global__ void dispatch_cond_obs(int* st, cudaGraphConditionalHandle h,
                                  int m, long long Mn, int C, int K, int n) {
  obs_count_cycle(st, n, Mn);
  st[ST_RUNS] += 1;
  cudaGraphSetConditional(h, dispatch_active(st, m, Mn, C, K));
}

// The batched dispatch: B loop states in one (B, ST_LEN) int32 tensor, a
// row a slot, and one graph for the batch (`ops/dispatch.py` BatchGraph),
// the counterpart of the JAX batched `lax.while_loop`
// (tpu_tree_search/engine/batched.py:112-144), whose condition is the OR of
// the slots' conditions and whose body masks each slot's update with its
// own condition. Here the body is each slot's cycle, captured in slot
// order, then one `batch_cond` node; a slot whose condition is false runs
// an exact no-op (launch 1 of its cycle clears st[ST_ACTIVE], the later
// launches return at once). Thread i of the one block handles slot i.
__device__ __forceinline__ int* batch_row(int* st, int i) {
  return st + static_cast<long long>(i) * ST_LEN;
}

// `dispatch_init` for B slots: each slot's tree, sol, cycles and runs (and
// with `obs` its counter block) zeroed; the condition is the OR.
__global__ void batch_init(int* st, int B, cudaGraphConditionalHandle h,
                           int m, long long Mn, int C, int K, int obs) {
  const int i = threadIdx.x;
  int live = 0;
  if (i < B) {
    int* s = batch_row(st, i);
    s[ST_TREE] = 0;
    s[ST_SOL] = 0;
    s[ST_CYCLES] = 0;
    s[ST_RUNS] = 0;
    if (obs)
      for (int j = ST_CTR; j <= ST_CTR_SOL; ++j) s[j] = 0;
    live = dispatch_active(s, m, Mn, C, K);
  }
  const int any = __syncthreads_or(live);
  if (i == 0) cudaGraphSetConditional(h, any);
}

// The batched body's last node: only a slot whose cycle ran this round
// (st[ST_ACTIVE], set by the cycle's launch 1) counts the run and, with
// counters (n > 0, the child slots a parent), folds the cycle into its
// block; a frozen slot's block is left as it is, so each slot's runs are
// its cycles. The condition is the OR of the slots'.
template <bool OBS>
__device__ __forceinline__ void batch_cond_body(int* st, int B,
                                                cudaGraphConditionalHandle h,
                                                int m, long long Mn, int C,
                                                int K, int n) {
  const int i = threadIdx.x;
  int live = 0;
  if (i < B) {
    int* s = batch_row(st, i);
    if (s[ST_ACTIVE]) {
      if (OBS) obs_count_cycle(s, n, Mn);
      s[ST_RUNS] += 1;
    }
    live = dispatch_active(s, m, Mn, C, K);
  }
  const int any = __syncthreads_or(live);
  if (i == 0) cudaGraphSetConditional(h, any);
}

__global__ void batch_cond(int* st, int B, cudaGraphConditionalHandle h,
                           int m, long long Mn, int C, int K) {
  batch_cond_body<false>(st, B, h, m, Mn, C, K, 0);
}

// `batch_cond` with the counter block (TTS_OBS=1): one block a slot.
__global__ void batch_cond_obs(int* st, int B, cudaGraphConditionalHandle h,
                               int m, long long Mn, int C, int K, int n) {
  batch_cond_body<true>(st, B, h, m, Mn, C, K, n);
}

// A batch or mesh slot's gate, ahead of its unfused cycle (`ops/dispatch.py`
// `gated`): st[ST_ACTIVE] and the condition of the slot's `if` node set
// from the slot's loop condition. The unfused cycle is torch work of fixed
// shapes that would run in full on a frozen slot; under its `if` node a
// frozen slot launches nothing, and its runs are its cycles' launches.
__global__ void slot_gate(int* st, cudaGraphConditionalHandle h, int m,
                          long long Mn, int C, int K) {
  const unsigned live = dispatch_active(st, m, Mn, C, K);
  st[ST_ACTIVE] = static_cast<int>(live);
  cudaGraphSetConditional(h, live);
}

// Threads of the batch nodes' one block: B rounded up to a warp.
static dim3 batch_block(int B) { return dim3((B + 31) / 32 * 32); }

// A new graph: the init node (`obs`: zeroing the counter block too), with a
// clock `clk` a seed mark, then the while node with an empty body. With
// B > 0 the graph is a batch's: `st` holds B rows and the init node is
// `batch_init`. Returns the graph, the body graph to capture the cycle (or
// the B cycles) into, and the condition's handle. Returns the CUDA error,
// 0 on success.
static int graph_create(void* st, int B, int m, long long Mn, int C, int K,
                        int obs, void* clk, void** graph_out, void** body_out,
                        unsigned long long* handle_out) {
  cudaGraph_t g = nullptr;
  cudaError_t err = cudaGraphCreate(&g, 0);
  if (err) return static_cast<int>(err);
  cudaGraphConditionalHandle h = 0;
  err = cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault);
  cudaGraphNode_t init = nullptr, loop = nullptr;
  if (!err && B > 0) {
    void* args[] = {&st, &B, &h, &m, &Mn, &C, &K, &obs};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(batch_init);
    kp.gridDim = dim3(1);
    kp.blockDim = batch_block(B);
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&init, g, nullptr, 0, &kp);
  } else if (!err) {
    void* args[] = {&st, &h, &m, &Mn, &C, &K, &obs};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(dispatch_init);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&init, g, nullptr, 0, &kp);
  }
  if (!err && clk) {
    int slot = 0, flags = PH_SEED;
    void* args[] = {&clk, &slot, &flags};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(phase_mark);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t seed = nullptr;
    err = cudaGraphAddKernelNode(&seed, g, &init, 1, &kp);
    init = seed;
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

extern "C" int dispatch_graph_create(void* st, int m, long long Mn, int C,
                                     int K, int obs, void* clk,
                                     void** graph_out, void** body_out,
                                     unsigned long long* handle_out) {
  return graph_create(st, 0, m, Mn, C, K, obs, clk, graph_out, body_out,
                      handle_out);
}

// A batch's graph over the (B, ST_LEN) states `st` (1 <= B <= 1024).
extern "C" int batch_graph_create(void* st, int B, int m, long long Mn, int C,
                                  int K, int obs, void** graph_out,
                                  void** body_out,
                                  unsigned long long* handle_out) {
  if (B < 1 || B > 1024) return static_cast<int>(cudaErrorInvalidValue);
  return graph_create(st, B, m, Mn, C, K, obs, nullptr, graph_out, body_out,
                      handle_out);
}

// The mesh-resident tier's dispatch (`ops/mesh.py` MeshGraph, the
// counterpart of the JAX `shard_step`, tpu_tree_search/parallel/
// resident_mesh.py:157-285): D shards' (D, ST_LEN) states, and for each of
// its rounds a `batch_init` node, a while node whose body is the D shards'
// cycles and `batch_cond`, and a child graph captured from the balance
// step (mesh_balance.cu, with the phase clock's `loop` and `balance` marks
// around it). Inside a JAX round the shards do not interact, so running
// their cycles in lockstep, a finished shard frozen, gives each shard the
// cycles of its own `lax.while_loop`.
extern "C" int mesh_graph_create(void** graph_out) {
  cudaGraph_t g = nullptr;
  const cudaError_t err = cudaGraphCreate(&g, 0);
  *graph_out = g;
  return static_cast<int>(err);
}

// One round appended after node `dep` (null: the graph's first): its
// `batch_init` over the B states (`zero_block`: the counter block zeroed
// too, the dispatch's first round), with a clock `clk` a seed mark after
// it, and a while node with an empty body. Returns the body to capture
// the cycles into, the condition's handle and the while node (the balance
// step's dependency).
extern "C" int mesh_graph_add_round(void* graph, void* dep, void* st, int B,
                                    int m, long long Mn, int C, int K,
                                    int zero_block, void* clk,
                                    void** body_out,
                                    unsigned long long* handle_out,
                                    void** node_out) {
  if (B < 1 || B > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h = 0;
  cudaError_t err =
      cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault);
  cudaGraphNode_t prev = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t init = nullptr, loop = nullptr;
  if (!err) {
    void* args[] = {&st, &B, &h, &m, &Mn, &C, &K, &zero_block};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(batch_init);
    kp.gridDim = dim3(1);
    kp.blockDim = batch_block(B);
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&init, g, prev ? &prev : nullptr,
                                 prev ? 1 : 0, &kp);
  }
  if (!err && clk) {
    int slot = 0, flags = PH_SEED;
    void* args[] = {&clk, &slot, &flags};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(phase_mark);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t seed = nullptr;
    err = cudaGraphAddKernelNode(&seed, g, &init, 1, &kp);
    init = seed;
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
  if (err) return static_cast<int>(err);
  *body_out = cp.conditional.phGraph_out[0];
  *handle_out = h;
  *node_out = loop;
  return 0;
}

// Start capturing `stream`'s work into a graph of its own (a round's
// balance step).
extern "C" int mesh_graph_begin_child(void* stream) {
  return static_cast<int>(cudaStreamBeginCapture(
      static_cast<cudaStream_t>(stream), cudaStreamCaptureModeRelaxed));
}

// End that capture and, with `ok`, add what it captured to `graph` as a
// child graph node after `dep`; returns the node (the next round's
// dependency).
extern "C" int mesh_graph_end_child(void* stream, int ok, void* graph,
                                    void* dep, void** node_out) {
  cudaGraph_t child = nullptr;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &child);
  if (!err && ok) {
    cudaGraphNode_t prev = static_cast<cudaGraphNode_t>(dep);
    cudaGraphNode_t node = nullptr;
    err = cudaGraphAddChildGraphNode(&node, static_cast<cudaGraph_t>(graph),
                                     &prev, 1, child);
    *node_out = node;
  }
  if (child) cudaGraphDestroy(child);
  return static_cast<int>(err);
}

// Start capturing `stream`'s work into the while node's body.
extern "C" int dispatch_graph_begin_body(void* body, void* stream) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(body),
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed));
}

// End the body: with `ok`, enqueue `dispatch_cond_obs` (with `obs` > 0, a
// cycle of `obs` child slots a parent), or `dispatch_cond` unless the
// captured cycle sets the condition itself (`own`), after the captured
// cycle first; without (the cycle's capture failed), only end the capture.
extern "C" int dispatch_graph_end_body(void* stream, int ok, void* st,
                                       unsigned long long h, int m,
                                       long long Mn, int C, int K, int obs,
                                       int own) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (ok && obs) {
    dispatch_cond_obs<<<1, 1, 0, s>>>(static_cast<int*>(st), h, m, Mn, C, K,
                                      obs);
    err = cudaGetLastError();
  } else if (ok && !own) {
    dispatch_cond<<<1, 1, 0, s>>>(static_cast<int*>(st), h, m, Mn, C, K);
    err = cudaGetLastError();
  }
  cudaGraph_t out = nullptr;
  const cudaError_t end = cudaStreamEndCapture(s, &out);
  return static_cast<int>(err ? err : end);
}

// End a batch's body: with `ok`, enqueue `batch_cond` (with `obs` > 0,
// `batch_cond_obs` of cycles of `obs` child slots a parent) after the B
// captured cycles; without, only end the capture.
extern "C" int batch_graph_end_body(void* stream, int ok, void* st, int B,
                                    unsigned long long h, int m, long long Mn,
                                    int C, int K, int obs) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (ok && obs) {
    batch_cond_obs<<<1, batch_block(B), 0, s>>>(static_cast<int*>(st), B, h,
                                                m, Mn, C, K, obs);
    err = cudaGetLastError();
  } else if (ok) {
    batch_cond<<<1, batch_block(B), 0, s>>>(static_cast<int*>(st), B, h, m,
                                            Mn, C, K);
    err = cudaGetLastError();
  }
  cudaGraph_t out = nullptr;
  const cudaError_t end = cudaStreamEndCapture(s, &out);
  return static_cast<int>(err ? err : end);
}

// Inside a body's capture on `stream`: the slot gate over the slot's state
// row `st`, an `if` node after it (added to the graph being captured, which
// then depends on it), and `body_stream` capturing into the `if` node's
// body. The caller enqueues the slot's cycle on `body_stream`, then calls
// slot_gate_end. The handle is created in the graph that holds the node.
// Returns the body in `body_out` (the audit reads its nodes: this runtime
// may not read a conditional node's type, let alone its body).
extern "C" int slot_gate_begin(void* stream, void* body_stream, void* st,
                               int m, long long Mn, int C, int K,
                               void** body_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t g = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &g, &deps, nullptr, &ndeps);
#else
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &g, &deps, &ndeps);
#endif
  if (!err && status != cudaStreamCaptureStatusActive)
    err = cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle h = 0;
  if (!err)
    err = cudaGraphConditionalHandleCreate(&h, g, 0,
                                           cudaGraphCondAssignDefault);
  if (!err) {
    slot_gate<<<1, 1, 0, s>>>(static_cast<int*>(st), h, m, Mn, C, K);
    err = cudaGetLastError();
  }
  if (!err)
#if CUDART_VERSION >= 13000
    err = cudaStreamGetCaptureInfo(s, &status, nullptr, &g, &deps, nullptr,
                                   &ndeps);
#else
    err = cudaStreamGetCaptureInfo(s, &status, nullptr, &g, &deps, &ndeps);
#endif
  cudaGraphNodeParams cp = {};
  cudaGraphNode_t node = nullptr;
  if (!err) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = h;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&node, g, deps, nullptr, ndeps, &cp);
#else
    err = cudaGraphAddNode(&node, g, deps, ndeps, &cp);
#endif
  }
  if (!err)
#if CUDART_VERSION >= 13000
    err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                              cudaStreamSetCaptureDependencies);
#else
    err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                              cudaStreamSetCaptureDependencies);
#endif
  if (!err) {
    *body_out = cp.conditional.phGraph_out[0];
    err = cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(body_stream), cp.conditional.phGraph_out[0],
        nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
  }
  return static_cast<int>(err);
}

// End the capture of an `if` node's body (slot_gate_begin).
extern "C" int slot_gate_end(void* body_stream) {
  cudaGraph_t out = nullptr;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &out));
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

// One phase mark on `stream` (the unfused cycle's marks, from Python).
extern "C" int phase_mark_enqueue(void* clk, int slot, int flags,
                                  void* stream) {
  return tts_phase_mark(clk, slot, flags, static_cast<cudaStream_t>(stream));
}

// One mark whose slot is chosen on the device: `alt` where the word `*sel`
// is nonzero, else `slot` (the unfused cycle's push or overflow branch).
__global__ void phase_mark_if(long long* clk, int slot, int alt, int flags,
                              const int* sel) {
  const long long now = tts_globaltimer();
  const int at = *sel ? alt : slot;
  clk[at] += now - clk[PH_TPREV];
  clk[PH_TPREV] = now;
  if (flags & PH_OPEN) clk[PH_T0] = now;
  if (flags & PH_CLOSE) clk[PH_TOTAL] += now - clk[PH_T0];
}

extern "C" int phase_mark_if_enqueue(void* clk, int slot, int alt, int flags,
                                     void* sel, void* stream) {
  if (!clk) return 0;
  phase_mark_if<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(clk), slot, alt, flags,
      static_cast<const int*>(sel));
  return static_cast<int>(cudaGetLastError());
}

// The clock's step: one thread reads %globaltimer `reads` times back to
// back and writes each difference from the read before to out[0..reads-1].
__global__ void globaltimer_probe(long long* out, int reads) {
  long long prev = tts_globaltimer();
  for (int i = 0; i < reads; ++i) {
    const long long now = tts_globaltimer();
    out[i] = now - prev;
    prev = now;
  }
}

extern "C" int globaltimer_probe_enqueue(void* out, int reads, void* stream) {
  globaltimer_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), reads);
  return static_cast<int>(cudaGetLastError());
}

// The name of a kernel node's function: through this library's runtime
// when it registered the kernel, else through the driver (a captured
// cycle's kernels are registered by the runtime of their own library),
// "?" when neither knows it.
typedef CUresult (*tts_cuFuncGetName_t)(const char**, CUfunction);
typedef CUresult (*tts_cuKernelGetName_t)(const char**, CUkernel);
typedef CUresult (*tts_cuGraphKernelNodeGetParams_t)(
    CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);

static void* tts_driver_entry(const char* symbol) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion(symbol, &fn, 12030, cudaEnableDefault, &q);
#else
  cudaGetDriverEntryPoint(symbol, &fn, cudaEnableDefault, &q);
#endif
  return q == cudaDriverEntryPointSuccess ? fn : nullptr;
}

static const char* tts_kernel_node_name(cudaGraphNode_t node) {
  const char* name = nullptr;
  cudaKernelNodeParams kp = {};
  if (cudaGraphKernelNodeGetParams(node, &kp) == cudaSuccess &&
      cudaFuncGetName(&name, kp.func) == cudaSuccess && name)
    return name;
  cudaGetLastError();  // clear the runtime's miss
  static auto get_params = reinterpret_cast<tts_cuGraphKernelNodeGetParams_t>(
      tts_driver_entry("cuGraphKernelNodeGetParams"));
  static auto func_name = reinterpret_cast<tts_cuFuncGetName_t>(
      tts_driver_entry("cuFuncGetName"));
  static auto kernel_name = reinterpret_cast<tts_cuKernelGetName_t>(
      tts_driver_entry("cuKernelGetName"));
  CUDA_KERNEL_NODE_PARAMS p = {};
  if (get_params && get_params(reinterpret_cast<CUgraphNode>(node), &p) ==
                        CUDA_SUCCESS) {
    if (p.func && func_name && func_name(&name, p.func) == CUDA_SUCCESS &&
        name)
      return name;
    if (p.kern && kernel_name &&
        kernel_name(&name, p.kern) == CUDA_SUCCESS && name)
      return name;
  }
  return "?";
}

// Whether a memcpy node has a host end (a pageable, pinned or mapped host
// buffer on either side): its direction, else (cudaMemcpyDefault) the
// pointers' memory types.
static bool tts_memcpy_host_end(cudaGraphNode_t node) {
  cudaMemcpy3DParms p = {};
  if (cudaGraphMemcpyNodeGetParams(node, &p) != cudaSuccess) {
    cudaGetLastError();
    return true;  // unreadable: assume the worst
  }
  if (p.kind == cudaMemcpyHostToDevice || p.kind == cudaMemcpyDeviceToHost ||
      p.kind == cudaMemcpyHostToHost)
    return true;
  if (p.kind == cudaMemcpyDeviceToDevice) return false;
  for (const void* ptr : {p.srcPtr.ptr, p.dstPtr.ptr}) {
    if (!ptr) continue;  // an array end: device memory
    cudaPointerAttributes a = {};
    if (cudaPointerGetAttributes(&a, ptr) != cudaSuccess) {
      cudaGetLastError();
      return true;
    }
    if (a.type != cudaMemoryTypeDevice && a.type != cudaMemoryTypeManaged)
      return true;
  }
  return false;
}

// The graph a child graph node holds (a mesh round's balance step), owned
// by the node's graph.
extern "C" int graph_child_graph(void* node, void** graph_out) {
  cudaGraph_t g = nullptr;
  const cudaError_t err =
      cudaGraphChildGraphNodeGetGraph(static_cast<cudaGraphNode_t>(node), &g);
  *graph_out = g;
  return static_cast<int>(err);
}

// The kernels of a graph's nodes (the dispatch graph or its body), in the
// order cudaGraphGetNodes gives: each kernel node's name (mangled) in `len`
// bytes of `names`, "-" for a node of another type (the while node), at
// most `cap` of them; *count is the graph's node count. With `types` (or
// NULL), each node's cudaGraphNodeType, -1 where this runtime cannot read
// it, with 0x100 added to a memcpy node that has a host end. Lets tests,
// chip_smoke.py and `check --device cuda` hold each graph to the nodes it
// should have.
extern "C" int dispatch_graph_kernels(void* graph, int cap, char* names,
                                      int len, int* types, int* count) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err) return static_cast<int>(err);
  *count = static_cast<int>(n);
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err) return static_cast<int>(err);
  for (size_t i = 0; i < n && static_cast<int>(i) < cap; ++i) {
    // This runtime may not know a newer driver's node types (the while
    // node): those read as "-".
    cudaGraphNodeType type = cudaGraphNodeTypeEmpty;
    int code = 0;
    if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) {
      cudaGetLastError();
      type = cudaGraphNodeTypeEmpty;
      code = -1;
    } else {
      code = static_cast<int>(type);
      if (type == cudaGraphNodeTypeMemcpy && tts_memcpy_host_end(nodes[i]))
        code |= 0x100;
    }
    if (types) types[i] = code;
    const char* name =
        type == cudaGraphNodeTypeKernel ? tts_kernel_node_name(nodes[i]) : "-";
    char* out = names + i * len;
    int j = 0;
    for (; j < len - 1 && name[j]; ++j) out[j] = name[j];
    out[j] = 0;
  }
  return 0;
}
