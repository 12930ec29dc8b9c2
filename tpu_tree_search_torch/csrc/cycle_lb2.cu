// Kernel 8: one whole device-resident PFSP lb2 search cycle on the pool.
//
// Replaces the TPU kernel `_mega_lb2_kernel` (tpu_tree_search/ops/megakernel.py,
// built by `_lb2_cycle_call`, with the epilogue `_pfsp_epilogue` and the
// in-VMEM compaction `_compact_push`; wired by the lb2 branch of
// `make_cycle`), together with the engine steps around it in
// `engine/resident.py` `loop_fns`: the loop condition, the pop, and the
// write of the survivors back into the pool.
//
// It is kernel 2 (cycle_lb1.cu, whose header note gives the state layout
// and the launch sequence) with launch 1 computing lb2 instead of lb1 into
// the (M*n) int32 plane: the loop condition, the pop and the leaf fold of
// launch 1, and launches 2-3 (count, emit), are the shared code of
// cycle_pfsp.cuh. Launch 1's pop writes each row, one element a thread,
// where the emit's 32-parent blocks read it (`pfsp_stash_row`), whatever
// its own parents a block. The keep test is the unstaged one,
// open & ~leaf & lb2 < best, as in the JAX megakernel (`make_cycle`'s
// note: it equals the staged keep, since lb2 >= lb1). A leaf child has no
// free job, so its lb2 is its makespan, which the fold takes into the
// incumbent. Launch 1 writes the open slots of the plane only; the count
// launch reads no other.
//
// What bounds it on an H100: the integer instructions of launch 1, kernel
// 6's per-parent pair pass (lb2_common.cuh `lb2p_bounds`: one forward and
// one backward walk over each (parent, pair)'s free jobs, where a Johnson
// pass per child cost P*n*r a parent); the bytes moved are kernel 2's.
// Launch 1 takes kernel 6's block shape (`tts_lb2p_shape`): at M = 1024
// every block fits on the card at once, so two parents a block and one
// thread a (parent, pair) task keep the chains short; at M = 49152 512
// threads loop over the tasks of 32 parents a block.
//
// The bodies of the three launches live in cycle_lb2.cuh and
// cycle_pfsp.cuh, which kernel 9c (tiled_lb2.cu, the streamed cycle) runs
// too, under its own kernel names and with the tile boundaries' row.
#include "cycle_lb2.cuh"

// The dynamic shared memory of the largest launch-1 block on a route
// (lb2_bounds.cu's entry of the same name).
extern "C" long long cycle_lb2_smem(int n, int m, int P, int global) {
  return tts_lb2p_smem_max(global != 0, n, m, P);
}

// Launch 1's shape in the last cycle: parents, threads, shared memory,
// fits, route.
static Lb2Shape cycle_lb2_last;
extern "C" void cycle_lb2_last_shape(int* out) {
  out[0] = cycle_lb2_last.parents;
  out[1] = cycle_lb2_last.threads;
  out[2] = cycle_lb2_last.smem;
  out[3] = cycle_lb2_last.fits;
  out[4] = cycle_lb2_last.global;
}

#define TTS_CYCLE_LB2_ENTRY(NAME, T)                                          \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,             \
                      void* chunk_vals, void* chunk_aux, void* lb,           \
                      void* blkcnt, const void* ptm_t, const void* heads,    \
                      const void* pairinfo, const void* tab, const void* inv, \
                      int n, int m, int P, int route, int M, int C,          \
                      int mterm, int K, unsigned long long cond,             \
                      int in_graph, void* clk, void* stream) {               \
    return launch_lb2_cycle<T, false>(                                       \
        pool_vals, pool_aux, st, chunk_vals, chunk_aux, lb, blkcnt, nullptr, \
        ptm_t, heads, pairinfo, tab, inv, n, m, P, route, M, M, C, mterm, K, \
        cond, in_graph, clk, stream, &cycle_lb2_last);                       \
  }

TTS_CYCLE_LB2_ENTRY(cycle_lb2_i8, int8_t)
TTS_CYCLE_LB2_ENTRY(cycle_lb2_i32, int32_t)
