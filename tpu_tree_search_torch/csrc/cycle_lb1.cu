// Kernel 2: one whole device-resident PFSP lb1 search cycle on the pool.
//
// Replaces the TPU kernel `_mega_lb1_kernel` (tpu_tree_search/ops/megakernel.py,
// built by `_lb1_cycle_call`, with the epilogue `_pfsp_epilogue` and the
// in-VMEM compaction `_compact_push`; wired by `make_cycle`), together with
// the engine steps around it in `engine/resident.py` `loop_fns`: the loop
// condition, the pop, and the write of the survivors back into the pool.
//
// The loop state is one small int32 device tensor `st`:
//   st[0] size  st[1] best  st[2] tree  st[3] sol  st[4] cycles
//   st[5] active  st[6] cnt  st[7] start2  st[8] base  (this cycle's pop)
// One cycle is three launches on the caller's stream, each one block per
// 32 parents:
//   1. bounds: evaluate the loop condition of `resident.py:421-423`
//      (size >= m, size + M*n <= C, cycles < K) from st; block 0 records
//      cnt = min(size, M), start2 = clip(size - cnt, 0, C - M) (the valid
//      window of `resident.py:228-236`) and base = size - cnt; each block
//      copies its M-window rows into its stash region and into shared
//      memory as aligned 16-byte words, computes its parents' fronts and
//      remaining work, lb1 of every child slot into an (M*n) int32 plane,
//      and folds the leaf makespans into st[1] with atomicMin (so the keep
//      test sees the final incumbent);
//   2. count (cycle_pfsp.cuh): keep = open & ~leaf & lb < best, read once
//      from the plane and packed into ceil(n/32) mask words a parent; the
//      block's survivor count, and its leaves added to st[3];
//   3. emit (cycle_pfsp.cuh): each block sums the survivor counts of the
//      blocks before it, ranks its survivors from the mask words, builds
//      them in shared memory (parent row with positions limit1+1 and k
//      swapped, and limit1 + 1) in rank order and stores the block's span
//      of the pool as aligned 16-byte words: the survivors land at the
//      pool's size in exact (parent, slot) order, as the dense compaction
//      of the JAX engine leaves them. The last block writes size, tree and
//      cycles.
// When the condition is false, launch 1 clears st[5] and every launch of the
// cycle returns at once: an exact no-op. So the host can enqueue K cycles
// with no synchronisation and read st once (the `lax.while_loop`
// counterpart). In the dispatch graph (dispatch_graph.cu) the cycle is the
// while node's whole body: the emit's last block counts the body's run in
// st[9] and sets the node's condition from the size and cycles it has just
// written (cycle_common.cuh TtsCond), so no condition kernel runs between
// two cycles. The N-Queens and streamed cycles do the same.
//
// Why not one launch, as on the TPU: the TPU ran the cycle as grid=(1,) (or a
// sequential grid with an SMEM carry). Hopper blocks run in no order, so
// the incumbent folded over all leaves before any keep test is a launch
// boundary, and the emit, which writes over popped rows, reads its parents
// from launch 1's stash.
//
// What bounds it on an H100: at M = 49152 (ta014, n = 20, m = 10) a full
// cycle must move the popped rows (21 B a row at int8) and the survivor
// rows, about 4 MB, 1.3 us at 3.35 TB/s. It takes about 30x that: the
// bounds launch is bound by the instructions it issues (the per-child
// m-step chain and the parents' prologues) and by each block's chain of
// dependent loads and barriers, and each launch pays a few microseconds of
// fixed cost. What the design does, against the four-launch version it
// replaces (measured in PERF.md, section 6):
//   - no scan launch: the count launch publishes one count a block, and
//     each emit block sums its predecessors' counts with 16-byte loads that
//     go out beside its stash loads (a ticket for a last-block scan,
//     measured, cost more than the launch it saved: a fence and an atomic
//     in every block);
//   - one keep mask a parent: the emit reads neither the plane nor the
//     slot flags again, and no slot loop divides by n (the split of a
//     thread's first slot and of its stride is taken once);
//   - the pop and the survivor span move as aligned 16-byte words, the
//     span built in shared memory in rank order;
//   - the parent prologue: the remaining work is the machine's total over
//     all jobs less what the front scheduled (the row is a permutation), so
//     no pass over the unscheduled positions; when the grid fits on the
//     card at once the front is a wavefront over the machines (l1 + m
//     steps, one lane a machine), else one thread a parent, which issues
//     the fewest instructions, with each parent's front at an odd
//     shared-memory stride so 32 parents fall on 32 banks;
//   - blocks of 128 threads that loop over their slots when one thread a
//     slot would not fit on the card at once, so the grid is one or two
//     waves, not four.
//
// The bodies of the three launches live in cycle_lb1.cuh and
// cycle_pfsp.cuh, which kernel 9b (tiled_lb1.cu, the streamed cycle) runs
// too, under its own kernel names and with the tile boundaries' row.
#include "cycle_lb1.cuh"

#define TTS_CYCLE_ENTRY(NAME, T)                                             \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,            \
                      void* chunk_vals, void* chunk_aux, void* lb,          \
                      void* blkcnt, const void* ptm_t,                      \
                      const void* heads, const void* tails, int n, int m,   \
                      int M, int C, int mterm, int K,                       \
                      unsigned long long cond, int in_graph, void* clk,     \
                      void* stream) {                                        \
    return launch_lb1_cycle<T, false>(pool_vals, pool_aux, st, chunk_vals,  \
                                      chunk_aux, lb, blkcnt, nullptr, ptm_t, \
                                      heads, tails, n, m, M, M, C, mterm, K, \
                                      cond, in_graph, clk, stream);          \
  }

TTS_CYCLE_ENTRY(cycle_lb1_i8, int8_t)
TTS_CYCLE_ENTRY(cycle_lb1_i32, int32_t)
