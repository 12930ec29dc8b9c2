// Kernel 4: one whole device-resident N-Queens search cycle on the pool.
//
// Replaces the TPU kernel `_mega_nqueens_kernel` (tpu_tree_search/ops/megakernel.py,
// built by `_nqueens_cycle_call`, with the in-VMEM compaction
// `_compact_push`; wired by the N-Queens branch of `make_cycle`), together
// with the engine steps around it in `engine/resident.py` `loop_fns`: the
// loop condition, the pop, and the write of the survivors back into the
// pool. The pool is board (C, N) uint8 and depth (C,) int8 through
// N = 127, int32 beyond (N <= 256, what a uint8 board holds).
//
// The loop state is the int32 tensor `st` of cycle_common.cuh, shared with
// the PFSP cycles (size, best, tree, sol, cycles, active, cnt, start2,
// base). One cycle is two launches on the caller's stream, one block per
// 32 parents in both:
//   1. labels: evaluate the loop condition (size >= m, size + M*N <= C,
//      cycles < K) from st; block 0 records cnt = min(size, M), start2 =
//      clip(size - cnt, 0, C - M) and base = size - cnt; each block copies
//      its M-window rows (one contiguous byte range) into its region of the
//      stash and into shared memory as aligned 16-byte words, computes the
//      safety label of every (parent, slot) with keep = label & valid &
//      depth < N, packs the keeps of a parent into bit k % 32 of its mask
//      word k / 32 (W = 1 through N = 32, up to 8 words at N = 256),
//      publishes its survivor count and adds its popped valid parents
//      at depth == N (the solutions, `megakernel.py:563`) to st[3];
//   2. emit: each block sums the survivor counts of the blocks before it,
//      reads its stash region and mask words, ranks its survivors with one
//      warp scan over its parents and popcounts, builds them in shared
//      memory (parent row with positions depth and k swapped, and
//      depth + 1) in rank order, and stores the block's span of the pool,
//      base + the blocks' survivors before it onward, as aligned 16-byte
//      words: the survivors land at the pool's size in exact (parent, slot)
//      order, as the dense compaction of the JAX engine leaves them. The
//      last block writes size = base + tree_inc, tree += tree_inc and
//      cycles += 1.
// The incumbent st[1] passes through: N-Queens has none. When the condition
// is false, launch 1 clears st[5] and both launches return at once: an
// exact no-op, so the host enqueues K cycles with no synchronisation.
//
// Why two launches and not one: the emit writes over popped rows of blocks
// that may not have stashed them yet (Hopper blocks run in no order), so
// it reads parents only from launch 1's stash, and the survivor offsets
// across blocks need every block's count.
//
// What bounds it on an H100: at M = 50,000 and N = 15 a full cycle must
// move about 0.8 MB of popped rows and 3.1 MB of survivor rows (N + 1
// bytes a row), about 1.2 us at 3.35 TB/s; the label compares (sum depth *
// (N - depth) * 4 a cycle) are a tenth of that. It takes about 14x that:
// each launch pays a few microseconds of fixed cost and each block a chain
// of dependent loads and barriers. What the design does, against the
// three-launch version it replaces (measured in PERF.md, section 6):
//   - no scan launch: the labels launch publishes one count a block, and
//     each emit block sums its predecessors' counts with 16-byte loads that
//     go out beside its stash loads (a ticket for a last-block scan,
//     measured, cost more than the launch it saved);
//   - one mask word a parent at N <= 32 (200 KB a full cycle) in place of a byte a
//     slot (750 KB) read back through a per-thread run of slots;
//   - the pop and the survivor span move as aligned 16-byte words, the
//     span built in shared memory in rank order, in place of single bytes
//     at a 15-byte stride;
//   - blocks of 128 threads that loop over their slots when one thread a
//     slot would not fit on the card at once, so the grid is one wave;
//   - the labels are as they were: g real rounds per (parent, slot).
//
// The bodies of both launches live in cycle_nqueens.cuh, which kernel 9a
// (tiled_nqueens.cu, the streamed cycle) runs too, under its own kernel
// names and with the tile boundaries' row.
#include "cycle_nqueens.cuh"

// The single-tile cycle's kernels: the bodies of cycle_nqueens.cuh with no
// boundary row, at W keep-mask words a parent and depth type A.
template <int W, typename A>
__global__ void nq_cycle_labels(const uint8_t* __restrict__ pool_vals,
                                const A* __restrict__ pool_aux, int* st,
                                uint8_t* __restrict__ stash,
                                A* __restrict__ chunk_aux,
                                uint32_t* __restrict__ mask,
                                int* __restrict__ blkcnt, int N, int g, int M,
                                int C, int mterm, int K) {
  nq_labels_body<false, W, A>(pool_vals, pool_aux, st, stash, chunk_aux, mask,
                               blkcnt, N, g, M, C, mterm, K);
}

template <int W, typename A>
__global__ void nq_cycle_emit(uint8_t* __restrict__ pool_vals,
                              A* __restrict__ pool_aux, int* st,
                              const uint8_t* __restrict__ stash,
                              const A* __restrict__ chunk_aux,
                              const uint32_t* __restrict__ mask,
                              const int* __restrict__ blkcnt, int N, int M,
                              int* __restrict__ bnd, int mt, TtsCond cond) {
  nq_emit_body<false, W, A>(pool_vals, pool_aux, st, stash, chunk_aux, mask,
                             blkcnt, N, M, bnd, mt, cond);
}

// The entries: `cycle_nqueens` takes an int8 depth (N <= 127),
// `cycle_nqueens_i32` an int32 one (N > 127).
#define TTS_NQ_CYCLE_LAUNCH(W, A)                                          \
  launch_nq_cycle<W, A>(nq_cycle_labels<W, A>, nq_cycle_emit<W, A>, pool_vals,     \
                        pool_aux, st, chunk_vals, chunk_aux, keep, blkcnt, \
                        nullptr, N, g, M, M, C, mterm, K, cond, in_graph,  \
                        clk, stream)
#define TTS_NQ_CYCLE_ENTRY(NAME, AUX32)                                    \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,          \
                      void* chunk_vals, void* chunk_aux, void* keep,      \
                      void* blkcnt, int N, int g, int M, int C, int mterm, \
                      int K, unsigned long long cond, int in_graph,       \
                      void* clk, void* stream) {                          \
    TTS_NQ_DISPATCH(N, AUX32, TTS_NQ_CYCLE_LAUNCH);                        \
  }

TTS_NQ_CYCLE_ENTRY(cycle_nqueens, false)
TTS_NQ_CYCLE_ENTRY(cycle_nqueens_i32, true)
