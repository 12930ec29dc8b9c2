// Kernel 9b (`chip_smoke.py` phase `kernel9`): one streamed (tiled)
// device-resident PFSP lb1 search cycle on the pool.
//
// Replaces the TPU kernel `_mega_lb1_tiled_kernel`
// (tpu_tree_search/ops/megakernel.py, built by `_lb1_tiled_call`, grid
// (2, G) over G = M / Mt pool tiles with an SMEM carry; wired by the tiled
// lb1 branch of `make_cycle` and the stitch of `engine/resident.py`).
//
// The TPU kernel sweeps twice (phase 0 bounds every tile and folds every
// leaf into the incumbent, phase 1 prunes and compacts each tile against
// the final incumbent) because VMEM cannot hold the chunk. The pool and
// state after a streamed cycle are the single-tile cycle's; what it
// computes beyond them is only the (G, 4) per-tile scalars (each tile's
// survivor offset and count, the cumulative leaf count through it, and
// the incumbent: `_tile_scalar_lanes`). On Hopper a tile has no memory
// reason to exist, so this kernel runs kernel 2's three launches
// (cycle_lb1.cuh, cycle_pfsp.cuh, TILES = true) and writes the tile
// prefixes beside them:
//   1. bounds (kernel 2's launch 1, the TPU's phase 0): the loop condition,
//      the pop into the stash and into shared memory as aligned 16-byte
//      words, the parents' fronts (a wavefront over the machines when the
//      grid fits on the card at once, else one thread a parent, with the
//      remaining work from the machines' column sums), lb1 of every child
//      slot into the (M*n) int32 plane, and the leaf fold into st[1]. The
//      launch boundary is the TPU's phase boundary: no block prunes before
//      every leaf is folded;
//   2. count (kernel 2's): the keep masks against the final incumbent, and
//      each block of 32 parents publishes its survivors and its leaves (its
//      popped parents at limit1 = n - 2) as one pair;
//   3. emit (kernel 2's): the predecessor sum of the pairs, the survivors
//      as one span of the pool, and warp 0's rows of the boundary row
//      (cycle_common.cuh `emit_tile_bounds`): for each tile boundary t*mt
//      among its parents, the survivors and the leaves before it, and the
//      incumbent; row G (the cycle's tree_inc and sol_inc) from the last
//      block, which adds sol_inc to st[3]. `ops/tiled.py` derives the
//      (G, 4) scalars from the boundary row when they are read (no search
//      reads them).
// When the condition is false every launch returns at once, so K cycles go
// to the stream with no host synchronisation.
//
// What bounds it on an H100: as kernel 2, the bounds launch's instructions
// (the per-child m-step chain and the parents' fronts) and each launch's
// fixed cost; the bytes moved are kernel 2's and the (G + 1, 3) row. The
// earlier form ran one block a tile in groups of 8 parents, each parent's
// front and remaining work on one thread over all n positions, stashed its
// rows byte by byte, and placed the tiles with a decoupled look-back serial
// in one thread a block; this form has none of those. It takes kernel 2's
// shape limits.
#include "cycle_lb1.cuh"

#define TTS_TILED_LB1_ENTRY(NAME, T)                                         \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,            \
                      void* stash, void* chunk_aux, void* lb, void* blkcnt, \
                      void* bnd, const void* ptm_t, const void* heads,      \
                      const void* tails, int n, int m, int M, int mt, int C, \
                      int mterm, int K, unsigned long long cond,            \
                      int in_graph, void* clk, void* stream) {              \
    return launch_lb1_cycle<T, true>(pool_vals, pool_aux, st, stash,        \
                                     chunk_aux, lb, blkcnt, bnd, ptm_t,     \
                                     heads, tails, n, m, M, mt, C, mterm, K, \
                                     cond, in_graph, clk, stream);          \
  }

TTS_TILED_LB1_ENTRY(tiled_lb1_i8, int8_t)
TTS_TILED_LB1_ENTRY(tiled_lb1_i32, int32_t)
