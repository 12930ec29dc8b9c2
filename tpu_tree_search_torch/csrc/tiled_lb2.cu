// Kernel 9c (`chip_smoke.py` phase `kernel11`): one streamed (tiled)
// device-resident PFSP lb2 search cycle on the pool.
//
// Replaces the TPU kernel `_mega_lb2_tiled_kernel`
// (tpu_tree_search/ops/megakernel.py, built by `_lb2_tiled_call`, grid
// (2, G) over G = M / Mt pool tiles with an SMEM carry; wired by the tiled
// lb2 branch of `make_cycle` and the stitch of `engine/resident.py`).
//
// The TPU kernel sweeps twice (phase 0 bounds every tile and folds every
// leaf into the incumbent, phase 1 prunes and compacts each tile against
// the final incumbent) because VMEM cannot hold the chunk
// (`megakernel.py:406-420`). The pool and state after a streamed cycle are
// the single-tile cycle's; what it computes beyond them is only the (G, 4)
// per-tile scalars (each tile's survivor offset and count, the cumulative
// leaf count through it, and the incumbent: `_tile_scalar_lanes`). On
// Hopper a tile has no memory reason to exist, so this kernel runs kernel
// 8's three launches (cycle_lb2.cuh, cycle_pfsp.cuh, TILES = true) and
// writes the tile prefixes beside them:
//   1. bounds (kernel 8's launch 1, the TPU's phase 0): the loop condition,
//      the pop into the stash, the per-parent pair pass of lb2_common.cuh
//      (`lb2p_bounds`: one forward and one backward walk a (parent, pair))
//      in the block shape of `tts_lb2p_shape`, and the leaf fold into st[1].
//      The launch boundary is the TPU's phase boundary: no block prunes
//      before every leaf is folded;
//   2. count (kernel 8's): the keep masks against the final incumbent, and
//      each block of 32 parents publishes its survivors and its leaves (its
//      popped parents at limit1 = n - 2) as one pair;
//   3. emit (kernel 8's): the predecessor sum of the pairs, the survivors
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
// What bounds it on an H100: as kernel 8, the integer instructions of the
// pair pass, P*(n + 18*r) operations a parent with r free jobs; the bytes
// moved are kernel 2's. The earlier form ran one Johnson pass over P*n
// ordered slots for every child (P*n*r a parent), each parent's front on
// one thread, loaded the tables once a tile, and carried the tiles with a
// decoupled look-back serial in one thread a block; this form has none of
// those. It takes kernel 8's table routes (lb2_common.cuh: SMEM, or GLOBAL
// past n = 256, int16 values or shared memory), chosen from the shape by
// `ops/lb2_kernel.py` `johnson_operands`.
#include "cycle_lb2.cuh"

// The dynamic shared memory of the largest launch-1 block on a route.
extern "C" long long tiled_lb2_smem(int n, int m, int P, int global) {
  return tts_lb2p_smem_max(global != 0, n, m, P);
}

// Launch 1's shape in the last cycle: parents, threads, shared memory,
// fits, route.
static Lb2Shape tiled_lb2_last;
extern "C" void tiled_lb2_last_shape(int* out) {
  out[0] = tiled_lb2_last.parents;
  out[1] = tiled_lb2_last.threads;
  out[2] = tiled_lb2_last.smem;
  out[3] = tiled_lb2_last.fits;
  out[4] = tiled_lb2_last.global;
}

#define TTS_TILED_LB2_ENTRY(NAME, T)                                        \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,           \
                      void* stash, void* chunk_aux, void* lb, void* blkcnt, \
                      void* bnd, const void* ptm_t, const void* heads,     \
                      const void* pairinfo, const void* tab,               \
                      const void* inv, int n, int m, int P, int route,     \
                      int M, int mt, int C, int mterm, int K,              \
                      unsigned long long cond, int in_graph, void* clk,    \
                      void* stream) {                                      \
    return launch_lb2_cycle<T, true>(pool_vals, pool_aux, st, stash,       \
                                     chunk_aux, lb, blkcnt, bnd, ptm_t,    \
                                     heads, pairinfo, tab, inv, n, m, P,   \
                                     route, M, mt, C, mterm, K, cond,      \
                                     in_graph, clk, stream,                \
                                     &tiled_lb2_last);                     \
  }

TTS_TILED_LB2_ENTRY(tiled_lb2_i8, int8_t)
TTS_TILED_LB2_ENTRY(tiled_lb2_i32, int32_t)
