// Kernel 9a (`chip_smoke.py` phase `kernel10`): one streamed (tiled)
// device-resident N-Queens search cycle on the pool.
//
// Replaces the TPU kernel `_mega_nqueens_tiled_kernel`
// (tpu_tree_search/ops/megakernel.py, built by `_nqueens_tiled_call`, grid
// (G,) over G = M / Mt pool tiles with an SMEM carry; wired by the tiled
// N-Queens branch of `make_cycle` and the stitch of `engine/resident.py`).
// The pool is board (C, N) uint8 and depth (C,) int8 through N = 127,
// int32 beyond (N <= 256, what a uint8 board holds).
//
// On the TPU a tile exists because VMEM cannot hold the chunk
// (`megakernel.py:406-420`); the pool and state after a streamed cycle are
// the single-tile cycle's. What the TPU kernel computes beyond the
// single-tile cycle is only the (G, 4) per-tile scalars: each tile's
// survivor offset and count, the cumulative solution count through it, and
// the incumbent (`_tile_scalar_lanes`). On Hopper a tile has no memory
// reason to exist, so this kernel runs kernel 4's two launches
// (cycle_nqueens.cuh, TILES = true) and writes the tile prefixes beside
// them:
//   1. labels (kernel 4's): the loop condition, the 16-byte pop into the
//      stash, the g real label rounds, W keep-mask words a parent; each
//      block of 32 parents publishes its survivors and its solutions (its
//      popped parents at depth N, `megakernel.py:666`) as one pair;
//   2. emit (kernel 4's): each block sums the pairs of the blocks before it
//      with 16-byte loads, ranks its survivors and stores them as one span
//      of aligned 16-byte words; warp 0 then writes the block's rows of the
//      boundary row (cycle_common.cuh `emit_tile_bounds`): for each tile
//      boundary t*mt among its parents, the survivors before it and the
//      solutions before it (a boundary may fall anywhere in a block), and
//      from the last block row G, the cycle's tree_inc and sol_inc, which
//      it adds to st[3]. `ops/tiled.py` derives the (G, 4) scalars from the
//      boundary row when they are read (no search reads them).
// The incumbent st[1] passes through. When the condition is false both
// launches return at once, so K cycles go to the stream with no host
// synchronisation.
//
// What bounds it on an H100: as kernel 4, the bytes of the popped rows and
// the survivor rows (N + 1 bytes a row) and the label compares, about
// 1.2 us at M = 50,000 and N = 15; each launch's fixed cost and each
// block's chain of dependent loads and barriers take the rest. The earlier
// form (one block a tile, a byte-a-slot keep plane read back one byte at a
// time, byte-wise pops and child rows, and a decoupled look-back in one
// thread a block over G = 625 tiles, serial across tiles) took about 3x
// kernel 4's time on an H100 80GB HBM3 at 700 W; this form has no ticket,
// no status words and no look-back: N-Queens has no
// incumbent, so every block's counts are final when launch 1 ends, and
// the predecessor sum reads one pair a block, not a tile, whatever mt is.
#include "cycle_nqueens.cuh"

template <int W, typename A>
__global__ void nq_tiles_labels(const uint8_t* __restrict__ pool_vals,
                                const A* __restrict__ pool_aux, int* st,
                                uint8_t* __restrict__ stash,
                                A* __restrict__ chunk_aux,
                                uint32_t* __restrict__ mask,
                                int* __restrict__ blkcnt, int N, int g, int M,
                                int C, int mterm, int K) {
  nq_labels_body<true, W, A>(pool_vals, pool_aux, st, stash, chunk_aux, mask,
                              blkcnt, N, g, M, C, mterm, K);
}

template <int W, typename A>
__global__ void nq_tiles_emit(uint8_t* __restrict__ pool_vals,
                              A* __restrict__ pool_aux, int* st,
                              const uint8_t* __restrict__ stash,
                              const A* __restrict__ chunk_aux,
                              const uint32_t* __restrict__ mask,
                              const int* __restrict__ blkcnt, int N, int M,
                              int* __restrict__ bnd, int mt, TtsCond cond) {
  nq_emit_body<true, W, A>(pool_vals, pool_aux, st, stash, chunk_aux, mask,
                             blkcnt, N, M, bnd, mt, cond);
}

// The entries: `tiled_nqueens` takes an int8 depth (N <= 127),
// `tiled_nqueens_i32` an int32 one (N > 127).
#define TTS_NQ_TILED_LAUNCH(W, A)                                         \
  launch_nq_cycle<W, A>(nq_tiles_labels<W, A>, nq_tiles_emit<W, A>, pool_vals,    \
                        pool_aux, st, stash, chunk_aux, mask, blkcnt, bnd, \
                        N, g, M, mt, C, mterm, K, cond, in_graph, clk,    \
                        stream)
#define TTS_NQ_TILED_ENTRY(NAME, AUX32)                                    \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,          \
                      void* stash, void* chunk_aux, void* mask,           \
                      void* blkcnt, void* bnd, int N, int g, int M, int mt, \
                      int C, int mterm, int K, unsigned long long cond,   \
                      int in_graph, void* clk, void* stream) {            \
    TTS_NQ_DISPATCH(N, AUX32, TTS_NQ_TILED_LAUNCH);                        \
  }

TTS_NQ_TILED_ENTRY(tiled_nqueens, false)
TTS_NQ_TILED_ENTRY(tiled_nqueens_i32, true)
