// Code of the streamed (tiled) lb1 cycle, kernel 9b (tiled_lb1.cu, through
// tiled_pfsp.cuh): the pop of its sweep launch, and the cross-tile carry of
// its emit launch, which is the Hopper form of the TPU kernel's SMEM
// `carry_ref` (tpu_tree_search/ops/megakernel.py, `_mega_lb1_tiled_kernel`).
// Kernels 9a and 9c run the single-tile cycles' launches and need no carry
// across blocks (cycle_common.cuh `emit_tile_bounds`); once 9b does the
// same, this file goes.
//
// On the TPU the G pool tiles of Mt parents ran as a sequential grid, and a
// scalar carry in SMEM handed each tile the survivor offset and the
// cumulative solution count of the tiles before it. Hopper blocks run in no
// set order, so here the carry is a single-pass chained scan with
// decoupled look-back, inside the emit launch:
//   * a block takes its tile index from an atomic ticket, not from
//     blockIdx, so a block only ever waits on tiles that an earlier-started
//     (hence resident) block owns: no deadlock when the tiles outnumber the
//     blocks the card holds at once;
//   * it ranks its tile's survivors with a block scan and publishes the
//     tile's aggregate (survivors, solutions) in its status word;
//   * its first thread walks back over the lower tiles' status words,
//     adding aggregates until it meets an inclusive prefix, and publishes
//     its own inclusive prefix;
//   * the block writes its survivors straight into the pool at
//     base + offs[t] + rank (the stitch of `engine/resident.py:257-270`,
//     fused) and its row of the (G, 4) per-tile scalars (offs, cnt,
//     sol_cum, best: `_tile_scalar_lanes`); the last tile applies the
//     cycle's state update (size, tree, sol, cycles).
// A status word packs a flag (2 bits: 0 not ready, 1 aggregate, 2
// inclusive prefix), the survivor count (31 bits) and the solution count
// (31 bits) into one 64-bit word, so a reader sees the flag and the values
// together. The sweep launch before the emit resets every status word and
// the ticket on the same stream; a cycle past termination returns before
// either launch touches them.
#pragma once

#include "cycle_common.cuh"

#define TTS_TILE_AGG 1ull
#define TTS_TILE_INC 2ull

// The sweep's head: the loop condition of `resident.py:421-423` (size >= m,
// size + M*n <= C, cycles < K) from st; when it is false block 0 clears
// st[5] and the function returns false (the whole cycle is then a no-op).
// Otherwise pop the back cnt = min(size, M) rows (start2 = clip(size - cnt,
// 0, C - M)): block 0 records cnt, start2 and the emit base (size - cnt) and
// resets the ticket, each block resets its tile's status word and stashes
// its Mt rows of the M-window (the emit writes survivors over the popped
// region, so it reads parents from the stash). Rows start2 + i in
// [start, size) are the popped parents.
template <typename V, typename A>
__device__ __forceinline__ bool tile_cycle_pop(
    const V* __restrict__ pool_vals, const A* __restrict__ pool_aux, int* st,
    V* __restrict__ chunk_vals, A* __restrict__ chunk_aux,
    unsigned long long* __restrict__ status, int* __restrict__ ticket, int n,
    int M, int mt, int C, int mterm, int K, int* start, int* size,
    int* start2) {
  const int sz = st[ST_SIZE];
  const int cycles = st[ST_CYCLES];
  const bool active = sz >= mterm &&
                      static_cast<long long>(sz) +
                              static_cast<long long>(M) * n <=
                          C &&
                      cycles < K;
  if (!active) {
    if (blockIdx.x == 0 && threadIdx.x == 0) st[ST_ACTIVE] = 0;
    return false;
  }
  const int cnt = min(sz, M);
  *size = sz;
  *start = sz - cnt;
  *start2 = min(max(*start, 0), C - M);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st[ST_ACTIVE] = 1;
    st[ST_CNT] = cnt;
    st[ST_START2] = *start2;
    st[ST_BASE] = *start;
    *ticket = 0;
  }
  if (threadIdx.x == 0) status[blockIdx.x] = 0ull;
  const size_t i0 = static_cast<size_t>(blockIdx.x) * mt;
  const V* src = pool_vals + (static_cast<size_t>(*start2) + i0) * n;
  V* dst = chunk_vals + i0 * n;
  for (int e = threadIdx.x; e < mt * n; e += blockDim.x) dst[e] = src[e];
  for (int e = threadIdx.x; e < mt; e += blockDim.x)
    chunk_aux[i0 + e] = pool_aux[*start2 + i0 + e];
  return true;
}

// The emit's tile: thread 0 draws the next ticket; every thread returns it.
__device__ __forceinline__ int tile_ticket(int* ticket, int* s_tile) {
  if (threadIdx.x == 0) *s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  return *s_tile;
}

__device__ __forceinline__ unsigned long long tile_word(
    unsigned long long flag, int cnt, int sol) {
  return (flag << 62) | (static_cast<unsigned long long>(cnt) << 31) |
         static_cast<unsigned long long>(sol);
}

// Thread 0 of tile t's block: publish the tile's (cnt, sol), look back for
// the exclusive prefix over tiles 0..t-1, publish the inclusive prefix.
__device__ __forceinline__ void tile_lookback(unsigned long long* status,
                                              int t, int cnt, int sol,
                                              int* excl_cnt, int* excl_sol) {
  int ec = 0, es = 0;
  if (t > 0) {
    atomicExch(status + t, tile_word(TTS_TILE_AGG, cnt, sol));
    const volatile unsigned long long* vs = status;
    for (int j = t - 1; j >= 0;) {
      const unsigned long long w = vs[j];
      const unsigned long long flag = w >> 62;
      if (flag == 0) {  // tile j's block has not published yet
        __nanosleep(32);
        continue;
      }
      ec += static_cast<int>((w >> 31) & 0x7fffffffull);
      es += static_cast<int>(w & 0x7fffffffull);
      if (flag == TTS_TILE_INC) break;
      --j;
    }
  }
  atomicExch(status + t, tile_word(TTS_TILE_INC, ec + cnt, es + sol));
  *excl_cnt = ec;
  *excl_sol = es;
}

// Thread 0 of tile t's block, after the look-back: the tile's scalar row
// and, from the last tile, the cycle's state update. The emit's blocks read
// only st[1] and st[5..8], and this writes st[0] and st[2..4].
__device__ __forceinline__ void tile_finish(int* st, int* __restrict__ scal,
                                            int t, int G, int offs, int cnt,
                                            int sol_cum, int best) {
  scal[4 * t] = offs;
  scal[4 * t + 1] = cnt;
  scal[4 * t + 2] = sol_cum;
  scal[4 * t + 3] = best;
  if (t == G - 1) {
    const int tree = offs + cnt;
    st[ST_SIZE] = st[ST_BASE] + tree;
    st[ST_TREE] += tree;
    st[ST_SOL] += sol_cum;
    st[ST_CYCLES] += 1;
  }
}

// The carry of one tile: rank this thread's `keeps` within the block, run
// the look-back, write the tile's scalar row (and the state update), and
// return the pool row where this thread's first survivor goes.
__device__ __forceinline__ int tile_carry(int keeps, int sols, int t, int G,
                                          int base, int best, int* st,
                                          int* __restrict__ scal,
                                          unsigned long long* status,
                                          int* s_warp, int* s_off) {
  int cnt, sol;
  const int rank = block_exclusive_scan(keeps, s_warp, &cnt);
  block_exclusive_scan(sols, s_warp, &sol);
  if (threadIdx.x == 0) {
    int ec, es;
    tile_lookback(status, t, cnt, sol, &ec, &es);
    *s_off = ec;
    tile_finish(st, scal, t, G, ec, cnt, es + sol, best);
  }
  __syncthreads();
  return base + *s_off + rank;
}
