// Shared device code of the fused search cycles (cycle_lb1.cu,
// cycle_nqueens.cu): the layout of the loop state tensor, the block scan
// and the one-block launch that turns per-block counts into survivor
// offsets and updates the state.
#pragma once

#include "tts_common.cuh"

// The loop state: one small int32 device tensor `st` (mirrored by
// ST_* in tpu_tree_search_torch/ops/cycle.py).
enum {
  ST_SIZE = 0,
  ST_BEST = 1,
  ST_TREE = 2,
  ST_SOL = 3,
  ST_CYCLES = 4,
  ST_ACTIVE = 5,
  ST_CNT = 6,
  ST_START2 = 7,
  ST_BASE = 8,
};

// Exclusive scan of one int per thread over the block (blockDim.x a
// multiple of 32, at most 1024). Returns the thread's exclusive prefix and
// the block total in *total. s_warp holds 32 ints of shared memory.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int excl = (warp ? s_warp[warp - 1] : 0) + x - v;
  *total = s_warp[nwarps - 1];
  __syncthreads();
  return excl;
}

// The scan launch (one block of 1024 threads): blkcnt holds per block
// (survivors, solutions); writes each block's survivor offset, then
// size = size - cnt + tree_inc, tree += tree_inc, sol += sol_inc,
// cycles += 1, and the emit base (the pre-pop size minus cnt).
__global__ void cycle_scan(int* st, const int* __restrict__ blkcnt,
                           int* __restrict__ blkoff, int nblk) {
  if (!st[ST_ACTIVE]) return;
  __shared__ int s_warp[32];
  const int per = (nblk + blockDim.x - 1) / blockDim.x;
  const int lo = min(nblk, static_cast<int>(threadIdx.x) * per);
  const int hi = min(nblk, lo + per);
  int keeps = 0, sols = 0;
  for (int j = lo; j < hi; ++j) {
    keeps += blkcnt[2 * j];
    sols += blkcnt[2 * j + 1];
  }
  int tree_inc, sol_inc;
  int run = block_exclusive_scan(keeps, s_warp, &tree_inc);
  block_exclusive_scan(sols, s_warp, &sol_inc);
  for (int j = lo; j < hi; ++j) {
    blkoff[j] = run;
    run += blkcnt[2 * j];
  }
  if (threadIdx.x == 0) {
    const int base = st[ST_SIZE] - st[ST_CNT];
    st[ST_BASE] = base;
    st[ST_SIZE] = base + tree_inc;
    st[ST_TREE] += tree_inc;
    st[ST_SOL] += sol_inc;
    st[ST_CYCLES] += 1;
  }
}
