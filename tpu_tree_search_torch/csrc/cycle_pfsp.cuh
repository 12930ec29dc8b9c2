// Shared code of the fused PFSP cycles (cycle_lb1.cu, cycle_lb2.cu), which
// differ only in the bound that launch 1 writes into the (M*n) plane.
//
// Launch 1 of both starts with `pfsp_cycle_pop` (the loop condition and the
// pop) and ends with `pfsp_fold_leaves` (the incumbent folded over the
// chunk's leaves); launches 2-4 (count, scan, emit) read only the plane and
// are `launch_pfsp_cycle_tail`. cycle_lb1.cu's header note gives the launch
// sequence and the state layout.
#pragma once

#include "cycle_common.cuh"
#include "lb1_common.cuh"

// Launch 1's head: evaluate the loop condition of `resident.py:421-423`
// (size >= m, size + M*n <= C, cycles < K) from st. When it is false, block
// 0 clears st[5] and the function returns false: the whole cycle is then a
// no-op. Otherwise pop the back cnt = min(size, M) rows (start2 =
// clip(size - cnt, 0, C - M), the valid window of `resident.py:228-236`):
// block 0 records cnt and start2, and each block stashes its M-window rows
// (the emit of launch 4 writes survivors over the popped region, so it reads
// parents from the stash). Rows start2 + i in [start, size) are the popped
// parents.
template <typename T>
__device__ __forceinline__ bool pfsp_cycle_pop(
    const T* __restrict__ pool_vals, const T* __restrict__ pool_aux, int* st,
    T* __restrict__ chunk_vals, T* __restrict__ chunk_aux, int n, int M,
    int C, int mterm, int K, int* start, int* size, int* start2) {
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
  }
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const T* src = pool_vals + static_cast<size_t>(*start2 + i0) * n;
  T* dst = chunk_vals + static_cast<size_t>(i0) * n;
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) dst[e] = src[e];
  for (int e = threadIdx.x; e < rows; e += blockDim.x)
    chunk_aux[i0 + e] = pool_aux[*start2 + i0 + e];
  return true;
}

// Launch 1's tail: fold this thread's leaf minimum into the block's (a
// shared int set to INF before a barrier) and the block's into st[1] with
// atomicMin, so the keep test of launch 2 sees the final incumbent.
__device__ __forceinline__ void pfsp_fold_leaves(int leafmin, int* s_leafmin,
                                                 int* st) {
  if (leafmin < TTS_INF_BOUND) atomicMin(s_leafmin, leafmin);
  __syncthreads();
  if (threadIdx.x == 0 && *s_leafmin < TTS_INF_BOUND)
    atomicMin(&st[ST_BEST], *s_leafmin);
}

// keep / leaf flags of slot (p, k) of the popped chunk.
template <typename T>
__device__ __forceinline__ void slot_flags(const T* chunk_aux, const int* lb,
                                           int i, int k, int n, int best,
                                           bool* keep, bool* leaf) {
  const int l1 = static_cast<int>(chunk_aux[i]);
  const bool open = k >= l1 + 1;
  *leaf = open && (l1 + 2 == n);
  *keep = open && !*leaf && lb[static_cast<size_t>(i) * n + k] < best;
}

// Launch 2: per-block survivor and leaf counts.
template <typename T>
__global__ void cycle_count(const int* st, const T* __restrict__ chunk_aux,
                            const int* __restrict__ lb,
                            int* __restrict__ blkcnt, int n, int M) {
  if (!st[ST_ACTIVE]) return;
  const int best = st[ST_BEST];
  const int size = st[ST_SIZE];
  const int cnt = st[ST_CNT];
  const int start2 = st[ST_START2];
  const int start = size - cnt;
  __shared__ int s_keep, s_leaf;
  if (threadIdx.x == 0) {
    s_keep = 0;
    s_leaf = 0;
  }
  __syncthreads();
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  int keeps = 0, leaves = 0;
  for (int slot = threadIdx.x; slot < rows * n; slot += blockDim.x) {
    const int p = slot / n;
    const int i = i0 + p;
    const int row = start2 + i;
    if (row < start || row >= size) continue;
    bool keep, leaf;
    slot_flags(chunk_aux, lb, i, slot - p * n, n, best, &keep, &leaf);
    keeps += keep;
    leaves += leaf;
  }
  if (keeps) atomicAdd(&s_keep, keeps);
  if (leaves) atomicAdd(&s_leaf, leaves);
  __syncthreads();
  if (threadIdx.x == 0) {
    blkcnt[2 * blockIdx.x] = s_keep;
    blkcnt[2 * blockIdx.x + 1] = s_leaf;
  }
}

// Launch 3 (one block) is `cycle_scan` of cycle_common.cuh: block offsets
// and the cycle's scalar update.

// Launch 4: rank the block's survivors and write the child rows.
template <typename T>
__global__ void cycle_emit(T* __restrict__ pool_vals,
                           T* __restrict__ pool_aux, const int* st,
                           const T* __restrict__ chunk_vals,
                           const T* __restrict__ chunk_aux,
                           const int* __restrict__ lb,
                           const int* __restrict__ blkoff, int n, int M) {
  if (!st[ST_ACTIVE]) return;
  __shared__ int s_warp[32];
  const int best = st[ST_BEST];
  const int cnt = st[ST_CNT];
  const int start2 = st[ST_START2];
  const int base = st[ST_BASE];  // == the pre-pop size minus cnt
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int slots = min(PB, M - i0) * n;
  // Each thread owns a contiguous run of slots, so the block scan of the
  // per-thread counts keeps (parent, slot) order.
  const int per = (slots + blockDim.x - 1) / blockDim.x;
  const int lo = min(slots, static_cast<int>(threadIdx.x) * per);
  const int hi = min(slots, lo + per);
  int keeps = 0;
  for (int slot = lo; slot < hi; ++slot) {
    const int p = slot / n;
    const int row = start2 + i0 + p;
    if (row < base || row >= base + cnt) continue;
    bool keep, leaf;
    slot_flags(chunk_aux, lb, i0 + p, slot - p * n, n, best, &keep, &leaf);
    keeps += keep;
  }
  int total;
  int dst = base + blkoff[blockIdx.x] +
            block_exclusive_scan(keeps, s_warp, &total);
  for (int slot = lo; slot < hi && keeps > 0; ++slot) {
    const int p = slot / n;
    const int k = slot - p * n;
    const int i = i0 + p;
    const int row = start2 + i;
    if (row < base || row >= base + cnt) continue;
    bool keep, leaf;
    slot_flags(chunk_aux, lb, i, k, n, best, &keep, &leaf);
    if (!keep) continue;
    const int d = static_cast<int>(chunk_aux[i]) + 1;
    const T* parent = chunk_vals + static_cast<size_t>(i) * n;
    T* child = pool_vals + static_cast<size_t>(dst) * n;
    for (int j = 0; j < n; ++j) {
      child[j] = j == d ? parent[k] : (j == k ? parent[d] : parent[j]);
    }
    pool_aux[dst] = static_cast<T>(d);
    ++dst;
    --keeps;
  }
}

// Launches 2-4 on the stream, after a launch 1 that filled the plane `lb`.
template <typename T>
static int launch_pfsp_cycle_tail(void* pool_vals, void* pool_aux, int* st,
                                  const void* chunk_vals,
                                  const void* chunk_aux, const int* lb,
                                  void* blkcnt, void* blkoff, int n, int M,
                                  cudaStream_t s) {
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int nblk = (M + PB - 1) / PB;
  const int threads = tts_threads_for(PB * n);
  cycle_count<T><<<nblk, threads, 0, s>>>(
      st, static_cast<const T*>(chunk_aux), lb, static_cast<int*>(blkcnt), n,
      M);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  cycle_scan<<<1, 1024, 0, s>>>(st, static_cast<const int*>(blkcnt),
                                static_cast<int*>(blkoff), nblk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  cycle_emit<T><<<nblk, threads, 0, s>>>(
      static_cast<T*>(pool_vals), static_cast<T*>(pool_aux), st,
      static_cast<const T*>(chunk_vals), static_cast<const T*>(chunk_aux), lb,
      static_cast<const int*>(blkoff), n, M);
  return static_cast<int>(cudaGetLastError());
}
