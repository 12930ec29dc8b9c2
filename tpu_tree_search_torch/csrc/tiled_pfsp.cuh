// The emit launch (launch 2) of kernel 9b, the streamed lb1 cycle
// (tiled_lb1.cu). Kernel 9c, the streamed lb2 cycle, runs kernel 8's
// launches instead (cycle_lb2.cuh).
#pragma once

#include "cycle_pfsp.cuh"
#include "tiled_common.cuh"

// Launch 2: one block per tile, in ticket order. The keep test against the
// final incumbent (every leaf was folded into st[1] by launch 1), the
// tile's survivor and leaf counts, the cross-tile carry of
// tiled_common.cuh, and the child rows written at base + offs[t] + rank.
template <typename T>
__global__ void tiled_pfsp_emit(T* __restrict__ pool_vals,
                                T* __restrict__ pool_aux, int* st,
                                const T* __restrict__ chunk_vals,
                                const T* __restrict__ chunk_aux,
                                const int* __restrict__ lb,
                                unsigned long long* status, int* ticket,
                                int* __restrict__ scal, int n, int mt,
                                int G) {
  if (!st[ST_ACTIVE]) return;
  __shared__ int s_warp[32];
  __shared__ int s_tile, s_off;
  const int t = tile_ticket(ticket, &s_tile);
  const int best = st[ST_BEST];
  const int cnt = st[ST_CNT];
  const int start2 = st[ST_START2];
  const int base = st[ST_BASE];  // the pre-pop size minus cnt
  const int i0 = t * mt;
  const int slots = mt * n;
  // Each thread owns a contiguous run of slots, so the block scan of the
  // per-thread counts keeps (parent, slot) order.
  const int per = (slots + blockDim.x - 1) / blockDim.x;
  const int lo = min(slots, static_cast<int>(threadIdx.x) * per);
  const int hi = min(slots, lo + per);
  int keeps = 0, leaves = 0;
  for (int slot = lo; slot < hi; ++slot) {
    const int p = slot / n;
    const int row = start2 + i0 + p;
    if (row < base || row >= base + cnt) continue;
    bool keep, leaf;
    slot_flags(chunk_aux, lb, i0 + p, slot - p * n, n, best, &keep, &leaf);
    keeps += keep;
    leaves += leaf;
  }
  int dst = tile_carry(keeps, leaves, t, G, base, best, st, scal, status,
                       s_warp, &s_off);
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

// Launch 2 on the stream, after a sweep that filled the stash `lb`.
template <typename T>
static int launch_tiled_pfsp_emit(void* pool_vals, void* pool_aux, int* st,
                                  const void* chunk_vals,
                                  const void* chunk_aux, const int* lb,
                                  void* status, void* ticket, void* scal,
                                  int n, int M, int mt, cudaStream_t s) {
  const int G = M / mt;
  tiled_pfsp_emit<T><<<G, tts_threads_for(mt * n), 0, s>>>(
      static_cast<T*>(pool_vals), static_cast<T*>(pool_aux), st,
      static_cast<const T*>(chunk_vals), static_cast<const T*>(chunk_aux), lb,
      static_cast<unsigned long long*>(status), static_cast<int*>(ticket),
      static_cast<int*>(scal), n, mt, G);
  return static_cast<int>(cudaGetLastError());
}
