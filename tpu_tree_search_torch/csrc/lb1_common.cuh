// Shared device code of the lb1 kernels (lb1_bounds.cu, lb1_d_bounds.cu,
// cycle_lb1.cuh); the lb2 kernels share its front scan and parent state.
//
// The per-parent prologue and the per-child chain of the PFSP one-machine
// bound lb1 (`c_bound_simple.c:51-158`, forward branching, so the tail
// schedule is the constant `min_tails` table), in the incremental form of
// the JAX package's `_lb1_tile_lb` (tpu_tree_search/ops/pallas_kernels.py):
// the parent front is scanned once, then every child slot takes one
// add_forward step and the m-long machine chain. Integer gathers from a
// shared-memory copy of the (n, m) job-major time table replace the TPU
// kernel's one-hot MXU product.
#pragma once

#include "tts_common.cuh"

struct Lb1Smem {
  int* ptm;
  int* heads;
  int* tails;
  int* front;
  int* remain;
};

__device__ __forceinline__ void lb1_load_tables(const Lb1Smem& s,
                                                const int* ptm_t,
                                                const int* heads,
                                                const int* tails, int n,
                                                int m) {
  for (int i = threadIdx.x; i < n * m; i += blockDim.x) s.ptm[i] = ptm_t[i];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s.heads[i] = heads[i];
    s.tails[i] = tails[i];
  }
}

// schedule_front(row, l1) (min_heads at l1 == -1): the completion time of
// the prefix 0..l1 on machine j goes to front[j * stride] (the serial
// add_forward scan, `c_bound_simple.c:51-69`). ptm is the (n, m) table.
template <typename T>
__device__ __forceinline__ void pfsp_front(const T* row, int l1, int n, int m,
                                           const int* ptm, const int* heads,
                                           int* front, int stride) {
  for (int j = 0; j < m; ++j) front[j * stride] = (l1 == -1) ? heads[j] : 0;
  for (int i = 0; i <= l1 && i < n; ++i) {
    const int* p = ptm + static_cast<int>(row[i]) * m;
    int f = front[0] + p[0];
    front[0] = f;
    for (int j = 1; j < m; ++j) {
      f = max(f, front[j * stride]) + p[j];
      front[j * stride] = f;
    }
  }
}

// front = schedule_front(row, l1) (min_heads at l1 == -1), remain =
// sum_unscheduled(row, l1): the per-machine work of positions l1+1..n-1.
template <typename T>
__device__ __forceinline__ void lb1_parent_state(const T* row, int l1, int n,
                                                 int m, const Lb1Smem& s,
                                                 int* front, int* remain) {
  pfsp_front(row, l1, n, m, s.ptm, s.heads, front, 1);
  for (int j = 0; j < m; ++j) remain[j] = 0;
  for (int i = l1 + 1; i < n; ++i) {
    const int* p = s.ptm + static_cast<int>(row[i]) * m;
    for (int j = 0; j < m; ++j) remain[j] += p[j];
  }
}

// The parent state of lb1_parent_state computed by a group of G lanes of
// one warp (G a power of two, m <= G <= 32; lane j of the group is machine
// j; gmask names the group's lanes): the front as a wavefront over the
// machines, lane j taking position i = step - j with its left neighbour's
// completion time from the step before (a shuffle), l1 + m steps in place
// of (l1 + 1) * m dependent ones. The row is a permutation of the n jobs,
// so the work left on machine j is colsum[j] (the machine's total over
// every job) less what the wavefront scheduled. Every lane of the group
// calls it.
template <typename T>
__device__ __forceinline__ void lb1_parent_state_lanes(
    const T* row, int l1, int m, const Lb1Smem& s, const int* colsum,
    int* front, int* remain, int G, unsigned gmask) {
  const int j = static_cast<int>(threadIdx.x) & (G - 1);
  const bool mine = j < m;
  int f = (l1 == -1 && mine) ? s.heads[j] : 0;
  int done = 0;
  for (int step = 0; step < l1 + m; ++step) {
    const int left = __shfl_up_sync(gmask, f, 1, G);
    const int i = step - j;
    if (mine && i >= 0 && i <= l1) {
      const int p = s.ptm[static_cast<int>(row[i]) * m + j];
      f = (j == 0 ? f : max(f, left)) + p;
      done += p;
    }
  }
  if (mine) {
    front[j] = f;
    remain[j] = colsum[j] - done;
  }
}

// The parent state of lb1_parent_state computed by one thread, with the
// remaining work taken from colsum as in lb1_parent_state_lanes: (l1 + 1)
// * m dependent steps, no pass over the unscheduled positions.
template <typename T>
__device__ __forceinline__ void lb1_parent_state_colsum(
    const T* row, int l1, int m, const Lb1Smem& s, const int* colsum,
    int* front, int* remain) {
  for (int j = 0; j < m; ++j) {
    front[j] = (l1 == -1) ? s.heads[j] : 0;
    remain[j] = colsum[j];
  }
  for (int i = 0; i <= l1; ++i) {
    const int* p = s.ptm + static_cast<int>(row[i]) * m;
    int f = front[0] + p[0];
    front[0] = f;
    remain[0] -= p[0];
    for (int j = 1; j < m; ++j) {
      f = max(f, front[j]) + p[j];
      front[j] = f;
      remain[j] -= p[j];
    }
  }
}

// lb1 of child slot k: append the job at position k (one add_forward step
// from the parent front), take it out of the remaining work, and run the
// machine chain of `machine_bound_from_parts` against min_tails.
template <typename T>
__device__ __forceinline__ int lb1_child(const T* row, int k, int m,
                                         const Lb1Smem& s, const int* front,
                                         const int* remain) {
  const int* p = s.ptm + static_cast<int>(row[k]) * m;
  int cf = front[0] + p[0];
  int tmp0 = cf + (remain[0] - p[0]);
  int lb = tmp0 + s.tails[0];
  for (int i = 1; i < m; ++i) {
    cf = max(cf, front[i]) + p[i];
    const int tmp1 = max(tmp0, cf + (remain[i] - p[i]));
    lb = max(lb, tmp1 + s.tails[i]);
    tmp0 = tmp1;
  }
  return lb;
}
