// The fused lb1 cycle's launch 1 (bounds) and the host launcher of one
// cycle, shared by kernel 2 (cycle_lb1.cu, the single-tile cycle) and
// kernel 9b (tiled_lb1.cu, the streamed cycle), which differ only in the
// names of their kernels and, for 9b, in the count and emit launches'
// TILES flag (cycle_pfsp.cuh: a (survivors, leaves) pair a block and the
// tile boundaries' row). cycle_lb1.cu's header note gives the design.
#pragma once

#include "cycle_pfsp.cuh"

// Threads of a bounds block (32 parents) that loops over its slots, when
// one thread a slot does not fit on the card at once.
#define TTS_LB1_LOOP_THREADS 128

// Launch 1: loop condition, pop, bounds, leaf fold.
template <typename T>
__device__ __forceinline__ void lb1_cycle_bounds_body(
    const T* __restrict__ pool_vals, const T* __restrict__ pool_aux, int* st,
    uint8_t* __restrict__ stash, T* __restrict__ chunk_aux,
    int* __restrict__ lb, const int* __restrict__ ptm_t,
    const int* __restrict__ heads, const int* __restrict__ tails, int n,
    int m, int M, int C, int mterm, int K, bool lane_prologue) {
  int start, size, start2;
  if (!pfsp_cycle_begin(st, n, M, C, mterm, K, &start, &size, &start2))
    return;

  const int PB = TTS_CYCLE_PARENTS;
  const int SB = pfsp_stash_block_bytes<T>(n);
  // A parent's front and remain at an odd stride: 32 parents on 32 banks.
  const int ms = m | 1;
  extern __shared__ __align__(16) uint8_t s_b[];
  __shared__ int s_l1[TTS_CYCLE_PARENTS];
  __shared__ int s_leafmin;
  uint8_t* s_rows = s_b;
  Lb1Smem s;
  s.ptm = reinterpret_cast<int*>(s_b + SB);
  s.heads = s.ptm + n * m;
  s.tails = s.heads + m;
  s.front = s.tails + m;
  s.remain = s.front + PB * ms;
  int* s_colsum = s.remain + PB * ms;
  lb1_load_tables(s, ptm_t, heads, tails, n, m);

  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const int t = threadIdx.x;
  const T* src = pool_vals + static_cast<size_t>(start2 + i0) * n;
  copy_keep_phase(reinterpret_cast<const uint8_t*>(src),
                  rows * n * static_cast<int>(sizeof(T)),
                  stash + static_cast<size_t>(blockIdx.x) * SB, s_rows);
  const T* s_par = reinterpret_cast<const T*>(
      s_rows + (reinterpret_cast<uintptr_t>(src) & 15));
  if (t < rows) {
    const int row = start2 + i0 + t;
    const T l1 = pool_aux[row];
    chunk_aux[i0 + t] = l1;
    // -2 marks a row of the M-window outside the popped rows.
    s_l1[t] = (row >= start && row < size) ? static_cast<int>(l1) : -2;
  }
  if (t == 0) s_leafmin = TTS_INF_BOUND;
  for (int j = t; j < m; j += blockDim.x) {  // machine j's work, all jobs
    int c = 0;
    for (int i = 0; i < n; ++i) c += ptm_t[i * m + j];
    s_colsum[j] = c;
  }
  __syncthreads();  // the tables, rows and limit1 are in shared memory

  // The parents' fronts and remaining work: one thread a parent when the
  // grid is more than the card holds at once (the fewest instructions), a
  // wavefront of one lane a machine when it is not (the shortest chain).
  if (lane_prologue || m > 32) {
    for (int p = t; p < rows; p += blockDim.x) {
      if (s_l1[p] != -2)
        lb1_parent_state_colsum(s_par + p * n, s_l1[p], m, s, s_colsum,
                                s.front + p * ms, s.remain + p * ms);
    }
  } else {
    int G = 1;
    while (G < m) G <<= 1;
    const int groups = static_cast<int>(blockDim.x) / G;
    const unsigned gmask =
        G == 32 ? 0xffffffffu
                : ((1u << G) - 1u) << ((t & 31) & ~(G - 1));
    for (int p = t / G; p < rows; p += groups) {
      const int l1 = s_l1[p];
      if (l1 != -2)
        lb1_parent_state_lanes(s_par + p * n, l1, m, s, s_colsum,
                               s.front + p * ms, s.remain + p * ms, G, gmask);
    }
  }
  __syncthreads();

  int leafmin = TTS_INF_BOUND;
  int* plane = lb + static_cast<size_t>(i0) * n;
  int p = t / n, k = t - (t / n) * n;
  const int dp = static_cast<int>(blockDim.x) / n;
  const int dk = static_cast<int>(blockDim.x) - dp * n;
  for (int slot = t; slot < rows * n; slot += blockDim.x) {
    const int l1 = s_l1[p];
    int v = TTS_INF_BOUND;
    if (l1 != -2) {
      v = lb1_child(s_par + p * n, k, m, s, s.front + p * ms,
                    s.remain + p * ms);
      if (k >= l1 + 1 && l1 + 2 == n) leafmin = min(leafmin, v);
    }
    plane[slot] = v;
    p += dp;
    k += dk;
    if (k >= n) {
      k -= n;
      ++p;
    }
  }
  pfsp_fold_leaves(leafmin, &s_leafmin, st);
}

#define TTS_LB1_BOUNDS_PARAMS                                                \
  const T *__restrict__ pool_vals, const T *__restrict__ pool_aux, int *st, \
      uint8_t *__restrict__ stash, T *__restrict__ chunk_aux,               \
      int *__restrict__ lb, const int *__restrict__ ptm_t,                  \
      const int *__restrict__ heads, const int *__restrict__ tails, int n,  \
      int m, int M, int C, int mterm, int K, bool lane_prologue
#define TTS_LB1_BOUNDS_ARGS                                                  \
  pool_vals, pool_aux, st, stash, chunk_aux, lb, ptm_t, heads, tails, n, m, \
      M, C, mterm, K, lane_prologue

// Kernel 2's bounds launch.
template <typename T>
__global__ void cycle_bounds(TTS_LB1_BOUNDS_PARAMS) {
  lb1_cycle_bounds_body<T>(TTS_LB1_BOUNDS_ARGS);
}

// Kernel 9b's bounds launch: the same body under its own name.
template <typename T>
__global__ void lb1_tiles_bounds(TTS_LB1_BOUNDS_PARAMS) {
  lb1_cycle_bounds_body<T>(TTS_LB1_BOUNDS_ARGS);
}

// One cycle on the stream: launch 1, then the count and emit launches of
// cycle_pfsp.cuh. TILES: kernel 9b's kernels, with the boundary row bnd of
// tiles of mt parents. With a phase clock `clk`, a mark opens the cycle
// (`loop`) and one after launch 1 charges `eval` (the pop is inside it).
// With `in_graph`, the cycle is the whole body of the while node whose
// condition is `cond` (cycle_common.cuh TtsCond).
template <typename T, bool TILES>
static int launch_lb1_cycle(void* pool_vals, void* pool_aux, void* st,
                            void* chunk_vals, void* chunk_aux, void* lb,
                            void* blkcnt, void* bnd, const void* ptm_t,
                            const void* heads, const void* tails, int n,
                            int m, int M, int mt, int C, int mterm, int K,
                            unsigned long long cond, int in_graph, void* clk,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TtsCond tc = {cond, in_graph, mterm, C, K};
  auto bounds = [] {
    if constexpr (TILES) return lb1_tiles_bounds<T>;
    else return cycle_bounds<T>;
  }();
  const int PB = TTS_CYCLE_PARENTS;
  const int nblk = (M + PB - 1) / PB;
  const int threads = tts_cycle_threads(nblk, PB * n, TTS_LB1_LOOP_THREADS);
  // The stash region, then ptm (n*m), heads and tails (m), front and
  // remain (PB at an odd stride m | 1), and the column sums (m).
  const size_t smem = pfsp_stash_block_bytes<T>(n) +
                      sizeof(int) * (static_cast<size_t>(n) * m + 2 * m +
                                     2 * PB * (m | 1) + m);
  int err = tts_smem_optin(bounds, smem);
  if (err) return err;
  err = tts_phase_mark(clk, PH_LOOP, PH_OPEN, s);
  if (err) return err;
  int* st_i = static_cast<int*>(st);
  bounds<<<nblk, threads, smem, s>>>(
      static_cast<const T*>(pool_vals), static_cast<const T*>(pool_aux), st_i,
      static_cast<uint8_t*>(chunk_vals), static_cast<T*>(chunk_aux),
      static_cast<int*>(lb), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int*>(tails), n, m, M,
      C, mterm, K, threads < tts_threads_for(PB * n));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = tts_phase_mark(clk, PH_EVAL, 0, s);
  if (err) return err;
  return launch_pfsp_cycle_tail<T, TILES>(
      pool_vals, pool_aux, st_i, chunk_vals, chunk_aux, static_cast<int*>(lb),
      blkcnt, n, M, s, static_cast<int*>(bnd), mt, clk, tc);
}
