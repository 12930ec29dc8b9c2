// The fused lb2 cycle's launch 1 (bounds) and the host launcher of one
// cycle, shared by kernel 8 (cycle_lb2.cu, the single-tile cycle) and
// kernel 9c (tiled_lb2.cu, the streamed cycle), which differ only in the
// names of their kernels and, for 9c, in the count and emit launches'
// TILES flag (cycle_pfsp.cuh: a (leaves, survivors) pair a block and the
// tile boundaries' row). cycle_lb2.cu's header note gives the design.
#pragma once

#include "cycle_pfsp.cuh"
#include "lb2_common.cuh"

// Launch 1: loop condition, pop, lb2 bounds, leaf fold (GT: the GLOBAL
// table route of lb2_common.cuh).
template <typename T, bool GT, bool WIDE>
__device__ __forceinline__ void lb2_cycle_bounds_body(
    const T* __restrict__ pool_vals, const T* __restrict__ pool_aux, int* st,
    uint8_t* __restrict__ stash, T* __restrict__ chunk_aux,
    int* __restrict__ lb, const int* __restrict__ ptm_t,
    const int* __restrict__ heads, const int4* __restrict__ pairinfo,
    const typename Lb2Types<GT>::Tab* __restrict__ tab,
    const typename Lb2Types<GT>::Job* __restrict__ inv, int n, int m, int P,
    int M, int C, int mterm, int K, int PB) {
  int start, size, start2;
  if (!pfsp_cycle_begin(st, n, M, C, mterm, K, &start, &size, &start2))
    return;

  extern __shared__ __align__(16) unsigned char lb2_smem[];
  __shared__ int s_leafmin;
  const Lb2ParSmem<GT> s =
      lb2p_smem_layout<GT>(lb2_smem, n, m, P, PB, ptm_t, heads, pairinfo, tab, inv);
  lb2p_load_tables<GT>(s, ptm_t, heads, pairinfo,
                       reinterpret_cast<const short4*>(tab), n, m, P);
  if (threadIdx.x == 0) s_leafmin = TTS_INF_BOUND;

  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  pfsp_stash_pop(pool_vals, pool_aux, stash, chunk_aux, start2, i0, rows, n);
  // Rows start2 + i0 + p in [start, size) are the popped parents.
  const int first = start2 + i0;
  lb2p_load_rows<GT>(s, pool_vals + static_cast<size_t>(first) * n,
                     pool_aux + first, rows, start - first, size - first, n);
  __syncthreads();  // the tables and rows are in shared memory

  int leafmin = TTS_INF_BOUND;
  int* plane = lb + static_cast<size_t>(i0) * n;
  lb2p_bounds<GT, WIDE>(s, rows, n, m, P, [&](int p, int k, int v) {
    plane[p * n + k] = v;
    if (s.l1[p] + 2 == n) leafmin = min(leafmin, v);
  });
  pfsp_fold_leaves(leafmin, &s_leafmin, st);
}

#define TTS_LB2_BOUNDS_PARAMS                                                \
  const T *__restrict__ pool_vals, const T *__restrict__ pool_aux, int *st, \
      uint8_t *__restrict__ stash, T *__restrict__ chunk_aux,               \
      int *__restrict__ lb, const int *__restrict__ ptm_t,                  \
      const int *__restrict__ heads, const int4 *__restrict__ pairinfo,     \
      const typename Lb2Types<GT>::Tab *__restrict__ tab,                   \
      const typename Lb2Types<GT>::Job *__restrict__ inv, int n, int m,     \
      int P, int M, int C, int mterm, int K, int PB
#define TTS_LB2_BOUNDS_ARGS                                                   \
  pool_vals, pool_aux, st, stash, chunk_aux, lb, ptm_t, heads, pairinfo, tab, \
      inv, n, m, P, M, C, mterm, K, PB

// Kernel 8's bounds launch.
template <typename T, bool GT, bool WIDE>
__global__ void lb2_cycle_bounds(TTS_LB2_BOUNDS_PARAMS) {
  lb2_cycle_bounds_body<T, GT, WIDE>(TTS_LB2_BOUNDS_ARGS);
}

// Kernel 9c's bounds launch: the same body under its own name.
template <typename T, bool GT, bool WIDE>
__global__ void lb2_tiles_bounds(TTS_LB2_BOUNDS_PARAMS) {
  lb2_cycle_bounds_body<T, GT, WIDE>(TTS_LB2_BOUNDS_ARGS);
}

// One cycle on the stream: launch 1 in the block shape `tts_lb2p_shape`
// picks (kept in *last), then the count and emit launches. TILES: kernel
// 9c's kernels, with the boundary row bnd of tiles of mt parents. GT: the
// GLOBAL table route (tab the int32 table, inv its inverse). WIDE: past 128
// jobs (lb2_common.cuh `lb2p_pairs`). With a phase clock `clk`, the marks
// of kernel 2's cycle (cycle_lb1.cuh); `cond` and `in_graph` as kernel 2's.
template <typename T, bool TILES, bool GT, bool WIDE>
static int launch_lb2_cycle_route(void* pool_vals, void* pool_aux, void* st,
                                  void* chunk_vals, void* chunk_aux, void* lb,
                                  void* blkcnt, void* bnd, const void* ptm_t,
                                  const void* heads, const void* pairinfo,
                                  const void* tab, const void* inv, int n,
                                  int m, int P, int M, int mt, int C,
                                  int mterm, int K, unsigned long long cond,
                                  int in_graph, void* clk, void* stream,
                                  Lb2Shape* last) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TtsCond tc = {cond, in_graph, mterm, C, K};
  auto bounds = [] {
    if constexpr (TILES) return lb2_tiles_bounds<T, GT, WIDE>;
    else return lb2_cycle_bounds<T, GT, WIDE>;
  }();
  Lb2Shape sh;
  int err = tts_lb2p_shape<GT>(bounds, M, n, m, P, &sh);
  if (err) return err;
  *last = sh;
  const int nblk = (M + sh.parents - 1) / sh.parents;
  err = tts_phase_mark(clk, PH_LOOP, PH_OPEN, s);
  if (err) return err;
  int* st_i = static_cast<int*>(st);
  bounds<<<nblk, sh.threads, sh.smem, s>>>(
      static_cast<const T*>(pool_vals), static_cast<const T*>(pool_aux), st_i,
      static_cast<uint8_t*>(chunk_vals), static_cast<T*>(chunk_aux),
      static_cast<int*>(lb), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int4*>(pairinfo),
      static_cast<const typename Lb2Types<GT>::Tab*>(tab),
      static_cast<const typename Lb2Types<GT>::Job*>(inv), n, m, P, M, C,
      mterm, K, sh.parents);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = tts_phase_mark(clk, PH_EVAL, 0, s);
  if (err) return err;
  return launch_pfsp_cycle_tail<T, TILES>(
      pool_vals, pool_aux, st_i, chunk_vals, chunk_aux, static_cast<int*>(lb),
      blkcnt, n, M, s, static_cast<int*>(bnd), mt, clk, tc);
}

// The cycle on the table route `route` (0 SMEM, 1 GLOBAL).
template <typename T, bool TILES>
static int launch_lb2_cycle(void* pool_vals, void* pool_aux, void* st,
                            void* chunk_vals, void* chunk_aux, void* lb,
                            void* blkcnt, void* bnd, const void* ptm_t,
                            const void* heads, const void* pairinfo,
                            const void* tab, const void* inv, int n, int m,
                            int P, int route, int M, int mt, int C, int mterm,
                            int K, unsigned long long cond, int in_graph,
                            void* clk, void* stream, Lb2Shape* last) {
#define TTS_LB2_CYCLE_ROUTE(GT, WIDE)                                       \
  launch_lb2_cycle_route<T, TILES, GT, WIDE>(                               \
      pool_vals, pool_aux, st, chunk_vals, chunk_aux, lb, blkcnt, bnd,      \
      ptm_t, heads, pairinfo, tab, inv, n, m, P, M, mt, C, mterm, K, cond,  \
      in_graph, clk, stream, last)
  const bool wide = tts_lb2p_wide(n);
  if (route == 1)
    return wide ? TTS_LB2_CYCLE_ROUTE(true, true)
                : TTS_LB2_CYCLE_ROUTE(true, false);
  return wide ? TTS_LB2_CYCLE_ROUTE(false, true)
              : TTS_LB2_CYCLE_ROUTE(false, false);
#undef TTS_LB2_CYCLE_ROUTE
}
