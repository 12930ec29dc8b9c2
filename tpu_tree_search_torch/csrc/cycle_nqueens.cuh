// The bodies of the fused N-Queens cycle's two launches (labels, emit),
// shared by kernel 4 (cycle_nqueens.cu, the single-tile cycle) and kernel
// 9a (tiled_nqueens.cu, the streamed cycle), each of which defines its own
// `__global__` kernels around them, and the host launcher of one cycle.
// cycle_nqueens.cu's header note gives the launches and the design.
//
// The template flag TILES is the streamed cycle's: its labels launch
// publishes each block's solutions beside its survivors (in place of an
// atomicAdd to st[3]) and its emit writes the tile boundaries' row
// (cycle_common.cuh `emit_tile_bounds`). With TILES false the code is the
// single-tile cycle's, with no boundary row: the choice is made when the
// kernel is compiled, not in its loops. W is the keep-mask words a parent
// (TTS_NQ_WORDS(N): 1 through N = 32, the boards the W = 1 code was
// measured on, up to 8 at N = 256) and A the depth's type (int8_t through
// N = 127, int32_t beyond, the pool's).
#pragma once

#include "cycle_common.cuh"
#include "phase_clock.cuh"
#include "nqueens_common.cuh"

static_assert(TTS_NQ_PARENTS_PER_BLOCK == TTS_CYCLE_PARENTS,
              "the N-Queens cycle ranks a block's parents with one warp");

// Launch 1: loop condition, pop, labels, keep masks, per-block counts.
template <bool TILES, int W, typename A>
__device__ __forceinline__ void nq_labels_body(
    const uint8_t* __restrict__ pool_vals, const A* __restrict__ pool_aux,
    int* st, uint8_t* __restrict__ stash, A* __restrict__ chunk_aux,
    uint32_t* __restrict__ mask, int* __restrict__ blkcnt, int N, int g, int M,
    int C, int mterm, int K) {
  const int size = st[ST_SIZE];
  const bool active = tts_loop_active(size, st[ST_CYCLES], mterm,
                                      static_cast<long long>(M) * N, C, K);
  if (!active) {
    if (blockIdx.x == 0 && threadIdx.x == 0) st[ST_ACTIVE] = 0;
    return;
  }
  const int cnt = min(size, M);
  const int start = size - cnt;
  const int start2 = min(max(start, 0), C - M);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st[ST_ACTIVE] = 1;
    st[ST_CNT] = cnt;
    st[ST_START2] = start2;
    st[ST_BASE] = start;
  }

  __shared__ __align__(16) uint8_t s_rows[TTS_NQ_PARENTS_PER_BLOCK * 32 * W + 32];
  __shared__ uint32_t s_mask[TTS_NQ_PARENTS_PER_BLOCK * W];
  // Parent depth, or -1 for a row of the M-window outside the popped rows.
  __shared__ int s_depth[TTS_NQ_PARENTS_PER_BLOCK];
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const int t = threadIdx.x;
  // The pop: this block's M-window rows into its stash region (the emit
  // writes survivors over the popped region, so it reads parents from the
  // stash) and into shared memory.
  const uint8_t* src = pool_vals + static_cast<size_t>(start2 + i0) * N;
  copy_keep_phase(src, rows * N,
                  stash + static_cast<size_t>(blockIdx.x) *
                              tts_stash_block_bytes(PB * N),
                  s_rows);
  const uint8_t* s_board = s_rows + (reinterpret_cast<uintptr_t>(src) & 15);
  if (t < rows) {
    const int row = start2 + i0 + t;
    const A d = pool_aux[row];
    chunk_aux[i0 + t] = d;
    s_depth[t] = (row >= start && row < size) ? static_cast<int>(d) : -1;
  }
  // W = 1 (N <= 32) keeps the one-word code: its slot's bit is bit k.
  if constexpr (W == 1) {
    if (t < PB) s_mask[t] = 0;
  } else {
    for (int w = t; w < PB * W; w += blockDim.x) s_mask[w] = 0;
  }
  __syncthreads();

  // Every (parent, slot), the split of a thread's first slot and of the
  // stride into (parent, slot) taken once.
  {
    int p = t / N, k = t - (t / N) * N;
    const int dp = static_cast<int>(blockDim.x) / N;
    const int dk = static_cast<int>(blockDim.x) - dp * N;
    for (int s = t; s < rows * N; s += blockDim.x) {
      const int d = s_depth[p];
      if (d >= 0 && d < N && nq_label(s_board + p * N, d, k, g)) {
        if constexpr (W == 1)
          atomicOr(&s_mask[p], 1u << k);
        else
          atomicOr(&s_mask[p * W + (k >> 5)], 1u << (k & 31));
      }
      p += dp;
      k += dk;
      if (k >= N) {
        k -= N;
        ++p;
      }
    }
  }
  __syncthreads();
  if constexpr (W > 1) {
    for (int w = t; w < rows * W; w += blockDim.x)
      mask[static_cast<size_t>(i0) * W + w] = s_mask[w];
  }
  int keeps = 0, sols = 0;
  if (t < 32) {
    if (t < rows) {
      if constexpr (W == 1) {
        const uint32_t w = s_mask[t];
        mask[i0 + t] = w;
        keeps = __popc(w);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) keeps += __popc(s_mask[t * W + w]);
      }
      sols = s_depth[t] == N;
    }
    keeps = warp_sum(keeps);
    sols = warp_sum(sols);
  }
  cycle_publish_counts<TILES>(st, blkcnt, keeps, sols);
}

// Dynamic shared memory of an emit block whose survivor span holds `rows`
// rows: the stash region, the span and its depths, each with 16 bytes of
// phase room.
__host__ __device__ inline size_t nq_emit_smem(int N, int rows,
                                               int aux_bytes) {
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  return tts_stash_block_bytes(PB * N) + (rows * N + 31) / 16 * 16 +
         (rows * aux_bytes + 31) / 16 * 16;
}

// Rows of an emit block's span: every slot of its parents (PB * N, one
// wave, as through N = 32), or as many as fit in the 48 KB a block takes
// without an opt-in, stored in waves.
__host__ __device__ inline int nq_span_rows(int N, int aux_bytes) {
  int rows = TTS_NQ_PARENTS_PER_BLOCK * N;
  while (rows > 1 && nq_emit_smem(N, rows, aux_bytes) > 48 * 1024) rows >>= 1;
  return rows;
}

// Launch 2: rank the block's survivors and store them as one span (in
// waves of span_rows rows, `nq_span_rows`); TILES: and write the block's
// rows of the boundary row bnd (tiles of mt). Under a graph's while node
// (`cond`) it ends the body's run (cycle_common.cuh TtsCond).
template <bool TILES, int W, typename A>
__device__ __forceinline__ void nq_emit_body(
    uint8_t* __restrict__ pool_vals, A* __restrict__ pool_aux, int* st,
    const uint8_t* __restrict__ stash, const A* __restrict__ chunk_aux,
    const uint32_t* __restrict__ mask, const int* __restrict__ blkcnt, int N,
    int M, int* __restrict__ bnd, int mt, const TtsCond& cond) {
  if (!st[ST_ACTIVE]) {
    tts_cond_idle(st, cond);
    return;
  }
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  // Through N = 32 the span holds every slot of the block (PB * N rows,
  // the parent's code); past it, the waves of `nq_span_rows`.
  const int span_rows = W == 1 ? PB * N : nq_span_rows(N, sizeof(A));
  extern __shared__ __align__(16) uint8_t s_nq[];
  __shared__ uint32_t s_mask[PB * W];
  __shared__ int s_d[PB], s_caux[PB], s_off[32], s_red[TILES ? 64 : 32],
      s_total, s_dst0;
  const int base = st[ST_BASE];  // == the pre-pop size minus cnt
  const int start2 = st[ST_START2];
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const int t = threadIdx.x;
  const int SB = tts_stash_block_bytes(PB * N);
  uint8_t* s_rows = s_nq;
  uint8_t* s_span = s_rows + SB;
  uint8_t* s_aspan = s_span + (span_rows * N + 31) / 16 * 16;
  const uint4* region = reinterpret_cast<const uint4*>(
      stash + static_cast<size_t>(blockIdx.x) * SB);
  for (int w = t; w < SB / 16; w += blockDim.x)
    reinterpret_cast<uint4*>(s_rows)[w] = region[w];
  const int phase = static_cast<int>(
      reinterpret_cast<uintptr_t>(pool_vals +
                                  static_cast<size_t>(start2 + i0) * N) &
      15);
  // The mask is 0 on rows outside the popped window and on parents at
  // depth N, so their depth is never read. TILES: a popped parent at depth
  // N is a solution.
  bool sol = false;
  if constexpr (W > 1) {
    for (int w = t; w < rows * W; w += blockDim.x)
      s_mask[w] = mask[static_cast<size_t>(i0) * W + w];
  }
  if (t < rows) {
    if constexpr (W == 1) s_mask[t] = mask[i0 + t];
    const int d = static_cast<int>(chunk_aux[i0 + t]);
    s_d[t] = d;
    s_caux[t] = d + 1;
    if constexpr (TILES) {
      const int row = start2 + i0 + t;
      sol = row >= base && row < base + st[ST_CNT] && d == N;
    }
  }
  emit_sum_counts<TILES>(blkcnt, s_red);
  __syncthreads();
  if (t < 32) {
    emit_block_offsets(st, s_mask, W, rows, s_off, s_red, base, &s_dst0,
                       &s_total, cond, static_cast<long long>(M) * N);
    if constexpr (TILES) {
      __syncwarp();
      emit_tile_bounds(st, bnd, mt, rows, s_off, s_red, s_dst0 - base,
                       s_total, sol, st[ST_BEST]);
    }
  }
  __syncthreads();
  emit_block_children<uint8_t, A>(
      pool_vals, pool_aux, s_dst0, s_rows + phase, s_d, s_caux, s_mask, W,
      s_off, rows, N, s_total, s_span, s_aspan, span_rows);
}

// One cycle on the stream: the labels kernel, then the emit kernel (the
// bodies above, in the caller's `__global__` kernels), which takes the
// boundary row and the tile width (unused by the single-tile cycle). With a
// phase clock `clk` (phase_clock.cuh): a mark opens the cycle (`loop`), one
// after the labels charges `eval` (the labels launch also pops and
// publishes the block counts), one after the emit `push`, which closes it.
// With `in_graph`, the cycle is the whole body of the while node whose
// condition is `cond` (cycle_common.cuh TtsCond).
template <int W, typename A, typename L, typename E>
static int launch_nq_cycle(L labels, E emit, void* pool_vals, void* pool_aux,
                           void* st, void* stash, void* chunk_aux, void* mask,
                           void* blkcnt, void* bnd, int N, int g, int M,
                           int mt, int C, int mterm, int K,
                           unsigned long long cond, int in_graph, void* clk,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TtsCond tc = {cond, in_graph, mterm, C, K};
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  const int nblk = (M + PB - 1) / PB;
  const int threads = tts_cycle_threads(nblk, PB * N, TTS_CYCLE_LOOP_THREADS);
  const int span = nq_span_rows(N, sizeof(A));
  int* st_i = static_cast<int*>(st);
  int err = tts_phase_mark(clk, PH_LOOP, PH_OPEN, s);
  if (err) return err;
  labels<<<nblk, threads, 0, s>>>(
      static_cast<const uint8_t*>(pool_vals), static_cast<const A*>(pool_aux),
      st_i, static_cast<uint8_t*>(stash), static_cast<A*>(chunk_aux),
      static_cast<uint32_t*>(mask), static_cast<int*>(blkcnt), N, g, M, C,
      mterm, K);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = tts_phase_mark(clk, PH_EVAL, 0, s);
  if (err) return err;
  emit<<<nblk, threads, nq_emit_smem(N, span, sizeof(A)), s>>>(
      static_cast<uint8_t*>(pool_vals), static_cast<A*>(pool_aux), st_i,
      static_cast<const uint8_t*>(stash), static_cast<const A*>(chunk_aux),
      static_cast<const uint32_t*>(mask), static_cast<const int*>(blkcnt), N,
      M, static_cast<int*>(bnd), mt, tc);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return tts_phase_mark(clk, PH_PUSH, PH_CLOSE, s);
}

// The cycle at N's mask words and the depth type A: W = 1 and 2 take an
// int8 depth (N <= 64), W = 4 either (N <= 128), W = 8 an int32 one.
// LAUNCH(W, A) launches the caller's kernels of that instantiation.
#define TTS_NQ_DISPATCH(N, AUX32, LAUNCH)                                 \
  do {                                                                    \
    const int w_ = TTS_NQ_WORDS(N);                                       \
    if ((N) < 1 || (N) > TTS_NQ_MAX_N || (AUX32) != ((N) > 127))          \
      return static_cast<int>(cudaErrorInvalidValue);                     \
    if (w_ == 1) return LAUNCH(1, int8_t);                                \
    if (w_ == 2) return LAUNCH(2, int8_t);                                \
    if (w_ == 4)                                                          \
      return (AUX32) ? LAUNCH(4, int32_t) : LAUNCH(4, int8_t);            \
    return LAUNCH(8, int32_t);                                            \
  } while (0)
