// Shared code of the fused PFSP cycles (cycle_lb1.cu, cycle_lb2.cu, and the
// streamed tiled_lb1.cu, tiled_lb2.cu through cycle_lb1.cuh and
// cycle_lb2.cuh), which differ only in the bound that launch 1 writes into
// the (M*n) plane and, streamed, in the tile boundaries' row.
//
// Launch 1 of each starts with `pfsp_cycle_begin` (the loop condition) and
// a pop into the stash, and ends with `pfsp_fold_leaves` (the incumbent
// folded over the chunk's leaves); launches 2-3 (count, emit) read only the
// plane, the mask words and the stash, and are `launch_pfsp_cycle_tail`.
// cycle_lb1.cu's header note gives the launch sequence, the state layout
// and the design.
#pragma once

#include "cycle_common.cuh"
#include "phase_clock.cuh"
#include "lb1_common.cuh"

// Launch 1's head: evaluate the loop condition of `resident.py:421-423`
// (size >= m, size + M*n <= C, cycles < K) from st. When it is false, block
// 0 clears st[5] and the function returns false: the whole cycle is then a
// no-op. Otherwise block 0 records cnt = min(size, M), start2 =
// clip(size - cnt, 0, C - M) (the valid window of `resident.py:228-236`)
// and base = size - cnt. Rows start2 + i in [start, size) are the popped
// parents.
__device__ __forceinline__ bool pfsp_cycle_begin(int* st, int n, int M,
                                                 int C, int mterm, int K,
                                                 int* start, int* size,
                                                 int* start2) {
  const int sz = st[ST_SIZE];
  const bool active = tts_loop_active(sz, st[ST_CYCLES], mterm,
                                      static_cast<long long>(M) * n, C, K);
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
  }
  return true;
}

// Bytes of the stash region of one block of TTS_CYCLE_PARENTS parents.
template <typename T>
__host__ __device__ __forceinline__ int pfsp_stash_block_bytes(int n) {
  return tts_stash_block_bytes(TTS_CYCLE_PARENTS * n *
                               static_cast<int>(sizeof(T)));
}

// The stash row of chunk parent i: in the region of its emit block
// (TTS_CYCLE_PARENTS parents a block), at the phase mod 16 of that block's
// first pool row, as `copy_keep_phase` leaves it.
template <typename T>
__device__ __forceinline__ T* pfsp_stash_row(uint8_t* stash,
                                             const T* pool_vals, int start2,
                                             int i, int n) {
  const int b = i / TTS_CYCLE_PARENTS;
  const int q = i - b * TTS_CYCLE_PARENTS;
  const uintptr_t first = reinterpret_cast<uintptr_t>(
      pool_vals + static_cast<size_t>(start2 + b * TTS_CYCLE_PARENTS) * n);
  return reinterpret_cast<T*>(stash +
                              static_cast<size_t>(b) *
                                  pfsp_stash_block_bytes<T>(n) +
                              (first & 15)) +
         static_cast<size_t>(q) * n;
}

// The pop of a launch 1 whose blocks hold PB parents (any PB): rows
// i0..i0+rows-1 of the M-window into the stash, one element a thread, and
// their limit1 into chunk_aux.
template <typename T>
__device__ __forceinline__ void pfsp_stash_pop(const T* __restrict__ pool_vals,
                                               const T* __restrict__ pool_aux,
                                               uint8_t* __restrict__ stash,
                                               T* __restrict__ chunk_aux,
                                               int start2, int i0, int rows,
                                               int n) {
  const T* src = pool_vals + static_cast<size_t>(start2 + i0) * n;
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int q = e / n;
    pfsp_stash_row(stash, pool_vals, start2, i0 + q, n)[e - q * n] = src[e];
  }
  for (int e = threadIdx.x; e < rows; e += blockDim.x)
    chunk_aux[i0 + e] = pool_aux[start2 + i0 + e];
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

// Launch 2: keep = open & ~leaf & lb < best of every slot of the block's
// TTS_CYCLE_PARENTS parents, read once from the plane and packed into W =
// ceil(n/32) mask words a parent; the block's survivor count and leaves
// (a popped parent at limit1 = n-2 has one child, a leaf), published by
// cycle_publish_counts<TILES> (TILES: the streamed cycles, kernels 9b and
// 9c).
template <typename T, bool TILES>
__device__ __forceinline__ void cycle_count_body(
    int* st, const T* __restrict__ chunk_aux, const int* __restrict__ lb,
    uint32_t* __restrict__ mask, int* __restrict__ blkcnt, int n, int M) {
  if (!st[ST_ACTIVE]) return;
  extern __shared__ uint32_t s_cmask[];  // PB * W words
  __shared__ int s_l1[TTS_CYCLE_PARENTS];
  __shared__ int s_keep, s_leaf;
  const int best = st[ST_BEST];
  const int cnt = st[ST_CNT];
  const int start2 = st[ST_START2];
  const int base = st[ST_BASE];
  const int PB = TTS_CYCLE_PARENTS;
  const int W = (n + 31) / 32;
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const int t = threadIdx.x;
  if (t < PB) {
    const int row = start2 + i0 + t;
    // A row outside the popped window gets limit1 = n: no open slot.
    s_l1[t] = (t < rows && row >= base && row < base + cnt)
                  ? static_cast<int>(chunk_aux[i0 + t])
                  : n;
  }
  if (t == 0) {
    s_keep = 0;
    s_leaf = 0;
  }
  for (int w = t; w < PB * W; w += blockDim.x) s_cmask[w] = 0;
  __syncthreads();
  const int* plane = lb + static_cast<size_t>(i0) * n;
  int p = t / n, k = t - (t / n) * n;
  const int dp = static_cast<int>(blockDim.x) / n;
  const int dk = static_cast<int>(blockDim.x) - dp * n;
  for (int s = t; s < rows * n; s += blockDim.x) {
    const int l1 = s_l1[p];
    if (k >= l1 + 1 && l1 + 2 != n && plane[s] < best)
      atomicOr(&s_cmask[p * W + (k >> 5)], 1u << (k & 31));
    p += dp;
    k += dk;
    if (k >= n) {
      k -= n;
      ++p;
    }
  }
  __syncthreads();
  int keeps = 0;
  for (int w = t; w < rows * W; w += blockDim.x) {
    const uint32_t v = s_cmask[w];
    mask[static_cast<size_t>(i0) * W + w] = v;
    keeps += __popc(v);
  }
  int leaves = (t < rows && s_l1[t] == n - 2) ? 1 : 0;
  keeps = warp_sum(keeps);
  leaves = warp_sum(leaves);
  if ((t & 31) == 0) {
    if (keeps) atomicAdd(&s_keep, keeps);
    if (leaves) atomicAdd(&s_leaf, leaves);
  }
  __syncthreads();
  cycle_publish_counts<TILES>(st, blkcnt, s_keep, s_leaf);
}

template <typename T>
__global__ void cycle_count(int* st, const T* __restrict__ chunk_aux,
                            const int* __restrict__ lb,
                            uint32_t* __restrict__ mask,
                            int* __restrict__ blkcnt, int n, int M) {
  cycle_count_body<T, false>(st, chunk_aux, lb, mask, blkcnt, n, M);
}

// The streamed cycles' count launch (kernels 9b and 9c).
template <typename T>
__global__ void pfsp_tiles_count(int* st, const T* __restrict__ chunk_aux,
                                 const int* __restrict__ lb,
                                 uint32_t* __restrict__ mask,
                                 int* __restrict__ blkcnt, int n, int M) {
  cycle_count_body<T, true>(st, chunk_aux, lb, mask, blkcnt, n, M);
}

// Launch 3: the block's offset from the counts before it, its survivors
// ranked from its mask words and stored as one span (emit_block_children),
// the parents read from the stash; the last block updates the state.
// TILES (the streamed cycles, kernels 9b and 9c): and the block's rows of the
// boundary row bnd (tiles of mt parents, cycle_common.cuh
// `emit_tile_bounds`), whose solution counts are the leaves.
template <typename T, bool TILES>
__device__ __forceinline__ void cycle_emit_body(
    T* __restrict__ pool_vals, T* __restrict__ pool_aux, int* st,
    const uint8_t* __restrict__ stash, const T* __restrict__ chunk_aux,
    const uint32_t* __restrict__ mask, const int* __restrict__ blkcnt, int n,
    int M, int span_rows, int* __restrict__ bnd, int mt, const TtsCond& cond) {
  if (!st[ST_ACTIVE]) {
    tts_cond_idle(st, cond);
    return;
  }
  extern __shared__ __align__(16) uint8_t s_emit[];
  __shared__ int s_d[TTS_CYCLE_PARENTS], s_off[32], s_red[TILES ? 64 : 32],
      s_total, s_dst0;
  const int base = st[ST_BASE];  // == the pre-pop size minus cnt
  const int start2 = st[ST_START2];
  const int PB = TTS_CYCLE_PARENTS;
  const int W = (n + 31) / 32;
  const int SB = pfsp_stash_block_bytes<T>(n);
  const int span_bytes = (span_rows * n * static_cast<int>(sizeof(T)) + 31) /
                         16 * 16;
  const int aspan_bytes = (span_rows * static_cast<int>(sizeof(T)) + 31) /
                          16 * 16;
  uint8_t* s_rows = s_emit;
  uint8_t* s_span = s_rows + SB;
  uint8_t* s_aspan = s_span + span_bytes;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_aspan + aspan_bytes);
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const int t = threadIdx.x;
  const uint4* region = reinterpret_cast<const uint4*>(
      stash + static_cast<size_t>(blockIdx.x) * SB);
  for (int w = t; w < SB / 16; w += blockDim.x)
    reinterpret_cast<uint4*>(s_rows)[w] = region[w];
  for (int w = t; w < rows * W; w += blockDim.x)
    s_mask[w] = mask[static_cast<size_t>(i0) * W + w];
  // A parent's mask is 0 outside the popped window, so its limit1 is never
  // read there. TILES: a popped parent at limit1 = n - 2 is a leaf.
  bool leaf = false;
  if (t < rows) {
    const int l1 = static_cast<int>(chunk_aux[i0 + t]);
    s_d[t] = l1 + 1;
    if constexpr (TILES) {
      const int row = start2 + i0 + t;
      leaf = row >= base && row < base + st[ST_CNT] && l1 == n - 2;
    }
  }
  emit_sum_counts<TILES>(blkcnt, s_red);
  __syncthreads();
  if (t < 32) {
    emit_block_offsets(st, s_mask, W, rows, s_off, s_red, base, &s_dst0,
                       &s_total, cond, static_cast<long long>(M) * n);
    if constexpr (TILES) {
      __syncwarp();
      emit_tile_bounds(st, bnd, mt, rows, s_off, s_red, s_dst0 - base,
                       s_total, leaf, st[ST_BEST]);
    }
  }
  __syncthreads();
  const int phase = static_cast<int>(
      reinterpret_cast<uintptr_t>(pool_vals +
                                  static_cast<size_t>(start2 + i0) * n) &
      15);
  emit_block_children<T, T>(pool_vals, pool_aux, s_dst0,
                            reinterpret_cast<const T*>(s_rows + phase), s_d,
                            s_d, s_mask, W, s_off, rows, n, s_total, s_span,
                            s_aspan, span_rows);
}

// The single-tile cycles' emit launch (kernels 2 and 8; bnd and mt unused).
template <typename T>
__global__ void cycle_emit(T* __restrict__ pool_vals,
                           T* __restrict__ pool_aux, int* st,
                           const uint8_t* __restrict__ stash,
                           const T* __restrict__ chunk_aux,
                           const uint32_t* __restrict__ mask,
                           const int* __restrict__ blkcnt, int n, int M,
                           int span_rows, int* __restrict__ bnd, int mt,
                           TtsCond cond) {
  cycle_emit_body<T, false>(pool_vals, pool_aux, st, stash, chunk_aux, mask,
                            blkcnt, n, M, span_rows, bnd, mt, cond);
}

// The streamed cycles' emit launch (kernels 9b and 9c).
template <typename T>
__global__ void pfsp_tiles_emit(T* __restrict__ pool_vals,
                                T* __restrict__ pool_aux, int* st,
                                const uint8_t* __restrict__ stash,
                                const T* __restrict__ chunk_aux,
                                const uint32_t* __restrict__ mask,
                                const int* __restrict__ blkcnt, int n, int M,
                                int span_rows, int* __restrict__ bnd,
                                int mt, TtsCond cond) {
  cycle_emit_body<T, true>(pool_vals, pool_aux, st, stash, chunk_aux, mask,
                           blkcnt, n, M, span_rows, bnd, mt, cond);
}

// Rows of one emit wave: all of a block's slots when their rows fit
// TTS_SPAN_BYTES, else as many as fit.
#define TTS_SPAN_BYTES 32768
template <typename T>
static inline int pfsp_span_rows(int n) {
  const int all = TTS_CYCLE_PARENTS * n;
  const int fit = TTS_SPAN_BYTES / (n * static_cast<int>(sizeof(T)));
  return all < fit ? all : (fit > 0 ? fit : 1);
}

// Launches 2-3 on the stream, after a launch 1 that filled the plane `lb`
// ((M*n) int32, followed by the M*W mask words) and the stash. TILES: the
// streamed cycle's kernels, which also write the boundary row bnd of tiles
// of mt parents (blkcnt then holds a pair a block). With a phase clock
// `clk` (phase_clock.cuh), a mark after each: `compact`, then `push`, which
// closes the cycle; null enqueues the two launches alone. `cond`: the
// emit sets the while node's condition (cycle_common.cuh TtsCond).
template <typename T, bool TILES = false>
static int launch_pfsp_cycle_tail(void* pool_vals, void* pool_aux, int* st,
                                  const void* stash, const void* chunk_aux,
                                  int* lb, void* blkcnt, int n, int M,
                                  cudaStream_t s, int* bnd, int mt,
                                  void* clk, const TtsCond& cond) {
  const int PB = TTS_CYCLE_PARENTS;
  const int nblk = (M + PB - 1) / PB;
  const int threads = tts_cycle_threads(nblk, PB * n, TTS_CYCLE_LOOP_THREADS);
  const int W = (n + 31) / 32;
  uint32_t* mask =
      reinterpret_cast<uint32_t*>(lb + static_cast<size_t>(M) * n);
  const size_t count_smem = sizeof(uint32_t) * PB * W;
  auto count = [] {
    if constexpr (TILES) return pfsp_tiles_count<T>;
    else return cycle_count<T>;
  }();
  auto emit = [] {
    if constexpr (TILES) return pfsp_tiles_emit<T>;
    else return cycle_emit<T>;
  }();
  int err = tts_smem_optin(count, count_smem);
  if (err) return err;
  count<<<nblk, threads, count_smem, s>>>(
      st, static_cast<const T*>(chunk_aux), lb, mask,
      static_cast<int*>(blkcnt), n, M);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = tts_phase_mark(clk, PH_COMPACT, 0, s);
  if (err) return err;
  const int span_rows = pfsp_span_rows<T>(n);
  const size_t emit_smem =
      pfsp_stash_block_bytes<T>(n) +
      (span_rows * n * sizeof(T) + 31) / 16 * 16 +
      (span_rows * sizeof(T) + 31) / 16 * 16 + sizeof(uint32_t) * PB * W;
  err = tts_smem_optin(emit, emit_smem);
  if (err) return err;
  emit<<<nblk, threads, emit_smem, s>>>(
      static_cast<T*>(pool_vals), static_cast<T*>(pool_aux), st,
      static_cast<const uint8_t*>(stash), static_cast<const T*>(chunk_aux),
      mask, static_cast<const int*>(blkcnt), n, M, span_rows, bnd, mt, cond);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return tts_phase_mark(clk, PH_PUSH, PH_CLOSE, s);
}
