// Kernel 10: one streamed (tiled) device-resident N-Queens search cycle on
// the pool.
//
// Replaces the TPU kernel `_mega_nqueens_tiled_kernel`
// (tpu_tree_search/ops/megakernel.py, built by `_nqueens_tiled_call`, grid
// (G,) over G = M / Mt pool tiles with an SMEM carry; wired by the tiled
// N-Queens branch of `make_cycle` and the stitch of `engine/resident.py`).
// The pool is board (C, N) uint8 and depth (C,) int8 (N <= 32).
//
// It computes what kernel 4 (cycle_nqueens.cu) computes, with the popped
// chunk cut into G tiles of Mt parents, one block a tile. One cycle is two
// launches on the caller's stream:
//   1. sweep: the loop condition and the pop (tiled_common.cuh
//      `tile_cycle_pop`); the safety label of every (parent, slot) of the
//      block's tile with keep = label & valid & depth < N into the (M*N)
//      uint8 keep plane, in groups of TTS_NQ_PARENTS_PER_BLOCK parents
//      staged in shared memory (nqueens_common.cuh, g real rounds).
//      N-Queens has no incumbent, so no tile waits on another here; the
//      launch boundary only orders the pop before the emit, which writes
//      over the popped region;
//   2. emit: the tile's survivor count and its popped valid parents at
//      depth == N (the solutions, `megakernel.py:666`), the decoupled
//      look-back of tiled_common.cuh for its offset and cumulative solution
//      count, the child rows (parent with positions depth and k swapped,
//      depth + 1) written at base + offs[t] + rank, the (G, 4) per-tile
//      scalars and, from the last tile, the state update.
// The incumbent st[1] passes through. When the condition is false every
// launch returns at once, so K cycles go to the stream with no host
// synchronisation.
//
// What bounds it on an H100: as kernel 4, the bytes of the popped rows and
// the survivor rows (N + 1 bytes a row) and the keep plane, and the label
// compares; at M = 50,000, N = 15 and Mt = 80 the G = 625 blocks each loop
// over three groups of parents, and the look-back is serial in one thread
// a block.
#include "nqueens_common.cuh"
#include "tiled_common.cuh"

// Labels of the rows [0, rows) of one tile (row i at board + i*N, its depth
// at depth[i]) into out[i*N + k], in groups of TTS_NQ_PARENTS_PER_BLOCK
// parents staged in s_board / s_depth. Rows outside [vlo, vhi) get 0. A row
// at depth N has label 0 on every slot (each slot k < depth), so inside the
// window the label is the cycle's keep flag label & valid & depth < N.
__device__ void nq_tile(const uint8_t* __restrict__ board,
                        const int8_t* __restrict__ depth, int rows, int vlo,
                        int vhi, uint8_t* __restrict__ out, int N, int g,
                        uint8_t* s_board, int* s_depth) {
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  for (int g0 = 0; g0 < rows; g0 += PB) {
    const int gr = min(PB, rows - g0);
    const uint8_t* src = board + static_cast<size_t>(g0) * N;
    for (int e = threadIdx.x; e < gr * N; e += blockDim.x) s_board[e] = src[e];
    for (int e = threadIdx.x; e < gr; e += blockDim.x) {
      const int i = g0 + e;
      s_depth[e] = (i >= vlo && i < vhi) ? static_cast<int>(depth[i]) : -1;
    }
    __syncthreads();
    for (int slot = threadIdx.x; slot < gr * N; slot += blockDim.x) {
      const int p = slot / N;
      const int k = slot - p * N;
      const int d = s_depth[p];
      const int kp = d >= 0 ? nq_label(s_board + p * N, d, k, g) : 0;
      out[static_cast<size_t>(g0) * N + slot] = static_cast<uint8_t>(kp);
    }
    __syncthreads();  // the next group restages the boards
  }
}

// Launch 1: loop condition, pop, the tile's keep plane.
__global__ void tiled_nq_sweep(const uint8_t* __restrict__ pool_vals,
                               const int8_t* __restrict__ pool_aux, int* st,
                               uint8_t* __restrict__ chunk_vals,
                               int8_t* __restrict__ chunk_aux,
                               uint8_t* __restrict__ keep,
                               unsigned long long* __restrict__ status,
                               int* __restrict__ ticket, int N, int g, int M,
                               int mt, int C, int mterm, int K) {
  int start, size, start2;
  if (!tile_cycle_pop(pool_vals, pool_aux, st, chunk_vals, chunk_aux, status,
                      ticket, N, M, mt, C, mterm, K, &start, &size, &start2))
    return;
  __shared__ uint8_t s_board[TTS_NQ_PARENTS_PER_BLOCK * TTS_NQ_MAX_N];
  __shared__ int s_depth[TTS_NQ_PARENTS_PER_BLOCK];
  const int r0 = start2 + blockIdx.x * mt;  // pool row of the tile's first
  nq_tile(pool_vals + static_cast<size_t>(r0) * N, pool_aux + r0, mt,
          start - r0, size - r0, keep + static_cast<size_t>(blockIdx.x) * mt * N,
          N, g, s_board, s_depth);
}

// Launch 2: one block per tile, in ticket order: counts, carry, children.
__global__ void tiled_nq_emit(uint8_t* __restrict__ pool_vals,
                              int8_t* __restrict__ pool_aux, int* st,
                              const uint8_t* __restrict__ chunk_vals,
                              const int8_t* __restrict__ chunk_aux,
                              const uint8_t* __restrict__ keep,
                              unsigned long long* status, int* ticket,
                              int* __restrict__ scal, int N, int mt, int G) {
  if (!st[ST_ACTIVE]) return;
  __shared__ int s_warp[32];
  __shared__ int s_tile, s_off;
  const int t = tile_ticket(ticket, &s_tile);
  const int best = st[ST_BEST];
  const int cnt = st[ST_CNT];
  const int start2 = st[ST_START2];
  const int base = st[ST_BASE];  // the pre-pop size minus cnt
  const int i0 = t * mt;
  const int slots = mt * N;
  const uint8_t* kp = keep + static_cast<size_t>(i0) * N;
  // Each thread owns a contiguous run of slots, so the block scan of the
  // per-thread counts keeps (parent, slot) order. (The keep plane is 0 on
  // rows outside the popped window and on parents at depth N.)
  const int per = (slots + blockDim.x - 1) / blockDim.x;
  const int lo = min(slots, static_cast<int>(threadIdx.x) * per);
  const int hi = min(slots, lo + per);
  int keeps = 0;
  for (int slot = lo; slot < hi; ++slot) keeps += kp[slot];
  int sols = 0;
  for (int p = threadIdx.x; p < mt; p += blockDim.x) {
    const int row = start2 + i0 + p;
    sols += row >= base && row < base + cnt &&
            static_cast<int>(chunk_aux[i0 + p]) == N;
  }
  int dst = tile_carry(keeps, sols, t, G, base, best, st, scal, status,
                       s_warp, &s_off);
  for (int slot = lo; slot < hi && keeps > 0; ++slot) {
    if (!kp[slot]) continue;
    const int p = slot / N;
    const int k = slot - p * N;
    const int i = i0 + p;
    const int d = static_cast<int>(chunk_aux[i]);
    const uint8_t* parent = chunk_vals + static_cast<size_t>(i) * N;
    uint8_t* child = pool_vals + static_cast<size_t>(dst) * N;
    for (int j = 0; j < N; ++j) {
      child[j] = j == d ? parent[k] : (j == k ? parent[d] : parent[j]);
    }
    pool_aux[dst] = static_cast<int8_t>(d + 1);
    ++dst;
    --keeps;
  }
}

static inline int nq_sweep_threads(int mt, int N) {
  return tts_threads_for(
      (mt < TTS_NQ_PARENTS_PER_BLOCK ? mt : TTS_NQ_PARENTS_PER_BLOCK) * N);
}

extern "C" int tiled_nqueens(void* pool_vals, void* pool_aux, void* st,
                             void* chunk_vals, void* chunk_aux, void* keep,
                             void* status, void* ticket, void* scal, int N,
                             int g, int M, int mt, int C, int mterm, int K,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = M / mt;
  int* st_i = static_cast<int*>(st);
  tiled_nq_sweep<<<G, nq_sweep_threads(mt, N), 0, s>>>(
      static_cast<const uint8_t*>(pool_vals),
      static_cast<const int8_t*>(pool_aux), st_i,
      static_cast<uint8_t*>(chunk_vals), static_cast<int8_t*>(chunk_aux),
      static_cast<uint8_t*>(keep), static_cast<unsigned long long*>(status),
      static_cast<int*>(ticket), N, g, M, mt, C, mterm, K);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  tiled_nq_emit<<<G, tts_threads_for(mt * N), 0, s>>>(
      static_cast<uint8_t*>(pool_vals), static_cast<int8_t*>(pool_aux), st_i,
      static_cast<const uint8_t*>(chunk_vals),
      static_cast<const int8_t*>(chunk_aux),
      static_cast<const uint8_t*>(keep),
      static_cast<unsigned long long*>(status), static_cast<int*>(ticket),
      static_cast<int*>(scal), N, mt, G);
  return static_cast<int>(cudaGetLastError());
}
