// Kernel 4: one whole device-resident N-Queens search cycle on the pool.
//
// Replaces the TPU kernel `_mega_nqueens_kernel` (tpu_tree_search/ops/megakernel.py,
// built by `_nqueens_cycle_call`, with the in-VMEM compaction
// `_compact_push`; wired by the N-Queens branch of `make_cycle`), together
// with the engine steps around it in `engine/resident.py` `loop_fns`: the
// loop condition, the pop, and the write of the survivors back into the
// pool. The pool is board (C, N) uint8 and depth (C,) int8 (N <= 32).
//
// The loop state is the int32 tensor `st` of cycle_common.cuh, shared with
// the lb1 cycle (size, best, tree, sol, cycles, active, cnt, start2, base).
// One cycle is three launches on the caller's stream:
//   1. labels: evaluate the loop condition (size >= m, size + M*N <= C,
//      cycles < K) from st; pop the back cnt = min(size, M) rows
//      (start2 = clip(size - cnt, 0, C - M)) into a stash; the safety label
//      of every (parent, slot) with keep = label & valid & depth < N into
//      an (M*N) uint8 plane; per block the survivor count and the popped
//      valid parents at depth == N (the solutions, `megakernel.py:563`);
//   2. scan (one block, cycle_common.cuh): block offsets, then
//      size = size - cnt + tree_inc, tree += tree_inc, sol += sol_inc,
//      cycles += 1;
//   3. emit: each block ranks its keeps with a block scan and writes each
//      survivor (parent row with positions depth and k swapped, and
//      depth + 1) at base + block offset + rank: the survivors land at the
//      pool's size in exact (parent, slot) order, as the dense compaction
//      of the JAX engine leaves them.
// The incumbent st[1] passes through: N-Queens has none. When the condition
// is false, launch 1 clears st[5] and every launch returns at once: an
// exact no-op, so the host enqueues K cycles with no synchronisation.
//
// Why three launches and not the lb1 cycle's four: the lb1 cycle folds the
// incumbent over every leaf before any keep test, a cross-block dependency
// that costs a launch boundary. N-Queens has no incumbent, so the labels
// and the per-block counts share one launch; only the survivor offsets
// across blocks remain a boundary (Hopper blocks run in no order).
//
// What bounds it on an H100: at M = 50,000 and N = 15, the bytes of the
// popped rows read and the survivor rows written (N + 1 bytes a row) and
// the keep plane (one byte a slot, written once and read once), about
// 2-4 MB a cycle, i.e. about a microsecond; in practice the three launch
// latencies and the label compares (sum depth * (N - depth) * 4 a cycle).
#include "cycle_common.cuh"
#include "nqueens_common.cuh"

// Launch 1: loop condition, pop, labels, keep plane, per-block counts.
__global__ void nq_cycle_labels(const uint8_t* __restrict__ pool_vals,
                                const int8_t* __restrict__ pool_aux, int* st,
                                uint8_t* __restrict__ chunk_vals,
                                int8_t* __restrict__ chunk_aux,
                                uint8_t* __restrict__ keep,
                                int* __restrict__ blkcnt, int N, int g, int M,
                                int C, int mterm, int K) {
  const int size = st[ST_SIZE];
  const int cycles = st[ST_CYCLES];
  const bool active = size >= mterm &&
                      static_cast<long long>(size) +
                              static_cast<long long>(M) * N <=
                          C &&
                      cycles < K;
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
  }

  __shared__ uint8_t s_board[TTS_NQ_PARENTS_PER_BLOCK * TTS_NQ_MAX_N];
  // Parent depth, or -1 for a row of the M-window outside the popped rows.
  __shared__ int s_depth[TTS_NQ_PARENTS_PER_BLOCK];
  __shared__ int s_keep, s_sol;
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  // The pop: stash this block's M-window rows (the emit of launch 3 writes
  // survivors over the popped region, so it reads parents from the stash).
  const uint8_t* src = pool_vals + static_cast<size_t>(start2 + i0) * N;
  uint8_t* stash = chunk_vals + static_cast<size_t>(i0) * N;
  for (int e = threadIdx.x; e < rows * N; e += blockDim.x) {
    const uint8_t v = src[e];
    stash[e] = v;
    s_board[e] = v;
  }
  for (int e = threadIdx.x; e < rows; e += blockDim.x) {
    const int row = start2 + i0 + e;
    const int8_t d = pool_aux[row];
    chunk_aux[i0 + e] = d;
    s_depth[e] = (row >= start && row < size) ? static_cast<int>(d) : -1;
  }
  if (threadIdx.x == 0) {
    s_keep = 0;
    s_sol = 0;
  }
  __syncthreads();

  int keeps = 0;
  for (int slot = threadIdx.x; slot < rows * N; slot += blockDim.x) {
    const int p = slot / N;
    const int k = slot - p * N;
    const int d = s_depth[p];
    const int kp = (d >= 0 && d < N) ? nq_label(s_board + p * N, d, k, g) : 0;
    keep[static_cast<size_t>(i0) * N + slot] = static_cast<uint8_t>(kp);
    keeps += kp;
  }
  int sols = 0;
  for (int p = threadIdx.x; p < rows; p += blockDim.x) sols += s_depth[p] == N;
  if (keeps) atomicAdd(&s_keep, keeps);
  if (sols) atomicAdd(&s_sol, sols);
  __syncthreads();
  if (threadIdx.x == 0) {
    blkcnt[2 * blockIdx.x] = s_keep;
    blkcnt[2 * blockIdx.x + 1] = s_sol;
  }
}

// Launch 3: rank the block's survivors and write the child rows.
__global__ void nq_cycle_emit(uint8_t* __restrict__ pool_vals,
                              int8_t* __restrict__ pool_aux, const int* st,
                              const uint8_t* __restrict__ chunk_vals,
                              const int8_t* __restrict__ chunk_aux,
                              const uint8_t* __restrict__ keep,
                              const int* __restrict__ blkoff, int N, int M) {
  if (!st[ST_ACTIVE]) return;
  __shared__ int s_warp[32];
  __shared__ uint8_t s_board[TTS_NQ_PARENTS_PER_BLOCK * TTS_NQ_MAX_N];
  __shared__ int s_depth[TTS_NQ_PARENTS_PER_BLOCK];
  const int base = st[ST_BASE];  // == the pre-pop size minus cnt
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const int slots = rows * N;
  const uint8_t* src = chunk_vals + static_cast<size_t>(i0) * N;
  for (int e = threadIdx.x; e < slots; e += blockDim.x) s_board[e] = src[e];
  for (int e = threadIdx.x; e < rows; e += blockDim.x)
    s_depth[e] = static_cast<int>(chunk_aux[i0 + e]);
  const uint8_t* kp = keep + static_cast<size_t>(i0) * N;
  // Each thread owns a contiguous run of slots, so the block scan of the
  // per-thread counts keeps (parent, slot) order. (The keep plane is 0 on
  // rows outside the popped window and on parents at depth N.)
  const int per = (slots + blockDim.x - 1) / blockDim.x;
  const int lo = min(slots, static_cast<int>(threadIdx.x) * per);
  const int hi = min(slots, lo + per);
  int keeps = 0;
  for (int slot = lo; slot < hi; ++slot) keeps += kp[slot];
  int total;
  // The scan's barriers also order the shared-memory staging above.
  int dst = base + blkoff[blockIdx.x] +
            block_exclusive_scan(keeps, s_warp, &total);
  for (int slot = lo; slot < hi && keeps > 0; ++slot) {
    if (!kp[slot]) continue;
    const int p = slot / N;
    const int k = slot - p * N;
    const int d = s_depth[p];
    const uint8_t* parent = s_board + p * N;
    uint8_t* child = pool_vals + static_cast<size_t>(dst) * N;
    for (int j = 0; j < N; ++j) {
      child[j] = j == d ? parent[k] : (j == k ? parent[d] : parent[j]);
    }
    pool_aux[dst] = static_cast<int8_t>(d + 1);
    ++dst;
    --keeps;
  }
}

extern "C" int cycle_nqueens(void* pool_vals, void* pool_aux, void* st,
                             void* chunk_vals, void* chunk_aux, void* keep,
                             void* blkcnt, void* blkoff, int N, int g, int M,
                             int C, int mterm, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  const int nblk = (M + PB - 1) / PB;
  const int threads = tts_threads_for(PB * N);
  int* st_i = static_cast<int*>(st);
  nq_cycle_labels<<<nblk, threads, 0, s>>>(
      static_cast<const uint8_t*>(pool_vals),
      static_cast<const int8_t*>(pool_aux), st_i,
      static_cast<uint8_t*>(chunk_vals), static_cast<int8_t*>(chunk_aux),
      static_cast<uint8_t*>(keep), static_cast<int*>(blkcnt), N, g, M, C,
      mterm, K);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  cycle_scan<<<1, 1024, 0, s>>>(st_i, static_cast<const int*>(blkcnt),
                                static_cast<int*>(blkoff), nblk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  nq_cycle_emit<<<nblk, threads, 0, s>>>(
      static_cast<uint8_t*>(pool_vals), static_cast<int8_t*>(pool_aux), st_i,
      static_cast<const uint8_t*>(chunk_vals),
      static_cast<const int8_t*>(chunk_aux),
      static_cast<const uint8_t*>(keep), static_cast<const int*>(blkoff), N,
      M);
  return static_cast<int>(cudaGetLastError());
}
