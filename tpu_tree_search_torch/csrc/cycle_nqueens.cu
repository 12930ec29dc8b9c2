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
// the PFSP cycles (size, best, tree, sol, cycles, active, cnt, start2,
// base). One cycle is two launches on the caller's stream, one block per
// 32 parents in both:
//   1. labels: evaluate the loop condition (size >= m, size + M*N <= C,
//      cycles < K) from st; block 0 records cnt = min(size, M), start2 =
//      clip(size - cnt, 0, C - M) and base = size - cnt; each block copies
//      its M-window rows (one contiguous byte range) into its region of the
//      stash and into shared memory as aligned 16-byte words, computes the
//      safety label of every (parent, slot) with keep = label & valid &
//      depth < N, packs the keeps of a parent into bit k of one uint32 mask
//      word, publishes its survivor count and adds its popped valid parents
//      at depth == N (the solutions, `megakernel.py:563`) to st[3];
//   2. emit: each block sums the survivor counts of the blocks before it,
//      reads its stash region and mask words, ranks its survivors with one
//      warp scan over its parents and popcounts, builds them in shared
//      memory (parent row with positions depth and k swapped, and
//      depth + 1) in rank order, and stores the block's span of the pool,
//      base + the blocks' survivors before it onward, as aligned 16-byte
//      words: the survivors land at the pool's size in exact (parent, slot)
//      order, as the dense compaction of the JAX engine leaves them. The
//      last block writes size = base + tree_inc, tree += tree_inc and
//      cycles += 1.
// The incumbent st[1] passes through: N-Queens has none. When the condition
// is false, launch 1 clears st[5] and both launches return at once: an
// exact no-op, so the host enqueues K cycles with no synchronisation.
//
// Why two launches and not one: the emit writes over popped rows of blocks
// that may not have stashed them yet (Hopper blocks run in no order), so
// it reads parents only from launch 1's stash, and the survivor offsets
// across blocks need every block's count.
//
// What bounds it on an H100: at M = 50,000 and N = 15 a full cycle must
// move about 0.8 MB of popped rows and 3.1 MB of survivor rows (N + 1
// bytes a row), about 1.2 us at 3.35 TB/s; the label compares (sum depth *
// (N - depth) * 4 a cycle) are a tenth of that. It takes about 14x that:
// each launch pays a few microseconds of fixed cost and each block a chain
// of dependent loads and barriers. What the design does, against the
// three-launch version it replaces (measured in PERF.md, section 6):
//   - no scan launch: the labels launch publishes one count a block, and
//     each emit block sums its predecessors' counts with 16-byte loads that
//     go out beside its stash loads (a ticket for a last-block scan,
//     measured, cost more than the launch it saved);
//   - one mask word a parent (200 KB a full cycle) in place of a byte a
//     slot (750 KB) read back through a per-thread run of slots;
//   - the pop and the survivor span move as aligned 16-byte words, the
//     span built in shared memory in rank order, in place of single bytes
//     at a 15-byte stride;
//   - blocks of 128 threads that loop over their slots when one thread a
//     slot would not fit on the card at once, so the grid is one wave;
//   - the labels are as they were: g real rounds per (parent, slot).
#include "cycle_common.cuh"
#include "nqueens_common.cuh"

static_assert(TTS_NQ_PARENTS_PER_BLOCK == TTS_CYCLE_PARENTS,
              "the N-Queens cycle ranks a block's parents with one warp");

#define NQ_STASH_MAX (TTS_NQ_PARENTS_PER_BLOCK * TTS_NQ_MAX_N + 32)

// Launch 1: loop condition, pop, labels, keep masks, per-block counts.
__global__ void nq_cycle_labels(const uint8_t* __restrict__ pool_vals,
                                const int8_t* __restrict__ pool_aux, int* st,
                                uint8_t* __restrict__ stash,
                                int8_t* __restrict__ chunk_aux,
                                uint32_t* __restrict__ mask,
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
    st[ST_BASE] = start;
  }

  __shared__ __align__(16) uint8_t s_rows[NQ_STASH_MAX];
  __shared__ uint32_t s_mask[TTS_NQ_PARENTS_PER_BLOCK];
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
    const int8_t d = pool_aux[row];
    chunk_aux[i0 + t] = d;
    s_depth[t] = (row >= start && row < size) ? static_cast<int>(d) : -1;
  }
  if (t < PB) s_mask[t] = 0;
  __syncthreads();

  // Every (parent, slot), the split of a thread's first slot and of the
  // stride into (parent, slot) taken once.
  {
    int p = t / N, k = t - (t / N) * N;
    const int dp = static_cast<int>(blockDim.x) / N;
    const int dk = static_cast<int>(blockDim.x) - dp * N;
    for (int s = t; s < rows * N; s += blockDim.x) {
      const int d = s_depth[p];
      if (d >= 0 && d < N && nq_label(s_board + p * N, d, k, g))
        atomicOr(&s_mask[p], 1u << k);
      p += dp;
      k += dk;
      if (k >= N) {
        k -= N;
        ++p;
      }
    }
  }
  __syncthreads();
  int keeps = 0, sols = 0;
  if (t < 32) {
    if (t < rows) {
      const uint32_t w = s_mask[t];
      mask[i0 + t] = w;
      keeps = __popc(w);
      sols = s_depth[t] == N;
    }
    keeps = warp_sum(keeps);
    sols = warp_sum(sols);
  }
  cycle_publish_counts(st, blkcnt, keeps, sols);
}

// Launch 2: rank the block's survivors and store them as one span.
__global__ void nq_cycle_emit(uint8_t* __restrict__ pool_vals,
                              int8_t* __restrict__ pool_aux, int* st,
                              const uint8_t* __restrict__ stash,
                              const int8_t* __restrict__ chunk_aux,
                              const uint32_t* __restrict__ mask,
                              const int* __restrict__ blkcnt, int N, int M) {
  if (!st[ST_ACTIVE]) return;
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  extern __shared__ __align__(16) uint8_t s_nq[];
  __shared__ uint32_t s_mask[PB];
  __shared__ int s_d[PB], s_caux[PB], s_off[32], s_red[32], s_total, s_dst0;
  const int base = st[ST_BASE];  // == the pre-pop size minus cnt
  const int start2 = st[ST_START2];
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const int t = threadIdx.x;
  const int SB = tts_stash_block_bytes(PB * N);
  uint8_t* s_rows = s_nq;
  uint8_t* s_span = s_rows + SB;
  uint8_t* s_aspan = s_span + (PB * N * N + 31) / 16 * 16;
  const uint4* region = reinterpret_cast<const uint4*>(
      stash + static_cast<size_t>(blockIdx.x) * SB);
  for (int w = t; w < SB / 16; w += blockDim.x)
    reinterpret_cast<uint4*>(s_rows)[w] = region[w];
  const int phase = static_cast<int>(
      reinterpret_cast<uintptr_t>(pool_vals +
                                  static_cast<size_t>(start2 + i0) * N) &
      15);
  // The mask is 0 on rows outside the popped window and on parents at
  // depth N, so their depth is never read.
  if (t < rows) {
    s_mask[t] = mask[i0 + t];
    const int d = static_cast<int>(chunk_aux[i0 + t]);
    s_d[t] = d;
    s_caux[t] = d + 1;
  }
  emit_sum_counts(blkcnt, s_red);
  __syncthreads();
  if (t < 32)
    emit_block_offsets(st, s_mask, 1, rows, s_off, s_red, base, &s_dst0,
                       &s_total);
  __syncthreads();
  emit_block_children<uint8_t, int8_t>(
      pool_vals, pool_aux, s_dst0, s_rows + phase, s_d, s_caux, s_mask, 1,
      s_off, rows, N, s_total, s_span, s_aspan, PB * N);
}

// Dynamic shared memory of an emit block: the stash region, the survivor
// span (every slot kept) and its depths, each with 16 bytes of phase room.
static inline size_t nq_emit_smem(int N) {
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  return tts_stash_block_bytes(PB * N) + (PB * N * N + 31) / 16 * 16 +
         (PB * N + 31) / 16 * 16;
}

extern "C" int cycle_nqueens(void* pool_vals, void* pool_aux, void* st,
                             void* chunk_vals, void* chunk_aux, void* keep,
                             void* blkcnt, int N, int g, int M, int C,
                             int mterm, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  const int nblk = (M + PB - 1) / PB;
  const int threads = tts_cycle_threads(nblk, PB * N, TTS_CYCLE_LOOP_THREADS);
  int* st_i = static_cast<int*>(st);
  nq_cycle_labels<<<nblk, threads, 0, s>>>(
      static_cast<const uint8_t*>(pool_vals),
      static_cast<const int8_t*>(pool_aux), st_i,
      static_cast<uint8_t*>(chunk_vals), static_cast<int8_t*>(chunk_aux),
      static_cast<uint32_t*>(keep), static_cast<int*>(blkcnt), N, g, M, C,
      mterm, K);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  nq_cycle_emit<<<nblk, threads, nq_emit_smem(N), s>>>(
      static_cast<uint8_t*>(pool_vals), static_cast<int8_t*>(pool_aux), st_i,
      static_cast<const uint8_t*>(chunk_vals),
      static_cast<const int8_t*>(chunk_aux),
      static_cast<const uint32_t*>(keep), static_cast<const int*>(blkcnt), N,
      M);
  return static_cast<int>(cudaGetLastError());
}
