// Kernel 2: one whole device-resident PFSP lb1 search cycle on the pool.
//
// Replaces the TPU kernel `_mega_lb1_kernel` (tpu_tree_search/ops/megakernel.py,
// built by `_lb1_cycle_call`, with the epilogue `_pfsp_epilogue` and the
// in-VMEM compaction `_compact_push`; wired by `make_cycle`), together with
// the engine steps around it in `engine/resident.py` `loop_fns`: the loop
// condition, the pop, and the write of the survivors back into the pool.
//
// The loop state is one small int32 device tensor `st`:
//   st[0] size  st[1] best  st[2] tree  st[3] sol  st[4] cycles
//   st[5] active  st[6] cnt  st[7] start2  st[8] base  (this cycle's pop)
// One cycle is three launches on the caller's stream, each one block per
// 32 parents:
//   1. bounds: evaluate the loop condition of `resident.py:421-423`
//      (size >= m, size + M*n <= C, cycles < K) from st; block 0 records
//      cnt = min(size, M), start2 = clip(size - cnt, 0, C - M) (the valid
//      window of `resident.py:228-236`) and base = size - cnt; each block
//      copies its M-window rows into its stash region and into shared
//      memory as aligned 16-byte words, computes its parents' fronts and
//      remaining work, lb1 of every child slot into an (M*n) int32 plane,
//      and folds the leaf makespans into st[1] with atomicMin (so the keep
//      test sees the final incumbent);
//   2. count (cycle_pfsp.cuh): keep = open & ~leaf & lb < best, read once
//      from the plane and packed into ceil(n/32) mask words a parent; the
//      block's survivor count, and its leaves added to st[3];
//   3. emit (cycle_pfsp.cuh): each block sums the survivor counts of the
//      blocks before it, ranks its survivors from the mask words, builds
//      them in shared memory (parent row with positions limit1+1 and k
//      swapped, and limit1 + 1) in rank order and stores the block's span
//      of the pool as aligned 16-byte words: the survivors land at the
//      pool's size in exact (parent, slot) order, as the dense compaction
//      of the JAX engine leaves them. The last block writes size, tree and
//      cycles.
// When the condition is false, launch 1 clears st[5] and every launch of the
// cycle returns at once: an exact no-op. So the host can enqueue K cycles
// with no synchronisation and read st once (the `lax.while_loop`
// counterpart).
//
// Why not one launch, as on the TPU: the TPU ran the cycle as grid=(1,) (or a
// sequential grid with an SMEM carry). Hopper blocks run in no order, so
// the incumbent folded over all leaves before any keep test is a launch
// boundary, and the emit, which writes over popped rows, reads its parents
// from launch 1's stash.
//
// What bounds it on an H100: at M = 49152 (ta014, n = 20, m = 10) a full
// cycle must move the popped rows (21 B a row at int8) and the survivor
// rows, about 4 MB, 1.3 us at 3.35 TB/s. It takes about 30x that: the
// bounds launch is bound by the instructions it issues (the per-child
// m-step chain and the parents' prologues) and by each block's chain of
// dependent loads and barriers, and each launch pays a few microseconds of
// fixed cost. What the design does, against the four-launch version it
// replaces (measured in PERF.md, section 6):
//   - no scan launch: the count launch publishes one count a block, and
//     each emit block sums its predecessors' counts with 16-byte loads that
//     go out beside its stash loads (a ticket for a last-block scan,
//     measured, cost more than the launch it saved: a fence and an atomic
//     in every block);
//   - one keep mask a parent: the emit reads neither the plane nor the
//     slot flags again, and no slot loop divides by n (the split of a
//     thread's first slot and of its stride is taken once);
//   - the pop and the survivor span move as aligned 16-byte words, the
//     span built in shared memory in rank order;
//   - the parent prologue: the remaining work is the machine's total over
//     all jobs less what the front scheduled (the row is a permutation), so
//     no pass over the unscheduled positions; when the grid fits on the
//     card at once the front is a wavefront over the machines (l1 + m
//     steps, one lane a machine), else one thread a parent, which issues
//     the fewest instructions, with each parent's front at an odd
//     shared-memory stride so 32 parents fall on 32 banks;
//   - blocks of 128 threads that loop over their slots when one thread a
//     slot would not fit on the card at once, so the grid is one or two
//     waves, not four.
#include "cycle_pfsp.cuh"

// Threads of a bounds block (32 parents) that loops over its slots, when
// one thread a slot does not fit on the card at once.
#define TTS_LB1_LOOP_THREADS 128

// Launch 1: loop condition, pop, bounds, leaf fold.
template <typename T>
__global__ void cycle_bounds(const T* __restrict__ pool_vals,
                             const T* __restrict__ pool_aux, int* st,
                             uint8_t* __restrict__ stash,
                             T* __restrict__ chunk_aux, int* __restrict__ lb,
                             const int* __restrict__ ptm_t,
                             const int* __restrict__ heads,
                             const int* __restrict__ tails, int n, int m,
                             int M, int C, int mterm, int K,
                             bool lane_prologue) {
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

// Launches 2-3 (count, emit) are `launch_pfsp_cycle_tail` of
// cycle_pfsp.cuh, shared with the lb2 cycle.

template <typename T>
static int launch_cycle(void* pool_vals, void* pool_aux, void* st,
                        void* chunk_vals, void* chunk_aux, void* lb,
                        void* blkcnt, const void* ptm_t,
                        const void* heads, const void* tails, int n, int m,
                        int M, int C, int mterm, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int PB = TTS_CYCLE_PARENTS;
  const int nblk = (M + PB - 1) / PB;
  const int threads = tts_cycle_threads(nblk, PB * n, TTS_LB1_LOOP_THREADS);
  // The stash region, then ptm (n*m), heads and tails (m), front and
  // remain (PB at an odd stride m | 1), and the column sums (m).
  const size_t smem = pfsp_stash_block_bytes<T>(n) +
                      sizeof(int) * (static_cast<size_t>(n) * m + 2 * m +
                                     2 * PB * (m | 1) + m);
  int err = tts_smem_optin(cycle_bounds<T>, smem);
  if (err) return err;
  int* st_i = static_cast<int*>(st);
  cycle_bounds<T><<<nblk, threads, smem, s>>>(
      static_cast<const T*>(pool_vals), static_cast<const T*>(pool_aux), st_i,
      static_cast<uint8_t*>(chunk_vals), static_cast<T*>(chunk_aux),
      static_cast<int*>(lb), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int*>(tails), n, m, M,
      C, mterm, K, threads < tts_threads_for(PB * n));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_pfsp_cycle_tail<T>(pool_vals, pool_aux, st_i, chunk_vals,
                                   chunk_aux, static_cast<int*>(lb), blkcnt, n,
                                   M, s);
}

#define TTS_CYCLE_ENTRY(NAME, T)                                             \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,            \
                      void* chunk_vals, void* chunk_aux, void* lb,          \
                      void* blkcnt, const void* ptm_t,        \
                      const void* heads, const void* tails, int n, int m,   \
                      int M, int C, int mterm, int K, void* stream) {       \
    return launch_cycle<T>(pool_vals, pool_aux, st, chunk_vals, chunk_aux,  \
                           lb, blkcnt, ptm_t, heads, tails, n, m, M, \
                           C, mterm, K, stream);                            \
  }

TTS_CYCLE_ENTRY(cycle_lb1_i8, int8_t)
TTS_CYCLE_ENTRY(cycle_lb1_i32, int32_t)
