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
// One cycle is four launches on the caller's stream:
//   1. bounds: evaluate the loop condition of `resident.py:421-423`
//      (size >= m, size + M*n <= C, cycles < K) from st; pop the back
//      cnt = min(size, M) rows (start2 = clip(size - cnt, 0, C - M), the
//      valid window of `resident.py:228-236`) into a stash; lb1 of every
//      child slot into an (M*n) int32 plane; leaf makespans folded into
//      st[1] with atomicMin (so the keep test sees the final incumbent);
//   2. count: keep = open & ~leaf & lb < best and leaves, per block;
//   3. scan (one block): exclusive scan of the block keep counts, then
//      size = size - cnt + tree_inc, tree += tree_inc, sol += sol_inc,
//      cycles += 1;
//   4. emit: each block ranks its keeps with a block scan and writes each
//      survivor (parent row with positions limit1+1 and k swapped, and
//      limit1 + 1) at base + block offset + rank: the survivors land at the
//      pool's size in exact (parent, slot) order, as the dense compaction
//      of the JAX engine leaves them.
// When the condition is false, launch 1 clears st[5] and every launch of the
// cycle returns at once: an exact no-op. So the host can enqueue K cycles
// with no synchronisation and read st once (the `lax.while_loop`
// counterpart).
//
// Why not one launch, as on the TPU: the TPU ran the cycle as grid=(1,) (or a
// sequential grid with an SMEM carry). Hopper blocks run in no order, so
// the two cross-block dependencies (the incumbent folded over all leaves
// before any keep test; survivor offsets across blocks) are launch
// boundaries here.
//
// What bounds it on an H100: launch latency at small M (four launches of a
// few microseconds each); at M = 49152 the bytes of the pool rows read and
// survivor rows written (20 B a row at ta014) and the lb plane (4 B a slot,
// written once and read twice).
#include "cycle_pfsp.cuh"

// Launch 1: loop condition, pop, bounds, leaf fold.
template <typename T>
__global__ void cycle_bounds(const T* __restrict__ pool_vals,
                             const T* __restrict__ pool_aux, int* st,
                             T* __restrict__ chunk_vals,
                             T* __restrict__ chunk_aux, int* __restrict__ lb,
                             const int* __restrict__ ptm_t,
                             const int* __restrict__ heads,
                             const int* __restrict__ tails, int n, int m,
                             int M, int C, int mterm, int K) {
  int start, size, start2;
  if (!pfsp_cycle_pop(pool_vals, pool_aux, st, chunk_vals, chunk_aux, n, M,
                      C, mterm, K, &start, &size, &start2))
    return;

  extern __shared__ int smem[];
  __shared__ int s_leafmin;
  const Lb1Smem s = lb1_smem_layout(smem, n, m);
  lb1_load_tables(s, ptm_t, heads, tails, n, m);
  if (threadIdx.x == 0) s_leafmin = TTS_INF_BOUND;
  __syncthreads();  // the tables are in shared memory

  const int PB = TTS_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const int t = threadIdx.x;
  if (t < rows) {
    const int row = start2 + i0 + t;
    if (row >= start && row < size) {
      lb1_parent_state(pool_vals + static_cast<size_t>(row) * n,
                       static_cast<int>(pool_aux[row]), n, m, s,
                       s.front + t * m, s.remain + t * m);
    }
  }
  __syncthreads();

  int leafmin = TTS_INF_BOUND;
  for (int slot = t; slot < rows * n; slot += blockDim.x) {
    const int p = slot / n;
    const int k = slot - p * n;
    const int row = start2 + i0 + p;
    int v = TTS_INF_BOUND;
    if (row >= start && row < size) {
      const int l1 = static_cast<int>(pool_aux[row]);
      v = lb1_child(pool_vals + static_cast<size_t>(row) * n, k, m, s,
                    s.front + p * m, s.remain + p * m);
      if (k >= l1 + 1 && l1 + 2 == n) leafmin = min(leafmin, v);
    }
    lb[static_cast<size_t>(i0) * n + slot] = v;
  }
  pfsp_fold_leaves(leafmin, &s_leafmin, st);
}

// Launches 2-4 (count, scan, emit) are `launch_pfsp_cycle_tail` of
// cycle_pfsp.cuh, shared with the lb2 cycle.

template <typename T>
static int launch_cycle(void* pool_vals, void* pool_aux, void* st,
                        void* chunk_vals, void* chunk_aux, void* lb,
                        void* blkcnt, void* blkoff, const void* ptm_t,
                        const void* heads, const void* tails, int n, int m,
                        int M, int C, int mterm, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int nblk = (M + PB - 1) / PB;
  const int threads = tts_threads_for(PB * n);
  const size_t smem = tts_lb1_smem_bytes(n, m);
  int err = tts_smem_optin(cycle_bounds<T>, smem);
  if (err) return err;
  int* st_i = static_cast<int*>(st);
  cycle_bounds<T><<<nblk, threads, smem, s>>>(
      static_cast<const T*>(pool_vals), static_cast<const T*>(pool_aux), st_i,
      static_cast<T*>(chunk_vals), static_cast<T*>(chunk_aux),
      static_cast<int*>(lb), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int*>(tails), n, m, M,
      C, mterm, K);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_pfsp_cycle_tail<T>(pool_vals, pool_aux, st_i, chunk_vals,
                                   chunk_aux, static_cast<const int*>(lb),
                                   blkcnt, blkoff, n, M, s);
}

#define TTS_CYCLE_ENTRY(NAME, T)                                             \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,            \
                      void* chunk_vals, void* chunk_aux, void* lb,          \
                      void* blkcnt, void* blkoff, const void* ptm_t,        \
                      const void* heads, const void* tails, int n, int m,   \
                      int M, int C, int mterm, int K, void* stream) {       \
    return launch_cycle<T>(pool_vals, pool_aux, st, chunk_vals, chunk_aux,  \
                           lb, blkcnt, blkoff, ptm_t, heads, tails, n, m, M, \
                           C, mterm, K, stream);                            \
  }

TTS_CYCLE_ENTRY(cycle_lb1_i8, int8_t)
TTS_CYCLE_ENTRY(cycle_lb1_i32, int32_t)
