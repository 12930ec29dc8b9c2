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
#include "cycle_common.cuh"
#include "lb1_common.cuh"

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
  const int size = st[ST_SIZE];
  const int cycles = st[ST_CYCLES];
  const bool active = size >= mterm &&
                      static_cast<long long>(size) +
                              static_cast<long long>(M) * n <=
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

  extern __shared__ int smem[];
  __shared__ int s_leafmin;
  const Lb1Smem s = lb1_smem_layout(smem, n, m);
  lb1_load_tables(s, ptm_t, heads, tails, n, m);
  if (threadIdx.x == 0) s_leafmin = TTS_INF_BOUND;

  const int PB = TTS_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  // The pop: stash this block's M-window rows (the emit of launch 4 writes
  // survivors over the popped region, so it reads parents from the stash).
  const T* src = pool_vals + static_cast<size_t>(start2 + i0) * n;
  T* dst = chunk_vals + static_cast<size_t>(i0) * n;
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) dst[e] = src[e];
  for (int e = threadIdx.x; e < rows; e += blockDim.x)
    chunk_aux[i0 + e] = pool_aux[start2 + i0 + e];
  __syncthreads();  // the tables are in shared memory

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
  if (leafmin < TTS_INF_BOUND) atomicMin(&s_leafmin, leafmin);
  __syncthreads();
  if (threadIdx.x == 0 && s_leafmin < TTS_INF_BOUND)
    atomicMin(&st[ST_BEST], s_leafmin);
}

// keep / leaf flags of slot (p, k) of the popped chunk.
template <typename T>
__device__ __forceinline__ void slot_flags(const T* chunk_aux, const int* lb,
                                           int i, int k, int n, int best,
                                           bool* keep, bool* leaf) {
  const int l1 = static_cast<int>(chunk_aux[i]);
  const bool open = k >= l1 + 1;
  *leaf = open && (l1 + 2 == n);
  *keep = open && !*leaf && lb[static_cast<size_t>(i) * n + k] < best;
}

// Launch 2: per-block survivor and leaf counts.
template <typename T>
__global__ void cycle_count(const int* st, const T* __restrict__ chunk_aux,
                            const int* __restrict__ lb,
                            int* __restrict__ blkcnt, int n, int M) {
  if (!st[ST_ACTIVE]) return;
  const int best = st[ST_BEST];
  const int size = st[ST_SIZE];
  const int cnt = st[ST_CNT];
  const int start2 = st[ST_START2];
  const int start = size - cnt;
  __shared__ int s_keep, s_leaf;
  if (threadIdx.x == 0) {
    s_keep = 0;
    s_leaf = 0;
  }
  __syncthreads();
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  int keeps = 0, leaves = 0;
  for (int slot = threadIdx.x; slot < rows * n; slot += blockDim.x) {
    const int p = slot / n;
    const int i = i0 + p;
    const int row = start2 + i;
    if (row < start || row >= size) continue;
    bool keep, leaf;
    slot_flags(chunk_aux, lb, i, slot - p * n, n, best, &keep, &leaf);
    keeps += keep;
    leaves += leaf;
  }
  if (keeps) atomicAdd(&s_keep, keeps);
  if (leaves) atomicAdd(&s_leaf, leaves);
  __syncthreads();
  if (threadIdx.x == 0) {
    blkcnt[2 * blockIdx.x] = s_keep;
    blkcnt[2 * blockIdx.x + 1] = s_leaf;
  }
}

// Launch 3 (one block) is `cycle_scan` of cycle_common.cuh: block offsets
// and the cycle's scalar update.

// Launch 4: rank the block's survivors and write the child rows.
template <typename T>
__global__ void cycle_emit(T* __restrict__ pool_vals,
                           T* __restrict__ pool_aux, const int* st,
                           const T* __restrict__ chunk_vals,
                           const T* __restrict__ chunk_aux,
                           const int* __restrict__ lb,
                           const int* __restrict__ blkoff, int n, int M) {
  if (!st[ST_ACTIVE]) return;
  __shared__ int s_warp[32];
  const int best = st[ST_BEST];
  const int cnt = st[ST_CNT];
  const int start2 = st[ST_START2];
  const int base = st[ST_BASE];  // == the pre-pop size minus cnt
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int i0 = blockIdx.x * PB;
  const int slots = min(PB, M - i0) * n;
  // Each thread owns a contiguous run of slots, so the block scan of the
  // per-thread counts keeps (parent, slot) order.
  const int per = (slots + blockDim.x - 1) / blockDim.x;
  const int lo = min(slots, static_cast<int>(threadIdx.x) * per);
  const int hi = min(slots, lo + per);
  int keeps = 0;
  for (int slot = lo; slot < hi; ++slot) {
    const int p = slot / n;
    const int row = start2 + i0 + p;
    if (row < base || row >= base + cnt) continue;
    bool keep, leaf;
    slot_flags(chunk_aux, lb, i0 + p, slot - p * n, n, best, &keep, &leaf);
    keeps += keep;
  }
  int total;
  int dst = base + blkoff[blockIdx.x] +
            block_exclusive_scan(keeps, s_warp, &total);
  for (int slot = lo; slot < hi && keeps > 0; ++slot) {
    const int p = slot / n;
    const int k = slot - p * n;
    const int i = i0 + p;
    const int row = start2 + i;
    if (row < base || row >= base + cnt) continue;
    bool keep, leaf;
    slot_flags(chunk_aux, lb, i, k, n, best, &keep, &leaf);
    if (!keep) continue;
    const int d = static_cast<int>(chunk_aux[i]) + 1;
    const T* parent = chunk_vals + static_cast<size_t>(i) * n;
    T* child = pool_vals + static_cast<size_t>(dst) * n;
    for (int j = 0; j < n; ++j) {
      child[j] = j == d ? parent[k] : (j == k ? parent[d] : parent[j]);
    }
    pool_aux[dst] = static_cast<T>(d);
    ++dst;
    --keeps;
  }
}

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
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(cycle_bounds<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  int* st_i = static_cast<int*>(st);
  cycle_bounds<T><<<nblk, threads, smem, s>>>(
      static_cast<const T*>(pool_vals), static_cast<const T*>(pool_aux), st_i,
      static_cast<T*>(chunk_vals), static_cast<T*>(chunk_aux),
      static_cast<int*>(lb), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int*>(tails), n, m, M,
      C, mterm, K);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  cycle_count<T><<<nblk, threads, 0, s>>>(
      st_i, static_cast<const T*>(chunk_aux), static_cast<const int*>(lb),
      static_cast<int*>(blkcnt), n, M);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  cycle_scan<<<1, 1024, 0, s>>>(st_i, static_cast<const int*>(blkcnt),
                                static_cast<int*>(blkoff), nblk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  cycle_emit<T><<<nblk, threads, 0, s>>>(
      static_cast<T*>(pool_vals), static_cast<T*>(pool_aux), st_i,
      static_cast<const T*>(chunk_vals), static_cast<const T*>(chunk_aux),
      static_cast<const int*>(lb), static_cast<const int*>(blkoff), n, M);
  return static_cast<int>(cudaGetLastError());
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
