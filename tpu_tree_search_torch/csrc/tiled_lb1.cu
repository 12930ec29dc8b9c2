// Kernel 9b (`chip_smoke.py` phase `kernel9`): one streamed (tiled)
// device-resident PFSP lb1 search cycle on the pool.
//
// Replaces the TPU kernel `_mega_lb1_tiled_kernel`
// (tpu_tree_search/ops/megakernel.py, built by `_lb1_tiled_call`, grid
// (2, G) over G = M / Mt pool tiles with an SMEM carry; wired by the tiled
// lb1 branch of `make_cycle` and the stitch of `engine/resident.py`).
//
// It computes what kernel 2 (cycle_lb1.cu) computes, with the popped chunk
// cut into G tiles of Mt parents, one block a tile, and the survivors of
// each tile placed by a carry across tiles: the same pool and state after
// the cycle. One cycle is two launches on the caller's stream:
//   1. sweep (the TPU's phase 0): the loop condition and the pop
//      (tiled_common.cuh `tile_cycle_pop`); the block's Mt parents bounded
//      into its (Mt, n) slice of the (M*n) int32 stash, in groups of
//      TTS_PARENTS_PER_BLOCK parents (lb1_common.cuh); its leaf minimum
//      folded into st[1] with atomicMin. The launch boundary is the TPU's
//      phase 0 -> phase 1 boundary: no tile prunes before every leaf of
//      every tile is folded.
//   2. emit (phase 1, tiled_pfsp.cuh): keep = open & ~leaf & lb < best
//      against the final incumbent, read back from the stash; the tile's
//      ranks, the decoupled look-back of tiled_common.cuh for its offset and
//      cumulative solution count, the child rows written at
//      base + offs[t] + rank, the (G, 4) per-tile scalars and, from the last
//      tile, the state update.
// When the condition is false every launch returns at once, as in kernel 2,
// so K cycles go to the stream with no host synchronisation.
//
// What bounds it on an H100: the same bytes as kernel 2 (the pool rows read
// and the survivor rows written, the stash written once and read twice).
// One block a tile keeps G blocks in flight (768 at M = 49152, Mt = 64 on
// 132 SMs), each looping over Mt / 8 groups; a TPU-sized tile (the JAX
// resolver's Mt = 12288, G = 4) would leave the card nearly idle. The
// look-back is serial in one thread a block, and costs most where the tiles
// are many and small.
#include "lb1_common.cuh"
#include "tiled_pfsp.cuh"

// lb1 of every child slot of the rows [0, rows) of one tile (row i at
// vals + i*n, its limit1 at aux[i]) into plane[i*n + k], in groups of
// TTS_PARENTS_PER_BLOCK parents: the group's parent prologues run one a
// thread, then every thread runs child slots. Rows outside [vlo, vhi) are
// not bounded and get INF. Returns this thread's minimum over the leaf
// slots (open, limit1 == n - 2).
template <typename T>
__device__ int lb1_tile(const T* __restrict__ vals, const T* __restrict__ aux,
                        int rows, int vlo, int vhi, int* __restrict__ plane,
                        const Lb1Smem& s, int n, int m) {
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int t = threadIdx.x;
  int leafmin = TTS_INF_BOUND;
  for (int g0 = 0; g0 < rows; g0 += PB) {
    const int gr = min(PB, rows - g0);
    if (t < gr && g0 + t >= vlo && g0 + t < vhi) {
      const int i = g0 + t;
      lb1_parent_state(vals + static_cast<size_t>(i) * n,
                       static_cast<int>(aux[i]), n, m, s, s.front + t * m,
                       s.remain + t * m);
    }
    __syncthreads();
    for (int slot = t; slot < gr * n; slot += blockDim.x) {
      const int p = slot / n;
      const int k = slot - p * n;
      const int i = g0 + p;
      int v = TTS_INF_BOUND;
      if (i >= vlo && i < vhi) {
        const int l1 = static_cast<int>(aux[i]);
        v = lb1_child(vals + static_cast<size_t>(i) * n, k, m, s,
                      s.front + p * m, s.remain + p * m);
        if (k >= l1 + 1 && l1 + 2 == n) leafmin = min(leafmin, v);
      }
      plane[static_cast<size_t>(g0) * n + slot] = v;
    }
    __syncthreads();  // the next group reuses the fronts
  }
  return leafmin;
}

// Launch 1: loop condition, pop, the tile's lb1 into the stash, leaf fold.
template <typename T>
__global__ void tiled_lb1_sweep(const T* __restrict__ pool_vals,
                                const T* __restrict__ pool_aux, int* st,
                                T* __restrict__ chunk_vals,
                                T* __restrict__ chunk_aux,
                                int* __restrict__ lb,
                                unsigned long long* __restrict__ status,
                                int* __restrict__ ticket,
                                const int* __restrict__ ptm_t,
                                const int* __restrict__ heads,
                                const int* __restrict__ tails, int n, int m,
                                int M, int mt, int C, int mterm, int K) {
  int start, size, start2;
  if (!tile_cycle_pop(pool_vals, pool_aux, st, chunk_vals, chunk_aux, status,
                      ticket, n, M, mt, C, mterm, K, &start, &size, &start2))
    return;
  extern __shared__ int smem[];
  __shared__ int s_leafmin;
  const Lb1Smem s = lb1_smem_layout(smem, n, m);
  lb1_load_tables(s, ptm_t, heads, tails, n, m);
  if (threadIdx.x == 0) s_leafmin = TTS_INF_BOUND;
  __syncthreads();  // the tables are in shared memory
  const int r0 = start2 + blockIdx.x * mt;  // pool row of the tile's first
  const int leafmin = lb1_tile(
      pool_vals + static_cast<size_t>(r0) * n, pool_aux + r0, mt, start - r0,
      size - r0, lb + static_cast<size_t>(blockIdx.x) * mt * n, s, n, m);
  pfsp_fold_leaves(leafmin, &s_leafmin, st);
}

template <typename T>
static int launch_tiled_lb1(void* pool_vals, void* pool_aux, void* st,
                            void* chunk_vals, void* chunk_aux, void* lb,
                            void* status, void* ticket, void* scal,
                            const void* ptm_t, const void* heads,
                            const void* tails, int n, int m, int M, int mt,
                            int C, int mterm, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = tts_lb1_smem_bytes(n, m);
  int err = tts_smem_optin(tiled_lb1_sweep<T>, smem);
  if (err) return err;
  int* st_i = static_cast<int*>(st);
  tiled_lb1_sweep<T><<<M / mt, tts_threads_for(TTS_PARENTS_PER_BLOCK * n),
                       smem, s>>>(
      static_cast<const T*>(pool_vals), static_cast<const T*>(pool_aux), st_i,
      static_cast<T*>(chunk_vals), static_cast<T*>(chunk_aux),
      static_cast<int*>(lb), static_cast<unsigned long long*>(status),
      static_cast<int*>(ticket), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int*>(tails), n, m, M,
      mt, C, mterm, K);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_tiled_pfsp_emit<T>(pool_vals, pool_aux, st_i, chunk_vals,
                                   chunk_aux, static_cast<const int*>(lb),
                                   status, ticket, scal, n, M, mt, s);
}

#define TTS_TILED_LB1_ENTRY(NAME, T)                                        \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,           \
                      void* chunk_vals, void* chunk_aux, void* lb,         \
                      void* status, void* ticket, void* scal,              \
                      const void* ptm_t, const void* heads,                \
                      const void* tails, int n, int m, int M, int mt,      \
                      int C, int mterm, int K, void* stream) {             \
    return launch_tiled_lb1<T>(pool_vals, pool_aux, st, chunk_vals,        \
                               chunk_aux, lb, status, ticket, scal, ptm_t, \
                               heads, tails, n, m, M, mt, C, mterm, K,     \
                               stream);                                    \
  }

TTS_TILED_LB1_ENTRY(tiled_lb1_i8, int8_t)
TTS_TILED_LB1_ENTRY(tiled_lb1_i32, int32_t)
