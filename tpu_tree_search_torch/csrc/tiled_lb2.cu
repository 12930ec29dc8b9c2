// Kernel 11: one streamed (tiled) device-resident PFSP lb2 search cycle on
// the pool.
//
// Replaces the TPU kernel `_mega_lb2_tiled_kernel`
// (tpu_tree_search/ops/megakernel.py, built by `_lb2_tiled_call`; wired by
// the tiled lb2 branch of `make_cycle` and the stitch of
// `engine/resident.py`).
//
// It is kernel 9 (tiled_lb1.cu, whose header note gives the two launches
// and the carry) with the sweep computing lb2 instead of lb1 into the
// (M*n) int32 stash: the Johnson tables in shared memory and the per-child
// recurrence of lb2_common.cuh, in groups of TTS_PARENTS_PER_BLOCK parents
// of the block's tile. The emit launch is tiled_pfsp.cuh's, shared with
// kernel 9; its keep test is the unstaged one, as in kernel 8 and the JAX
// megakernel.
//
// What bounds it on an H100: the operations of the sweep, the Johnson
// recurrence over P*n ordered slots for each child slot, as in kernels 6
// and 8; the bytes moved are kernel 9's. A block's shared memory is
// kernel 8's (the tables and one group's fronts and positions), whatever
// the tile width.
#include "lb2_common.cuh"
#include "tiled_pfsp.cuh"

// lb2 of every child slot of the rows [0, rows) of one tile into
// plane[i*n + k], as `lb1_tile` of tiled_lb1.cu: groups of
// TTS_PARENTS_PER_BLOCK parents, rows outside [vlo, vhi) get INF, and the
// return value is this thread's leaf minimum.
template <typename T>
__device__ int lb2_tile(const T* __restrict__ vals, const T* __restrict__ aux,
                        int rows, int vlo, int vhi, int* __restrict__ plane,
                        const Lb2Smem& s, int n, int m, int P) {
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int t = threadIdx.x;
  int leafmin = TTS_INF_BOUND;
  for (int g0 = 0; g0 < rows; g0 += PB) {
    const int gr = min(PB, rows - g0);
    if (t < gr && g0 + t >= vlo && g0 + t < vhi) {
      const int i = g0 + t;
      lb2_parent_state(vals + static_cast<size_t>(i) * n,
                       static_cast<int>(aux[i]), n, m, s, s.front + t * m,
                       s.pos + t * n);
    }
    __syncthreads();
    for (int slot = t; slot < gr * n; slot += blockDim.x) {
      const int p = slot / n;
      const int k = slot - p * n;
      const int i = g0 + p;
      int v = TTS_INF_BOUND;
      if (i >= vlo && i < vhi) {
        const int l1 = static_cast<int>(aux[i]);
        v = lb2_child(vals + static_cast<size_t>(i) * n, k, l1, n, m, P, s,
                      s.front + p * m, s.pos + p * n);
        if (k >= l1 + 1 && l1 + 2 == n) leafmin = min(leafmin, v);
      }
      plane[static_cast<size_t>(g0) * n + slot] = v;
    }
    __syncthreads();  // the next group reuses the fronts and positions
  }
  return leafmin;
}

// Launch 1: loop condition, pop, the tile's lb2 into the stash, leaf fold.
template <typename T>
__global__ void tiled_lb2_sweep(const T* __restrict__ pool_vals,
                                const T* __restrict__ pool_aux, int* st,
                                T* __restrict__ chunk_vals,
                                T* __restrict__ chunk_aux,
                                int* __restrict__ lb,
                                unsigned long long* __restrict__ status,
                                int* __restrict__ ticket,
                                const int* __restrict__ ptm_t,
                                const int* __restrict__ heads,
                                const int4* __restrict__ pairinfo,
                                const short4* __restrict__ tab, int n, int m,
                                int P, int M, int mt, int C, int mterm,
                                int K) {
  int start, size, start2;
  if (!tile_cycle_pop(pool_vals, pool_aux, st, chunk_vals, chunk_aux, status,
                      ticket, n, M, mt, C, mterm, K, &start, &size, &start2))
    return;
  extern __shared__ __align__(16) unsigned char lb2_smem[];
  __shared__ int s_leafmin;
  const int PB = TTS_PARENTS_PER_BLOCK;
  const Lb2Smem s = lb2_smem_layout(lb2_smem, n, m, P, PB, blockDim.x);
  lb2_load_tables(s, ptm_t, heads, pairinfo, tab, n, m, P);
  if (threadIdx.x == 0) s_leafmin = TTS_INF_BOUND;
  __syncthreads();  // the tables are in shared memory
  const int r0 = start2 + blockIdx.x * mt;  // pool row of the tile's first
  const int leafmin = lb2_tile(
      pool_vals + static_cast<size_t>(r0) * n, pool_aux + r0, mt, start - r0,
      size - r0, lb + static_cast<size_t>(blockIdx.x) * mt * n, s, n, m, P);
  pfsp_fold_leaves(leafmin, &s_leafmin, st);
}

static inline int tiled_lb2_threads(int n) {
  const int t = tts_threads_for(TTS_PARENTS_PER_BLOCK * n);
  return t < TTS_LB2_THREADS ? t : TTS_LB2_THREADS;
}

// Dynamic shared memory of one sweep block at this shape (the
// wrapper refuses a shape above the opt-in limit).
extern "C" long long tiled_lb2_smem(int n, int m, int P) {
  return static_cast<long long>(tts_lb2_smem_bytes(
      n, m, P, TTS_PARENTS_PER_BLOCK, tiled_lb2_threads(n),
      TTS_PARENTS_PER_BLOCK));
}

template <typename T>
static int launch_tiled_lb2(void* pool_vals, void* pool_aux, void* st,
                            void* chunk_vals, void* chunk_aux, void* lb,
                            void* status, void* ticket, void* scal,
                            const void* ptm_t, const void* heads,
                            const void* pairinfo, const void* tab, int n,
                            int m, int P, int M, int mt, int C, int mterm,
                            int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(tiled_lb2_smem(n, m, P));
  int err = tts_smem_optin(tiled_lb2_sweep<T>, smem);
  if (err) return err;
  int* st_i = static_cast<int*>(st);
  tiled_lb2_sweep<T><<<M / mt, tiled_lb2_threads(n), smem, s>>>(
      static_cast<const T*>(pool_vals), static_cast<const T*>(pool_aux), st_i,
      static_cast<T*>(chunk_vals), static_cast<T*>(chunk_aux),
      static_cast<int*>(lb), static_cast<unsigned long long*>(status),
      static_cast<int*>(ticket), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int4*>(pairinfo),
      static_cast<const short4*>(tab), n, m, P, M, mt, C, mterm, K);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_tiled_pfsp_emit<T>(pool_vals, pool_aux, st_i, chunk_vals,
                                   chunk_aux, static_cast<const int*>(lb),
                                   status, ticket, scal, n, M, mt, s);
}

#define TTS_TILED_LB2_ENTRY(NAME, T)                                         \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,            \
                      void* chunk_vals, void* chunk_aux, void* lb,          \
                      void* status, void* ticket, void* scal,               \
                      const void* ptm_t, const void* heads,                 \
                      const void* pairinfo, const void* tab, int n, int m,  \
                      int P, int M, int mt, int C, int mterm, int K,        \
                      void* stream) {                                       \
    return launch_tiled_lb2<T>(pool_vals, pool_aux, st, chunk_vals,         \
                               chunk_aux, lb, status, ticket, scal, ptm_t,  \
                               heads, pairinfo, tab, n, m, P, M, mt, C,     \
                               mterm, K, stream);                           \
  }

TTS_TILED_LB2_ENTRY(tiled_lb2_i8, int8_t)
TTS_TILED_LB2_ENTRY(tiled_lb2_i32, int32_t)
