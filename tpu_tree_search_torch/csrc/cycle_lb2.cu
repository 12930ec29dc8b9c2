// Kernel 8: one whole device-resident PFSP lb2 search cycle on the pool.
//
// Replaces the TPU kernel `_mega_lb2_kernel` (tpu_tree_search/ops/megakernel.py,
// built by `_lb2_cycle_call`, with the epilogue `_pfsp_epilogue` and the
// in-VMEM compaction `_compact_push`; wired by the lb2 branch of
// `make_cycle`), together with the engine steps around it in
// `engine/resident.py` `loop_fns`: the loop condition, the pop, and the
// write of the survivors back into the pool.
//
// It is kernel 2 (cycle_lb1.cu, whose header note gives the state layout
// and the launch sequence) with launch 1 computing lb2 instead of lb1 into
// the (M*n) int32 plane: the loop condition, the pop and the leaf fold of
// launch 1, and launches 2-3 (count, emit), are the shared code of
// cycle_pfsp.cuh. Launch 1 keeps its eight parents a
// block; its pop writes each row, one element a thread, where the emit's
// 32-parent blocks read it (`pfsp_stash_row`). The keep test is the
// unstaged one, open & ~leaf & lb2 < best, as in the JAX megakernel
// (`make_cycle`'s note: it equals the staged keep, since lb2 >= lb1). A
// leaf child has no free job, so its lb2 is its makespan, which the fold
// takes into the incumbent.
//
// What bounds it on an H100: the operations of launch 1, the Johnson
// recurrence over P*n ordered slots for each child slot (kernel 6's loop,
// lb2_common.cuh); the bytes moved are kernel 2's.
#include "cycle_pfsp.cuh"
#include "lb2_common.cuh"

// Launch 1: loop condition, pop, lb2 bounds, leaf fold.
template <typename T>
__global__ void lb2_cycle_bounds(const T* __restrict__ pool_vals,
                                 const T* __restrict__ pool_aux, int* st,
                                 uint8_t* __restrict__ stash,
                                 T* __restrict__ chunk_aux,
                                 int* __restrict__ lb,
                                 const int* __restrict__ ptm_t,
                                 const int* __restrict__ heads,
                                 const int4* __restrict__ pairinfo,
                                 const short4* __restrict__ tab, int n, int m,
                                 int P, int M, int C, int mterm, int K) {
  int start, size, start2;
  if (!pfsp_cycle_begin(st, n, M, C, mterm, K, &start, &size, &start2))
    return;

  extern __shared__ __align__(16) unsigned char lb2_smem[];
  __shared__ int s_leafmin;
  const int PB = TTS_PARENTS_PER_BLOCK;
  const Lb2Smem s = lb2_smem_layout(lb2_smem, n, m, P, PB, blockDim.x);
  lb2_load_tables(s, ptm_t, heads, pairinfo, tab, n, m, P);
  if (threadIdx.x == 0) s_leafmin = TTS_INF_BOUND;
  __syncthreads();  // the tables are in shared memory

  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  const int t = threadIdx.x;
  pfsp_stash_pop(pool_vals, pool_aux, stash, chunk_aux, start2, i0, rows, n);
  if (t < rows) {
    const int row = start2 + i0 + t;
    if (row >= start && row < size) {
      lb2_parent_state(pool_vals + static_cast<size_t>(row) * n,
                       static_cast<int>(pool_aux[row]), n, m, s,
                       s.front + t * m, s.pos + t * n);
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
      v = lb2_child(pool_vals + static_cast<size_t>(row) * n, k, l1, n, m, P,
                    s, s.front + p * m, s.pos + p * n);
      if (k >= l1 + 1 && l1 + 2 == n) leafmin = min(leafmin, v);
    }
    lb[static_cast<size_t>(i0) * n + slot] = v;
  }
  pfsp_fold_leaves(leafmin, &s_leafmin, st);
}

static inline int lb2_cycle_threads(int n) {
  const int t = tts_threads_for(TTS_PARENTS_PER_BLOCK * n);
  return t < TTS_LB2_THREADS ? t : TTS_LB2_THREADS;
}

// Dynamic shared memory of one launch-1 block at this shape (the wrapper
// refuses a shape above the opt-in limit).
extern "C" long long cycle_lb2_smem(int n, int m, int P) {
  return static_cast<long long>(tts_lb2_smem_bytes(
      n, m, P, TTS_PARENTS_PER_BLOCK, lb2_cycle_threads(n),
      TTS_PARENTS_PER_BLOCK));
}

template <typename T>
static int launch_cycle_lb2(void* pool_vals, void* pool_aux, void* st,
                            void* chunk_vals, void* chunk_aux, void* lb,
                            void* blkcnt, const void* ptm_t,
                            const void* heads, const void* pairinfo,
                            const void* tab, int n, int m, int P, int M,
                            int C, int mterm, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int PB = TTS_PARENTS_PER_BLOCK;
  const int nblk = (M + PB - 1) / PB;
  const size_t smem = static_cast<size_t>(cycle_lb2_smem(n, m, P));
  int err = tts_smem_optin(lb2_cycle_bounds<T>, smem);
  if (err) return err;
  int* st_i = static_cast<int*>(st);
  lb2_cycle_bounds<T><<<nblk, lb2_cycle_threads(n), smem, s>>>(
      static_cast<const T*>(pool_vals), static_cast<const T*>(pool_aux), st_i,
      static_cast<uint8_t*>(chunk_vals), static_cast<T*>(chunk_aux),
      static_cast<int*>(lb), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int4*>(pairinfo),
      static_cast<const short4*>(tab), n, m, P, M, C, mterm, K);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_pfsp_cycle_tail<T>(pool_vals, pool_aux, st_i, chunk_vals,
                                   chunk_aux, static_cast<int*>(lb),
                                   blkcnt, n, M, s);
}

#define TTS_CYCLE_LB2_ENTRY(NAME, T)                                          \
  extern "C" int NAME(void* pool_vals, void* pool_aux, void* st,             \
                      void* chunk_vals, void* chunk_aux, void* lb,           \
                      void* blkcnt, const void* ptm_t,         \
                      const void* heads, const void* pairinfo,               \
                      const void* tab, int n, int m, int P, int M, int C,    \
                      int mterm, int K, void* stream) {                      \
    return launch_cycle_lb2<T>(pool_vals, pool_aux, st, chunk_vals,          \
                               chunk_aux, lb, blkcnt, ptm_t, heads,  \
                               pairinfo, tab, n, m, P, M, C, mterm, K,       \
                               stream);                                      \
  }

TTS_CYCLE_LB2_ENTRY(cycle_lb2_i8, int8_t)
TTS_CYCLE_LB2_ENTRY(cycle_lb2_i32, int32_t)
