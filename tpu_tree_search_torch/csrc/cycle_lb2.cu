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
// cycle_pfsp.cuh. Launch 1's pop writes each row, one element a thread,
// where the emit's 32-parent blocks read it (`pfsp_stash_row`), whatever
// its own parents a block. The keep test is the unstaged one,
// open & ~leaf & lb2 < best, as in the JAX megakernel (`make_cycle`'s
// note: it equals the staged keep, since lb2 >= lb1). A leaf child has no
// free job, so its lb2 is its makespan, which the fold takes into the
// incumbent. Launch 1 writes the open slots of the plane only; the count
// launch reads no other.
//
// What bounds it on an H100: the integer instructions of launch 1, kernel
// 6's per-parent pair pass (lb2_common.cuh `lb2p_bounds`: one forward and
// one backward walk over each (parent, pair)'s free jobs, where a Johnson
// pass per child cost P*n*r a parent); the bytes moved are kernel 2's.
// Launch 1 takes kernel 6's block shape (`tts_lb2p_shape`): at M = 1024
// every block fits on the card at once, so two parents a block and one
// thread a (parent, pair) task keep the chains short; at M = 49152 512
// threads loop over the tasks of 32 parents a block.
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
                                 int P, int M, int C, int mterm, int K,
                                 int PB) {
  int start, size, start2;
  if (!pfsp_cycle_begin(st, n, M, C, mterm, K, &start, &size, &start2))
    return;

  extern __shared__ __align__(16) unsigned char lb2_smem[];
  __shared__ int s_leafmin;
  const Lb2ParSmem s = lb2p_smem_layout(lb2_smem, n, m, P, PB);
  lb2p_load_tables(s, ptm_t, heads, pairinfo, tab, n, m, P);
  if (threadIdx.x == 0) s_leafmin = TTS_INF_BOUND;

  const int i0 = blockIdx.x * PB;
  const int rows = min(PB, M - i0);
  pfsp_stash_pop(pool_vals, pool_aux, stash, chunk_aux, start2, i0, rows, n);
  // Rows start2 + i0 + p in [start, size) are the popped parents.
  const int first = start2 + i0;
  lb2p_load_rows(s, pool_vals + static_cast<size_t>(first) * n,
                 pool_aux + first, rows, start - first, size - first, n);
  __syncthreads();  // the tables and rows are in shared memory

  int leafmin = TTS_INF_BOUND;
  int* plane = lb + static_cast<size_t>(i0) * n;
  lb2p_bounds(s, rows, n, m, P, [&](int p, int k, int v) {
    plane[p * n + k] = v;
    if (s.l1[p] + 2 == n) leafmin = min(leafmin, v);
  });
  pfsp_fold_leaves(leafmin, &s_leafmin, st);
}

// Dynamic shared memory of the largest launch-1 block at this shape (the
// wrapper refuses a shape above the opt-in limit).
extern "C" long long cycle_lb2_smem(int n, int m, int P) {
  return tts_lb2p_smem_max(n, m, P);
}

// Launch 1's shape in the last cycle: parents, threads, shared memory, fits.
static Lb2Shape cycle_lb2_last;
extern "C" void cycle_lb2_last_shape(int* out) {
  out[0] = cycle_lb2_last.parents;
  out[1] = cycle_lb2_last.threads;
  out[2] = cycle_lb2_last.smem;
  out[3] = cycle_lb2_last.fits;
}

template <typename T>
static int launch_cycle_lb2(void* pool_vals, void* pool_aux, void* st,
                            void* chunk_vals, void* chunk_aux, void* lb,
                            void* blkcnt, const void* ptm_t,
                            const void* heads, const void* pairinfo,
                            const void* tab, int n, int m, int P, int M,
                            int C, int mterm, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Lb2Shape sh;
  int err = tts_lb2p_shape(lb2_cycle_bounds<T>, M, n, m, P, &sh);
  if (err) return err;
  cycle_lb2_last = sh;
  const int nblk = (M + sh.parents - 1) / sh.parents;
  int* st_i = static_cast<int*>(st);
  lb2_cycle_bounds<T><<<nblk, sh.threads, sh.smem, s>>>(
      static_cast<const T*>(pool_vals), static_cast<const T*>(pool_aux), st_i,
      static_cast<uint8_t*>(chunk_vals), static_cast<T*>(chunk_aux),
      static_cast<int*>(lb), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int4*>(pairinfo),
      static_cast<const short4*>(tab), n, m, P, M, C, mterm, K, sh.parents);
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
