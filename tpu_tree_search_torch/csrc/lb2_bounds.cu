// Kernel 6: lb2 bound of every child slot of a chunk of PFSP parents.
//
// Replaces the TPU kernel `_lb2_kernel` (tpu_tree_search/ops/pallas_kernels.py,
// built by `_lb2_call`, tile body `_lb2_tile_lb`), entry `pfsp_lb2_bounds`,
// and the TPU kernel `_eval_lb2_kernel` (tpu_tree_search/ops/megakernel.py,
// built by `_eval_lb2_call`), the same lb2 plane tile by tile:
// `ops/tiled.streamed_eval_bounds` and `megakernel_lb2_bounds` launch this
// kernel for it.
//
// In:  prmu (B, n) and limit1 (B,) of one integer type T (int8 or int32, the
//      resident pool's storage type), ptm_t (n, m) and min_heads (m,) int32,
//      pairinfo (P, 4) int32 rows (ma0, ma1, tails0, tails1) and tab (P, n, 4)
//      int16 rows (p0, p1, lag, job) of each pair's Johnson order.
// Out: (B, n) int32; slot k of parent b is the lb2 of the child that
//      schedules prmu[b, k] next. Slots k <= limit1 are not children; they
//      hold a value of the same loop and are never read.
//
// What bounds it on an H100: operations. Each child slot runs the Johnson
// recurrence over all P*n ordered slots (about 5 integer operations a slot:
// ta014 has P = 45 pairs of n = 20 slots, so ~4,500 operations a child,
// against n bytes of input and 4 bytes of output a child). The design keeps
// every operand of that loop in shared memory: the ordered table (8 bytes a
// slot, 7.2 KB at ta014, 30 KB at ta021), each parent's front and job
// positions, and each thread's child front; a warp reads the same table
// entry in each step (a broadcast).
//
// Layout: one block per TTS_PARENTS_PER_BLOCK parents, as kernel 1. Threads
// 0..PB-1 scan one parent prologue each (front and positions); then every
// thread runs child slots, so consecutive threads write consecutive bounds.
#include "lb2_common.cuh"

template <typename T>
__global__ void lb2_bounds_kernel(const T* __restrict__ prmu,
                                  const T* __restrict__ limit1,
                                  const int* __restrict__ ptm_t,
                                  const int* __restrict__ heads,
                                  const int4* __restrict__ pairinfo,
                                  const short4* __restrict__ tab,
                                  int* __restrict__ out, int B, int n, int m,
                                  int P) {
  extern __shared__ __align__(16) unsigned char lb2_smem[];
  const int PB = TTS_PARENTS_PER_BLOCK;
  const Lb2Smem s = lb2_smem_layout(lb2_smem, n, m, P, PB, blockDim.x);
  lb2_load_tables(s, ptm_t, heads, pairinfo, tab, n, m, P);
  __syncthreads();

  const int b0 = blockIdx.x * PB;
  const int t = threadIdx.x;
  if (t < PB && b0 + t < B) {
    const int b = b0 + t;
    lb2_parent_state(prmu + static_cast<size_t>(b) * n,
                     static_cast<int>(limit1[b]), n, m, s, s.front + t * m,
                     s.pos + t * n);
  }
  __syncthreads();

  for (int slot = t; slot < PB * n; slot += blockDim.x) {
    const int p = slot / n;
    const int k = slot - p * n;
    const int b = b0 + p;
    if (b >= B) break;
    out[static_cast<size_t>(b) * n + k] =
        lb2_child(prmu + static_cast<size_t>(b) * n, k,
                  static_cast<int>(limit1[b]), n, m, P, s, s.front + p * m,
                  s.pos + p * n);
  }
}

static inline int lb2_bounds_threads(int n) {
  const int t = tts_threads_for(TTS_PARENTS_PER_BLOCK * n);
  return t < TTS_LB2_THREADS ? t : TTS_LB2_THREADS;
}

// Dynamic shared memory of one block at this shape (the wrapper refuses a
// shape above the opt-in limit).
extern "C" long long lb2_bounds_smem(int n, int m, int P) {
  return static_cast<long long>(tts_lb2_smem_bytes(
      n, m, P, TTS_PARENTS_PER_BLOCK, lb2_bounds_threads(n),
      TTS_PARENTS_PER_BLOCK));
}

template <typename T>
static int launch_lb2_bounds(const void* prmu, const void* limit1,
                             const void* ptm_t, const void* heads,
                             const void* pairinfo, const void* tab, void* out,
                             int B, int n, int m, int P, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int PB = TTS_PARENTS_PER_BLOCK;
  const size_t smem = static_cast<size_t>(lb2_bounds_smem(n, m, P));
  int err = tts_smem_optin(lb2_bounds_kernel<T>, smem);
  if (err) return err;
  const int blocks = (B + PB - 1) / PB;
  lb2_bounds_kernel<T><<<blocks, lb2_bounds_threads(n), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(prmu), static_cast<const T*>(limit1),
      static_cast<const int*>(ptm_t), static_cast<const int*>(heads),
      static_cast<const int4*>(pairinfo), static_cast<const short4*>(tab),
      static_cast<int*>(out), B, n, m, P);
  return static_cast<int>(cudaGetLastError());
}

#define TTS_LB2_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* prmu, const void* limit1,                 \
                      const void* ptm_t, const void* heads,                 \
                      const void* pairinfo, const void* tab, void* out,     \
                      int B, int n, int m, int P, void* stream) {           \
    return launch_lb2_bounds<T>(prmu, limit1, ptm_t, heads, pairinfo, tab,  \
                                out, B, n, m, P, stream);                   \
  }

TTS_LB2_ENTRY(lb2_bounds_i8, int8_t)
TTS_LB2_ENTRY(lb2_bounds_i32, int32_t)
