// Kernel 7: lb2 of each row's own partial schedule (the staged evaluator's
// compacted candidate children).
//
// Replaces the TPU kernel `_lb2_self_kernel`
// (tpu_tree_search/ops/pallas_kernels.py, built by `_lb2_self_call`),
// entries `pfsp_lb2_self_bounds_tables` and `pfsp_lb2_self_bounds`.
//
// In:  rows (R, n) and limit1 (R,) of one integer type T (int8 or int32),
//      n_active: one int in device memory, the count of rows to bound; the
//      tables of kernel 6 (ptm_t, min_heads, pairinfo, tab).
// Out: (R,) int32; rows at or past n_active are not written.
//
// The TPU kernel skipped whole grid tiles past n_active
// (`pl.when(program_id * tile < n_active)`); here a block whose first row is
// at or past n_active returns before it loads a table, so the grid can be
// sized for every row (R = M*n) and the host never reads the count.
//
// What bounds it on an H100: operations, as kernel 6: each active row runs
// its serial front scan (up to n*m steps) and the Johnson recurrence over
// P*n ordered slots, against n bytes in and 4 bytes out. One thread a row;
// each thread keeps its front and job positions in its own column of shared
// memory (conflict-free), beside the shared tables.
#include "lb2_common.cuh"

template <typename T>
__global__ void lb2_self_bounds_kernel(const T* __restrict__ rows,
                                       const T* __restrict__ limit1,
                                       const int* __restrict__ n_active,
                                       const int* __restrict__ ptm_t,
                                       const int* __restrict__ heads,
                                       const int4* __restrict__ pairinfo,
                                       const short4* __restrict__ tab,
                                       int* __restrict__ out, int R, int n,
                                       int m, int P) {
  const int nact = min(*n_active, R);
  const int r0 = blockIdx.x * blockDim.x;
  if (r0 >= nact) return;
  extern __shared__ __align__(16) unsigned char lb2_smem[];
  const Lb2Smem s = lb2_smem_layout(lb2_smem, n, m, P, blockDim.x);
  lb2_load_tables(s, ptm_t, heads, pairinfo, tab, n, m, P);
  __syncthreads();
  const int r = r0 + threadIdx.x;
  if (r >= nact) return;
  out[r] = lb2_row(rows + static_cast<size_t>(r) * n,
                   static_cast<int>(limit1[r]), n, m, P, s);
}

extern "C" long long lb2_self_bounds_smem(int n, int m, int P) {
  const int T = TTS_LB2_SELF_THREADS;
  return static_cast<long long>(tts_lb2_smem_bytes(n, m, P, T, T));
}

template <typename T>
static int launch_lb2_self_bounds(const void* rows, const void* limit1,
                                  const void* n_active, const void* ptm_t,
                                  const void* heads, const void* pairinfo,
                                  const void* tab, void* out, int R, int n,
                                  int m, int P, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = TTS_LB2_SELF_THREADS;
  const size_t smem = static_cast<size_t>(lb2_self_bounds_smem(n, m, P));
  int err = tts_smem_optin(lb2_self_bounds_kernel<T>, smem);
  if (err) return err;
  lb2_self_bounds_kernel<T><<<(R + threads - 1) / threads, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(limit1),
      static_cast<const int*>(n_active), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int4*>(pairinfo),
      static_cast<const short4*>(tab), static_cast<int*>(out), R, n, m, P);
  return static_cast<int>(cudaGetLastError());
}

#define TTS_LB2_SELF_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* rows, const void* limit1,                 \
                      const void* n_active, const void* ptm_t,              \
                      const void* heads, const void* pairinfo,              \
                      const void* tab, void* out, int R, int n, int m,      \
                      int P, void* stream) {                                \
    return launch_lb2_self_bounds<T>(rows, limit1, n_active, ptm_t, heads,  \
                                     pairinfo, tab, out, R, n, m, P,        \
                                     stream);                               \
  }

TTS_LB2_SELF_ENTRY(lb2_self_bounds_i8, int8_t)
TTS_LB2_SELF_ENTRY(lb2_self_bounds_i32, int32_t)
