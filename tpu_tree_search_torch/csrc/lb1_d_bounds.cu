// Kernel 5: lb1_d bound of every child slot of a chunk of PFSP parents.
//
// Replaces the TPU kernel `_lb1_d_kernel` (tpu_tree_search/ops/pallas_kernels.py,
// built by `_lb1_family_call`), entry `pfsp_lb1_d_bounds`.
//
// In:  prmu (B, n) and limit1 (B,) of one integer type T (int8 or int32, the
//      resident pool's storage type), ptm_t (n, m), min_heads (m,),
//      min_tails (m,) int32.
// Out: (B, n) int32; slot k of parent b is the lb1_d bound of the child
//      that schedules prmu[b, k] next: the O(m) weak bound from the
//      parent's front and remaining work (`add_front_and_bound`,
//      `c_bound_simple.c:213-244`; device `evaluate.cu:51-71`). Slots
//      k <= limit1 are not children; they hold the same formula's value and
//      are never read.
//
// What bounds it on an H100: as kernel 1 (lb1_bounds.cu), memory and launch
// latency. Each parent row is read once (n bytes at int8) and n int32
// bounds are written: a 49,152-parent chunk at ta014 (n = 20, m = 10) moves
// about 4.9 MB (1.5 us at 3.35 TB/s). Per child slot the chain is 4m
// integer operations, less than lb1's 6m; the serial O(n*m) parent prologue
// is the same.
//
// Design: kernel 1's, with the per-child chain swapped. One block per
// TTS_PARENTS_PER_BLOCK parents; the instance table lives in shared
// memory; threads 0..PB-1 run the parent prologue of lb1_common.cuh (front
// and remain) into shared memory, then one thread per child slot runs the
// m-long max chain, so consecutive threads write consecutive bounds.
#include "lb1_common.cuh"

// lb1_d of child slot k: the parent front and remaining work, with the
// job at position k run next (`pallas_kernels.py:628-634`).
template <typename T>
__device__ __forceinline__ int lb1_d_child(const T* row, int k, int m,
                                           const Lb1Smem& s, const int* front,
                                           const int* remain) {
  const int* p = s.ptm + static_cast<int>(row[k]) * m;
  int lb = front[0] + remain[0] + s.tails[0];
  int tmp0 = front[0] + p[0];
  for (int i = 1; i < m; ++i) {
    const int tmp1 = max(tmp0, front[i]);
    lb = max(lb, tmp1 + remain[i] + s.tails[i]);
    tmp0 = tmp1 + p[i];
  }
  return lb;
}

template <typename T>
__global__ void lb1_d_bounds_kernel(const T* __restrict__ prmu,
                                    const T* __restrict__ limit1,
                                    const int* __restrict__ ptm_t,
                                    const int* __restrict__ heads,
                                    const int* __restrict__ tails,
                                    int* __restrict__ out, int B, int n,
                                    int m) {
  extern __shared__ int smem[];
  const Lb1Smem s = lb1_smem_layout(smem, n, m);
  lb1_load_tables(s, ptm_t, heads, tails, n, m);
  __syncthreads();

  const int PB = TTS_PARENTS_PER_BLOCK;
  const int b0 = blockIdx.x * PB;
  const int t = threadIdx.x;
  if (t < PB && b0 + t < B) {
    const int b = b0 + t;
    lb1_parent_state(prmu + static_cast<size_t>(b) * n,
                     static_cast<int>(limit1[b]), n, m, s, s.front + t * m,
                     s.remain + t * m);
  }
  __syncthreads();

  for (int slot = t; slot < PB * n; slot += blockDim.x) {
    const int p = slot / n;
    const int k = slot - p * n;
    const int b = b0 + p;
    if (b >= B) break;
    out[static_cast<size_t>(b) * n + k] =
        lb1_d_child(prmu + static_cast<size_t>(b) * n, k, m, s,
                    s.front + p * m, s.remain + p * m);
  }
}

template <typename T>
static int launch_lb1_d_bounds(const void* prmu, const void* limit1,
                               const void* ptm_t, const void* heads,
                               const void* tails, void* out, int B, int n,
                               int m, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int PB = TTS_PARENTS_PER_BLOCK;
  const size_t smem = tts_lb1_smem_bytes(n, m);
  const int err = tts_smem_optin(lb1_d_bounds_kernel<T>, smem);
  if (err) return err;
  const int blocks = (B + PB - 1) / PB;
  lb1_d_bounds_kernel<T><<<blocks, tts_threads_for(PB * n), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(prmu), static_cast<const T*>(limit1),
      static_cast<const int*>(ptm_t), static_cast<const int*>(heads),
      static_cast<const int*>(tails), static_cast<int*>(out), B, n, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lb1_d_bounds_i8(const void* prmu, const void* limit1,
                               const void* ptm_t, const void* heads,
                               const void* tails, void* out, int B, int n,
                               int m, void* stream) {
  return launch_lb1_d_bounds<int8_t>(prmu, limit1, ptm_t, heads, tails, out,
                                     B, n, m, stream);
}

extern "C" int lb1_d_bounds_i32(const void* prmu, const void* limit1,
                                const void* ptm_t, const void* heads,
                                const void* tails, void* out, int B, int n,
                                int m, void* stream) {
  return launch_lb1_d_bounds<int32_t>(prmu, limit1, ptm_t, heads, tails, out,
                                      B, n, m, stream);
}
