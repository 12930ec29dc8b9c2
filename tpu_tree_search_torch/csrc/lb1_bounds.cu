// Kernel 1: lb1 bound of every child slot of a chunk of PFSP parents.
//
// Replaces the TPU kernel `_lb1_kernel` (tpu_tree_search/ops/pallas_kernels.py,
// built by `_lb1_family_call`, tile body `_lb1_tile_lb`), entry
// `pfsp_lb1_bounds`, and the TPU kernel `_eval_lb1_kernel`
// (tpu_tree_search/ops/megakernel.py, built by `_eval_lb1_call`), the same
// lb1 plane tile by tile: `ops/tiled.streamed_eval_bounds` launches this
// kernel for it, since a tile of the eval pass needs nothing of another.
//
// In:  prmu (B, n) and limit1 (B,) of one integer type T (int8 or int32, the
//      resident pool's storage type), ptm_t (n, m), min_heads (m,),
//      min_tails (m,) int32.
// Out: (B, n) int32; slot k of parent b is the lb1 of the child that
//      schedules prmu[b, k] next. Slots k <= limit1 are not children; they
//      hold the same formula's value and are never read.
//
// What bounds it on an H100: memory and launch latency, not arithmetic.
// Each parent row is read once (n bytes at int8) and n int32 bounds are
// written, so at ta014 (n = 20, m = 10) a 1024-parent chunk moves about
// 100 KB (a few microseconds of launch latency dominate) and a 49152-parent
// chunk about 4.9 MB (1.5 us at 3.35 TB/s). The arithmetic, n*m steps of the
// parent prologue plus 2m per child, is small integer work.
//
// Design: one block per TTS_PARENTS_PER_BLOCK parents; the instance table
// lives in shared memory (20 x 10 int32 at ta014). Threads 0..PB-1 scan one
// parent prologue each into shared memory, then every thread runs one child
// slot, so consecutive threads write consecutive bounds (coalesced).
#include "lb1_common.cuh"

template <typename T>
__global__ void lb1_bounds_kernel(const T* __restrict__ prmu,
                                  const T* __restrict__ limit1,
                                  const int* __restrict__ ptm_t,
                                  const int* __restrict__ heads,
                                  const int* __restrict__ tails,
                                  int* __restrict__ out, int B, int n, int m) {
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
        lb1_child(prmu + static_cast<size_t>(b) * n, k, m, s,
                  s.front + p * m, s.remain + p * m);
  }
}

template <typename T>
static int launch_lb1_bounds(const void* prmu, const void* limit1,
                             const void* ptm_t, const void* heads,
                             const void* tails, void* out, int B, int n,
                             int m, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int PB = TTS_PARENTS_PER_BLOCK;
  const size_t smem = tts_lb1_smem_bytes(n, m);
  const int err = tts_smem_optin(lb1_bounds_kernel<T>, smem);
  if (err) return err;
  const int blocks = (B + PB - 1) / PB;
  lb1_bounds_kernel<T><<<blocks, tts_threads_for(PB * n), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(prmu), static_cast<const T*>(limit1),
      static_cast<const int*>(ptm_t), static_cast<const int*>(heads),
      static_cast<const int*>(tails), static_cast<int*>(out), B, n, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lb1_bounds_i8(const void* prmu, const void* limit1,
                             const void* ptm_t, const void* heads,
                             const void* tails, void* out, int B, int n,
                             int m, void* stream) {
  return launch_lb1_bounds<int8_t>(prmu, limit1, ptm_t, heads, tails, out, B,
                                   n, m, stream);
}

extern "C" int lb1_bounds_i32(const void* prmu, const void* limit1,
                              const void* ptm_t, const void* heads,
                              const void* tails, void* out, int B, int n,
                              int m, void* stream) {
  return launch_lb1_bounds<int32_t>(prmu, limit1, ptm_t, heads, tails, out,
                                    B, n, m, stream);
}
