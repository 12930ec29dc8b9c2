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
// What bounds it on an H100: as kernel 1 (lb1_bounds.cu), latency and
// issued instructions. Each parent row is read once (n bytes at int8) and
// n int32 bounds are written: a 49,152-parent chunk at ta014 (n = 20,
// m = 10) moves about 4.9 MB (1.5 us at 3.35 TB/s). Per child slot the
// chain is 5m integer operations, less than lb1's 6m; the staged rows, the
// parent prologue and its barriers are kernel 1's, and so are its times
// within 2% (about 5 us at B = 1024, 18 us at B = 49152 on an NVIDIA H100
// 80GB HBM3 at 700 W, `chip_sweep.py --lb1-steps`, PERF.md section 6;
// the serial design it replaced took 14.3 and 60 us).
//
// Design: kernel 1's body (`lb1_family.cuh`) with the per-child chain
// swapped: rows and limit1 staged with aligned 16-byte loads, the
// prologue a wavefront over the machines (warp 0's fronts in a looping
// grid of 4 blocks an SM or more), then one thread a child slot runs the
// m-long max chain, so consecutive threads write consecutive bounds.
#include "lb1_family.cuh"

// lb1_d of the child that schedules `job` next: the parent front and
// remaining work, with that job run next (`pallas_kernels.py:628-634`).
__device__ __forceinline__ int lb1_d_child(int job, int m, const Lb1Smem& s,
                                           const int* front,
                                           const int* remain) {
  const int* p = s.ptm + job * m;
  int lb = front[0] + remain[0] + s.tails[0];
  int tmp0 = front[0] + p[0];
  for (int i = 1; i < m; ++i) {
    const int tmp1 = max(tmp0, front[i]);
    lb = max(lb, tmp1 + remain[i] + s.tails[i]);
    tmp0 = tmp1 + p[i];
  }
  return lb;
}

struct Lb1dChain {
  static __device__ __forceinline__ int bound(int job, int m, const Lb1Smem& s,
                                              const int* front,
                                              const int* remain) {
    return lb1_d_child(job, m, s, front, remain);
  }
};

template <typename T>
__global__ void lb1_d_bounds_kernel(const T* __restrict__ prmu,
                                    const T* __restrict__ limit1,
                                    const int* __restrict__ ptm_t,
                                    const int* __restrict__ heads,
                                    const int* __restrict__ tails,
                                    int* __restrict__ out, int B, int n,
                                    int m, int PB, int G) {
  lb1f_body<T, Lb1dChain>(prmu, limit1, ptm_t, heads, tails, out, B, n, m,
                          PB, G);
}

static Lb1fShape lb1_d_bounds_last;

extern "C" void lb1_d_bounds_last_shape(int* out) {
  tts_lb1f_report(lb1_d_bounds_last, out);
}

extern "C" int lb1_d_bounds_i8(const void* prmu, const void* limit1,
                               const void* ptm_t, const void* heads,
                               const void* tails, void* out, int B, int n,
                               int m, void* stream) {
  return launch_lb1f<int8_t>(lb1_d_bounds_kernel<int8_t>, &lb1_d_bounds_last,
                             prmu, limit1, ptm_t, heads, tails, out, B, n, m,
                             stream);
}

extern "C" int lb1_d_bounds_i32(const void* prmu, const void* limit1,
                                const void* ptm_t, const void* heads,
                                const void* tails, void* out, int B, int n,
                                int m, void* stream) {
  return launch_lb1f<int32_t>(lb1_d_bounds_kernel<int32_t>, &lb1_d_bounds_last,
                              prmu, limit1, ptm_t, heads, tails, out, B, n, m,
                              stream);
}
