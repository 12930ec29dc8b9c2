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
// What bounds it on an H100: latency and issued instructions, not bytes
// or arithmetic. Each parent row is read once (n bytes at int8) and n
// int32 bounds are written, so at ta014 (n = 20, m = 10) a 1024-parent
// chunk moves about 100 KB (0.03 us at 3.35 TB/s) and a 49152-parent
// chunk about 4.9 MB (1.5 us). Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (`chip_sweep.py --lb1-steps`, PERF.md section 6), the kernel takes
// about 5 us at B = 1024: about 2.7 us of launch and staging round trip
// (the time with neither prologue nor child chain) and 2 us of wavefront
// prologue, the chain hidden; and about 18 us at B = 49152: about 9 us of
// warp 0's serial fronts, 5 us of child chains (6m operations a slot) and
// 4 us of launch, staging and writes. The serial design it replaced (8
// parents a block, one thread a parent over global bytes) took 14.5 and
// 60 us.
//
// Design: `lb1_family.cuh`, shared with kernel 5: rows and limit1 staged
// with aligned 16-byte loads, the prologue a wavefront over the machines
// (warp 0's fronts in a looping grid of 4 blocks an SM or more), one
// thread a child slot, consecutive threads on consecutive bounds.
#include "lb1_family.cuh"

// The per-child chain of kernel 1: lb1_common.cuh's `lb1_child` on the
// clamped job id.
struct Lb1Chain {
  static __device__ __forceinline__ int bound(int job, int m, const Lb1Smem& s,
                                              const int* front,
                                              const int* remain) {
    return lb1_child(&job, 0, m, s, front, remain);
  }
};

template <typename T>
__global__ void lb1_bounds_kernel(const T* __restrict__ prmu,
                                  const T* __restrict__ limit1,
                                  const int* __restrict__ ptm_t,
                                  const int* __restrict__ heads,
                                  const int* __restrict__ tails,
                                  int* __restrict__ out, int B, int n, int m,
                                  int PB, int G) {
  lb1f_body<T, Lb1Chain>(prmu, limit1, ptm_t, heads, tails, out, B, n, m, PB,
                         G);
}

static Lb1fShape lb1_bounds_last;

extern "C" void lb1_bounds_last_shape(int* out) {
  tts_lb1f_report(lb1_bounds_last, out);
}

extern "C" int lb1_bounds_i8(const void* prmu, const void* limit1,
                             const void* ptm_t, const void* heads,
                             const void* tails, void* out, int B, int n,
                             int m, void* stream) {
  return launch_lb1f<int8_t>(lb1_bounds_kernel<int8_t>, &lb1_bounds_last, prmu,
                             limit1, ptm_t, heads, tails, out, B, n, m,
                             stream);
}

extern "C" int lb1_bounds_i32(const void* prmu, const void* limit1,
                              const void* ptm_t, const void* heads,
                              const void* tails, void* out, int B, int n,
                              int m, void* stream) {
  return launch_lb1f<int32_t>(lb1_bounds_kernel<int32_t>, &lb1_bounds_last,
                              prmu, limit1, ptm_t, heads, tails, out, B, n, m,
                              stream);
}
