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
//      are not written and never read.
//
// What bounds it on an H100: integer instructions on operands in shared
// memory. The children of one parent share their Johnson pass but for one
// job, so the kernel walks each (parent, pair)'s free jobs twice
// (`lb2p_bounds` in lb2_common.cuh: P*(n + c*r) operations a parent with r
// free jobs) where a pass per child cost P*n*r, and starts no work for the
// closed slots. A (parent, pair) task builds its free slots as a bit mask
// from the pair's inverse order (r steps), then touches shared memory only
// for its free jobs: one 8-byte table entry and one atomicMax into the
// parent's (job, ma0) terms a walk step. No child front is kept: a first
// design that stored each child's front, looked up each ordered slot's
// position and took all four terms of the closed form in the walks ran
// slower on the card (PERF.md, section 6). Every operand stays in shared
// memory: the ordered table
// (8 bytes a slot, 7.2 KB at ta014, 30 KB at ta021) and its inverse, each
// parent's row, front, free work and (job, machine) terms.
//
// Layout (`tts_lb2p_shape`): when every block fits on the card at once, two
// parents a block and one thread a (parent, pair) task (the small chunk is
// latency-bound); else 512 threads that loop over the tasks of up to 32
// parents (fewer table loads), as many as leave a full wave of blocks.
// Parents are cut to what fits in shared memory (ta081: 5). The parent
// fronts are wavefronts over the machines, one lane a machine.
#include "lb2_common.cuh"

template <typename T>
__global__ void lb2_bounds_kernel(const T* __restrict__ prmu,
                                  const T* __restrict__ limit1,
                                  const int* __restrict__ ptm_t,
                                  const int* __restrict__ heads,
                                  const int4* __restrict__ pairinfo,
                                  const short4* __restrict__ tab,
                                  int* __restrict__ out, int B, int n, int m,
                                  int P, int PB) {
  extern __shared__ __align__(16) unsigned char lb2_smem[];
  const Lb2ParSmem s = lb2p_smem_layout(lb2_smem, n, m, P, PB);
  lb2p_load_tables(s, ptm_t, heads, pairinfo, tab, n, m, P);
  const int b0 = blockIdx.x * PB;
  const int rows = min(PB, B - b0);
  lb2p_load_rows(s, prmu + static_cast<size_t>(b0) * n, limit1 + b0, rows, 0,
                 rows, n);
  __syncthreads();
  int* o = out + static_cast<size_t>(b0) * n;
  lb2p_bounds(s, rows, n, m, P,
              [&](int p, int k, int lb) { o[p * n + k] = lb; });
}

// Dynamic shared memory of the largest block at this shape (the wrapper
// refuses a shape above the opt-in limit).
extern "C" long long lb2_bounds_smem(int n, int m, int P) {
  return tts_lb2p_smem_max(n, m, P);
}

// The shape of the last launch: parents, threads, shared memory, fits.
static Lb2Shape lb2_bounds_last;
extern "C" void lb2_bounds_last_shape(int* out) {
  out[0] = lb2_bounds_last.parents;
  out[1] = lb2_bounds_last.threads;
  out[2] = lb2_bounds_last.smem;
  out[3] = lb2_bounds_last.fits;
}

template <typename T>
static int launch_lb2_bounds(const void* prmu, const void* limit1,
                             const void* ptm_t, const void* heads,
                             const void* pairinfo, const void* tab, void* out,
                             int B, int n, int m, int P, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  Lb2Shape sh;
  int err = tts_lb2p_shape(lb2_bounds_kernel<T>, B, n, m, P, &sh);
  if (err) return err;
  lb2_bounds_last = sh;
  const int blocks = (B + sh.parents - 1) / sh.parents;
  lb2_bounds_kernel<T><<<blocks, sh.threads, sh.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(prmu), static_cast<const T*>(limit1),
      static_cast<const int*>(ptm_t), static_cast<const int*>(heads),
      static_cast<const int4*>(pairinfo), static_cast<const short4*>(tab),
      static_cast<int*>(out), B, n, m, P, sh.parents);
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
