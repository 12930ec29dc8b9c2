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
//      rows (p0, p1, lag, job) of each pair's Johnson order: int16 on the
//      SMEM route, int32 on the GLOBAL route, which also reads inv (P, n)
//      int16, the slot of each job (lb2_common.cuh; the route is
//      `ops/lb2_kernel.py`'s `route`).
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
// fronts are wavefronts over the machines, one lane a machine. On the
// GLOBAL route (ta101-ta120, n > 256, values past int16, or tables past
// shared memory) the same code reads the tables through L2 and keeps only
// the parents in shared memory (ta111: about 42 KB a parent).
#include "lb2_common.cuh"

template <typename T, bool GT, bool WIDE>
__global__ void lb2_bounds_kernel(const T* __restrict__ prmu,
                                  const T* __restrict__ limit1,
                                  const int* __restrict__ ptm_t,
                                  const int* __restrict__ heads,
                                  const int4* __restrict__ pairinfo,
                                  const typename Lb2Types<GT>::Tab* __restrict__ tab,
                                  const typename Lb2Types<GT>::Job* __restrict__ inv,
                                  int* __restrict__ out, int B, int n, int m,
                                  int P, int PB) {
  extern __shared__ __align__(16) unsigned char lb2_smem[];
  const Lb2ParSmem<GT> s =
      lb2p_smem_layout<GT>(lb2_smem, n, m, P, PB, ptm_t, heads, pairinfo, tab, inv);
  lb2p_load_tables<GT>(s, ptm_t, heads, pairinfo,
                       reinterpret_cast<const short4*>(tab), n, m, P);
  const int b0 = blockIdx.x * PB;
  const int rows = min(PB, B - b0);
  lb2p_load_rows<GT>(s, prmu + static_cast<size_t>(b0) * n, limit1 + b0, rows,
                     0, rows, n);
  __syncthreads();
  int* o = out + static_cast<size_t>(b0) * n;
  lb2p_bounds<GT, WIDE>(s, rows, n, m, P,
                        [&](int p, int k, int lb) { o[p * n + k] = lb; });
}

// The dynamic shared memory of the largest block on a route (`global` 0
// or 1).
extern "C" long long lb2_bounds_smem(int n, int m, int P, int global) {
  return tts_lb2p_smem_max(global != 0, n, m, P);
}

// The shape of the last launch: parents, threads, shared memory, fits,
// route.
static Lb2Shape lb2_bounds_last;
extern "C" void lb2_bounds_last_shape(int* out) {
  out[0] = lb2_bounds_last.parents;
  out[1] = lb2_bounds_last.threads;
  out[2] = lb2_bounds_last.smem;
  out[3] = lb2_bounds_last.fits;
  out[4] = lb2_bounds_last.global;
}

template <typename T, bool GT, bool WIDE>
static int launch_lb2_bounds_w(const void* prmu, const void* limit1,
                               const void* ptm_t, const void* heads,
                               const void* pairinfo, const void* tab,
                               const void* inv, void* out, int B, int n,
                               int m, int P, void* stream) {
  Lb2Shape sh;
  int err = tts_lb2p_shape<GT>(lb2_bounds_kernel<T, GT, WIDE>, B, n, m, P,
                               &sh);
  if (err) return err;
  lb2_bounds_last = sh;
  const int blocks = (B + sh.parents - 1) / sh.parents;
  lb2_bounds_kernel<T, GT, WIDE><<<blocks, sh.threads, sh.smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(prmu), static_cast<const T*>(limit1),
      static_cast<const int*>(ptm_t), static_cast<const int*>(heads),
      static_cast<const int4*>(pairinfo),
      static_cast<const typename Lb2Types<GT>::Tab*>(tab),
      static_cast<const typename Lb2Types<GT>::Job*>(inv),
      static_cast<int*>(out), B, n, m, P, sh.parents);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool GT>
static int launch_lb2_bounds(const void* prmu, const void* limit1,
                             const void* ptm_t, const void* heads,
                             const void* pairinfo, const void* tab,
                             const void* inv, void* out, int B, int n, int m,
                             int P, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (tts_lb2p_wide(n))
    return launch_lb2_bounds_w<T, GT, true>(prmu, limit1, ptm_t, heads,
                                            pairinfo, tab, inv, out, B, n, m,
                                            P, stream);
  return launch_lb2_bounds_w<T, GT, false>(prmu, limit1, ptm_t, heads,
                                           pairinfo, tab, inv, out, B, n, m,
                                           P, stream);
}

// `route` 0: tab is the int16 table (inv unused); 1: tab the int32 table
// and inv the 16-bit inverse.
#define TTS_LB2_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* prmu, const void* limit1,                 \
                      const void* ptm_t, const void* heads,                 \
                      const void* pairinfo, const void* tab,                \
                      const void* inv, void* out, int B, int n, int m,      \
                      int P, int route, void* stream) {                     \
    if (route == 1)                                                         \
      return launch_lb2_bounds<T, true>(prmu, limit1, ptm_t, heads,         \
                                        pairinfo, tab, inv, out, B, n, m,   \
                                        P, stream);                         \
    return launch_lb2_bounds<T, false>(prmu, limit1, ptm_t, heads,          \
                                       pairinfo, tab, inv, out, B, n, m, P, \
                                       stream);                             \
  }

TTS_LB2_ENTRY(lb2_bounds_i8, int8_t)
TTS_LB2_ENTRY(lb2_bounds_i32, int32_t)
