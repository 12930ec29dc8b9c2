// The one body of kernels 1 and 5 (lb1_bounds.cu, lb1_d_bounds.cu): the
// bound of every child slot of a chunk of PFSP parents, templated over the
// per-child chain (lb1's `lb1_child` or lb1_d's `lb1_d_child`).
//
// A block takes PB parents at a time (up to TTS_LB1F_PARENTS):
//   1. stage: the parents' rows (PB*n*sizeof(T) contiguous bytes) and their
//      limit1 into shared memory as aligned 16-byte words (kernel 2's
//      `copy_keep_phase`); nothing after reads a row from global memory;
//   2. prologue: each parent's front and remaining work into shared memory
//      at the odd stride m | 1 (32 parents on 32 banks). Up to 32
//      machines, a group of lanes a parent, one lane a machine: the front
//      as a wavefront (l1 + m steps in place of (l1 + 1) * m dependent
//      ones) and each lane's remaining work as independent adds over the
//      staged positions l1+1..n-1 (no `colsum - done`: that holds only on
//      permutations, and the plane equals the plain version on every row
//      whose ids are in range). In a grid of looping blocks at 4 blocks an
//      SM or more (the fewest instructions win there), and past 32
//      machines, warp 0 takes the fronts, one thread a parent, beside the
//      other warps' remaining work, one (parent, machine) a thread;
//   3. children: consecutive threads on consecutive slots (one add_forward
//      step and the m-long chain each), so consecutive threads write
//      consecutive int32 bounds; the slots are enumerated without a
//      division a slot.
// Every job id is clamped to 0..n-1 where it is read, so a row that is no
// permutation (the unfused chunk past its popped window) cannot index past
// the table, and every limit1 is read as the plain version reads it (the
// front over positions 0..min(l1, n-1), min_heads at -1, the remaining
// work over positions max(l1+1, 0)..n-1).
//
// Grid (`tts_lb1f_shape`): PB = 32 parents a block, halved while the grid
// has fewer blocks than the card has SMs; one thread a slot when every
// block of that shape is on the card at once (by the kernel's occupancy),
// else blocks of TTS_LB1F_LOOP_THREADS threads that loop over their slots
// (kernel 2's rule), one block a group of parents.
#pragma once

#include "cycle_common.cuh"
#include "lb1_common.cuh"

// Most parents a block takes at a time.
#define TTS_LB1F_PARENTS 32
// Threads of a block that loops over its slots, when one thread a slot
// does not fit on the card at once.
#define TTS_LB1F_LOOP_THREADS 128
// Blocks an SM of a looping grid from which warp 0 takes the fronts.
#define TTS_LB1F_FRONT_BLOCKS 4

// Dynamic shared memory of a block of PB parents: the staged rows and
// limit1 (each with 16 bytes of head room for the source's phase), ptm
// (n*m), heads and tails (m), front and remain (PB at the odd stride m | 1).
static inline size_t tts_lb1f_smem_bytes(int n, int m, int isz, int PB) {
  return tts_stash_block_bytes(PB * n * isz) + tts_stash_block_bytes(PB * isz) +
         sizeof(int) * (static_cast<size_t>(n) * m + 2 * m + 2 * PB * (m | 1));
}

// A job id of a staged row, clamped to 0..n-1.
template <typename T>
__device__ __forceinline__ int lb1f_job(T v, int n) {
  const int j = static_cast<int>(v);
  return static_cast<unsigned>(j) < static_cast<unsigned>(n) ? j : 0;
}

// Machine j's remaining work of a parent: its times over the staged
// positions max(l1+1, 0)..n-1, independent adds.
template <typename T>
__device__ __forceinline__ int lb1f_remain(const T* row, int l1, int n, int m,
                                           const Lb1Smem& s, int j) {
  int rem = 0;
#pragma unroll 4
  for (int i = max(l1 + 1, 0); i < n; ++i)
    rem += s.ptm[lb1f_job(row[i], n) * m + j];
  return rem;
}

// A parent's front and remaining work from its staged row, by a group of
// G lanes of one warp (G a power of two, m <= G <= 32; lane j of the group
// is machine j; gmask names the group's lanes): the front as a wavefront
// over the machines, lane j taking position i = step - j with its left
// neighbour's completion time from the step before (a shuffle), the time
// of its next position loaded a step ahead (so the two dependent
// shared-memory loads overlap the shuffle); then lane j's own remaining
// work. Every lane of the group calls it.
template <typename T>
__device__ __forceinline__ void lb1f_parent_lanes(const T* row, int l1, int n,
                                                  int m, const Lb1Smem& s,
                                                  int* front, int* remain,
                                                  int G, unsigned gmask) {
  const int j = static_cast<int>(threadIdx.x) & (G - 1);
  const bool mine = j < m;
  const int last = min(l1, n - 1);
  int f = (l1 == -1 && mine) ? s.heads[j] : 0;
  // Position i = step - j is this lane's when 0 <= i <= last.
  auto time_at = [&](int i) {
    return (mine && i >= 0 && i <= last)
               ? s.ptm[lb1f_job(row[i], n) * m + j] : 0;
  };
  int pt = time_at(-j);
  for (int step = 0; step < last + m; ++step) {
    const int next = time_at(step + 1 - j);
    const int left = __shfl_up_sync(gmask, f, 1, G);
    const int i = step - j;
    if (mine && i >= 0 && i <= last) f = (j == 0 ? f : max(f, left)) + pt;
    pt = next;
  }
  if (mine) {
    front[j] = f;
    remain[j] = lb1f_remain(row, l1, n, m, s, j);
  }
}

// A parent's front by one thread: (min(l1, n-1) + 1) * m dependent steps.
template <typename T>
__device__ __forceinline__ void lb1f_front_thread(const T* row, int l1, int n,
                                                  int m, const Lb1Smem& s,
                                                  int* front) {
  for (int j = 0; j < m; ++j) front[j] = (l1 == -1) ? s.heads[j] : 0;
  const int last = min(l1, n - 1);
  for (int i = 0; i <= last; ++i) {
    const int* p = s.ptm + lb1f_job(row[i], n) * m;
    int f = front[0] + p[0];
    front[0] = f;
    for (int j = 1; j < m; ++j) {
      f = max(f, front[j]) + p[j];
      front[j] = f;
    }
  }
}

// The body of a kernel of the family: `Chain::bound(job, m, s, front,
// remain)` is the bound of the child that schedules `job` next; PB parents
// a block; `G`: the lanes a parent of the wavefront prologue
// (`lb1f_parent_lanes`), 0 for warp 0's fronts beside the other warps'
// remaining work.
template <typename T, typename Chain>
__device__ __forceinline__ void lb1f_body(const T* __restrict__ prmu,
                                          const T* __restrict__ limit1,
                                          const int* __restrict__ ptm_t,
                                          const int* __restrict__ heads,
                                          const int* __restrict__ tails,
                                          int* __restrict__ out, int B, int n,
                                          int m, int PB, int G) {
  extern __shared__ __align__(16) uint8_t lb1f_smem[];
  const int ms = m | 1;
  const int isz = static_cast<int>(sizeof(T));
  uint8_t* s_rows = lb1f_smem;
  uint8_t* s_lim = s_rows + tts_stash_block_bytes(PB * n * isz);
  Lb1Smem s;
  s.ptm = reinterpret_cast<int*>(s_lim + tts_stash_block_bytes(PB * isz));
  s.heads = s.ptm + n * m;
  s.tails = s.heads + m;
  s.front = s.tails + m;
  s.remain = s.front + PB * ms;
  lb1_load_tables(s, ptm_t, heads, tails, n, m);

  const int t = threadIdx.x;
  // Slot = p * n + k; this thread's first parent and its stride, split once.
  const int p0 = t / n, k0 = t - p0 * n;
  const int dp = static_cast<int>(blockDim.x) / n;
  const int dk = static_cast<int>(blockDim.x) - dp * n;
  const unsigned gmask =
      G >= 32 || !G ? 0xffffffffu : ((1u << G) - 1u) << ((t & 31) & ~(G - 1));
  // Groups of PB parents, gridDim.x apart: one a block when the grid holds
  // a block a group (the shape rule's grids; `chip_sweep.py` times a
  // persistent grid on the same body).
  for (int b0 = blockIdx.x * PB; b0 < B; b0 += gridDim.x * PB) {
    if (b0 != static_cast<int>(blockIdx.x) * PB)
      __syncthreads();  // the last group's children are done with its rows
    const int rows = min(PB, B - b0);
    const T* src = prmu + static_cast<size_t>(b0) * n;
    const T* lsrc = limit1 + b0;
    copy_keep_phase(reinterpret_cast<const uint8_t*>(src), rows * n * isz,
                    s_rows, nullptr);
    copy_keep_phase(reinterpret_cast<const uint8_t*>(lsrc), rows * isz, s_lim,
                    nullptr);
    __syncthreads();  // tables, rows and limit1 in shared memory
    const T* par = reinterpret_cast<const T*>(
        s_rows + (reinterpret_cast<uintptr_t>(src) & 15));
    const T* lim = reinterpret_cast<const T*>(
        s_lim + (reinterpret_cast<uintptr_t>(lsrc) & 15));

    if (G) {
      for (int p = t / G; p < rows; p += static_cast<int>(blockDim.x) / G)
        lb1f_parent_lanes(par + p * n, static_cast<int>(lim[p]), n, m, s,
                          s.front + p * ms, s.remain + p * ms, G, gmask);
    } else {
      // Warp 0 the fronts; the other warps (in a block of one warp, warp 0
      // after its fronts) the remaining work.
      if (t < 32)
        for (int p = t; p < rows; p += 32)
          lb1f_front_thread(par + p * n, static_cast<int>(lim[p]), n, m, s,
                            s.front + p * ms);
      const int w0 = blockDim.x > 32 ? 32 : 0;
      for (int e = t - w0; e >= 0 && e < rows * m;
           e += static_cast<int>(blockDim.x) - w0) {
        const int p = e / m;
        s.remain[p * ms + e - p * m] = lb1f_remain(
            par + p * n, static_cast<int>(lim[p]), n, m, s, e - p * m);
      }
    }
    __syncthreads();

    int* o = out + static_cast<size_t>(b0) * n;
    int p = p0, k = k0;
    for (int slot = t; slot < rows * n; slot += blockDim.x) {
      o[slot] = Chain::bound(lb1f_job(par[slot], n), m, s, s.front + p * ms,
                             s.remain + p * ms);
      p += dp;
      k += dk;
      if (k >= n) {
        k -= n;
        ++p;
      }
    }
  }
}

// The block shape of a launch: parents and threads a block, blocks, its
// dynamic shared memory, whether the whole grid is on the card at once, and
// the lanes a parent of the wavefront prologue (0: warp 0's fronts).
struct Lb1fShape {
  int parents;
  int threads;
  int blocks;
  int smem;
  int fits;
  int lanes;
};

// The shape for B parents (see the header note), cached for the last
// (kernel, B, n, m): a run of launches at one shape asks the occupancy
// once. Opts `kernel` in to the block's shared memory.
template <typename K>
static inline int tts_lb1f_shape(K kernel, int B, int n, int m, int isz,
                                 Lb1fShape* sh) {
  static const void* key_fn = nullptr;
  static int key[3] = {-1, -1, -1};
  static Lb1fShape last;
  const void* fn = reinterpret_cast<const void*>(kernel);
  if (key_fn == fn && key[0] == B && key[1] == n && key[2] == m) {
    *sh = last;
    return 0;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sh->parents = TTS_LB1F_PARENTS;
  while (sh->parents > 1 && (B + sh->parents - 1) / sh->parents < sms)
    sh->parents >>= 1;
  sh->blocks = (B + sh->parents - 1) / sh->parents;
  const size_t smem = tts_lb1f_smem_bytes(n, m, isz, sh->parents);
  int err = tts_smem_optin(kernel, smem);
  if (err) return err;
  sh->smem = static_cast<int>(smem);
  sh->threads = tts_threads_for(sh->parents * n);
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, sh->threads, sh->smem));
  if (err) return err;
  sh->fits = static_cast<long long>(per_sm) * sms >= sh->blocks;
  if (!sh->fits && sh->threads > TTS_LB1F_LOOP_THREADS)
    sh->threads = TTS_LB1F_LOOP_THREADS;
  // Warp 0's fronts where the grid has TTS_LB1F_FRONT_BLOCKS blocks an SM
  // or more (many blocks hide their latency, and they issue the fewest
  // instructions), else the lanes' wavefront (the shortest chain).
  int G = 1;
  while (G < m) G <<= 1;
  sh->lanes = m <= 32 && (sh->fits || sh->blocks < TTS_LB1F_FRONT_BLOCKS * sms)
                  ? G : 0;
  key_fn = fn;
  key[0] = B;
  key[1] = n;
  key[2] = m;
  last = *sh;
  return 0;
}

// Launch `kernel` (a __global__ wrapper of lb1f_body) on `stream`; the shape
// goes to *last for the library's `<source>_last_shape` entry.
template <typename T, typename K>
static int launch_lb1f(K kernel, Lb1fShape* last, const void* prmu,
                       const void* limit1, const void* ptm_t,
                       const void* heads, const void* tails, void* out, int B,
                       int n, int m, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  Lb1fShape sh;
  const int err =
      tts_lb1f_shape(kernel, B, n, m, static_cast<int>(sizeof(T)), &sh);
  if (err) return err;
  *last = sh;
  kernel<<<sh.blocks, sh.threads, sh.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(prmu), static_cast<const T*>(limit1),
      static_cast<const int*>(ptm_t), static_cast<const int*>(heads),
      static_cast<const int*>(tails), static_cast<int*>(out), B, n, m,
      sh.parents, sh.lanes);
  return static_cast<int>(cudaGetLastError());
}

// The shape of a kernel's last launch, for its `<source>_last_shape` entry:
// parents, threads, blocks, shared memory, fits, lanes a parent or 0.
static inline void tts_lb1f_report(const Lb1fShape& sh, int* out) {
  out[0] = sh.parents;
  out[1] = sh.threads;
  out[2] = sh.blocks;
  out[3] = sh.smem;
  out[4] = sh.fits;
  out[5] = sh.lanes;
}
