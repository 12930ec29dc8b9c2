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
// Per row, with f its front after positions 0..l1 (min_heads at l1 = -1)
// and for each machine pair q the Johnson recurrence over the free jobs
// (positions > l1) in q's order from tmp0 = f[ma0], tmp1 = f[ma1]:
//   tmp0 += p0; tmp1 = max(tmp1, tmp0 + lag) + p1,
// the bound is the max over the pairs, from 0, of max(tmp1 + tails1,
// tmp0 + tails0) (`c_bound_johnson.c:190-254` without the early exit).
//
// What bounds it on an H100. The staged search hands it R = M*n rows and a
// count it never reads on the host: on ta014 seventeen launches of 179 to
// 74,171 rows (mean limit1 2.3 to 18) of R = 983,040. Few rows are a
// latency problem (one row's front and P walks are one chain), many rows
// an instruction problem (P walks of n slots a row), and the grid must
// serve both without knowing the count. The design:
//   1. A grid of one wave: the blocks an SM holds (by the occupancy, read
//      once a shape) times the SMs, capped by what R needs. A block reads
//      n_active, returns at once when it has no rows, else loads the
//      tables into shared memory once and loops over passes of its rows.
//   2. The work split from n_active (`lb2s_split`): G lanes a row, 32 while
//      the rows leave the grid's lanes idle, halved while rows * G exceeds
//      them; at one lane a row, RT rows a thread, as many as the rows need
//      (up to 4, fewer where shared memory is short). The lanes take the
//      pairs q = lane, lane + G, ...
//      and reduce their maxima with shuffles. Up to 32 machines and with
//      G >= m the front is a wavefront over the machines (l1 + m steps);
//      else one lane runs the (l1 + 1) * m steps.
//   3. A pair's walk tests each of its n ordered slots against the row's
//      free-job mask (W words by job id, built once a row by the group
//      with shuffles): no job-position column, one shift and one and a
//      slot, and the recurrence only where the job is free. The slot's
//      load and unpack serve the thread's RT rows (the instructions a slot
//      that do not depend on the row), and the slot loop is unrolled four
//      times so that the loads run ahead of the recurrence. A walk over
//      only the free slots (their bits through the pair's inverse table, r
//      set bits walked with __ffs) ran slower at every count measured, on
//      the staged search's own rows too, whose warps hold siblings of one
//      depth: its chain is 2r dependent steps, the inverse-table pass
//      included (PERF.md, section 6).
//   4. Rows in by 16-byte words (`copy_keep_phase`; int32 rows by
//      coalesced words, narrowed), every job id outside [0, n) read as job
//      0 and limit1 clamped to [-1, n - 1], so no index leaves the tables.
//   5. The shared-memory opt-in and the occupancy once a shape.
// Two table routes, as kernels 6 and 8 (lb2_common.cuh), chosen from the
// shape before the launch (`ops/lb2_kernel.py` `route`): SMEM, the design
// above, where the int16 tables and a block of at least one warp fit in
// shared memory and n <= 256; GLOBAL past that (ta101-ta120, values past
// int16): the pair rows, the int32 ordered table and ptm read through L2,
// the staged rows as 16-bit job ids, one row a thread at most.
#include "cycle_common.cuh"
#include "lb2_common.cuh"

// Threads of a block, halved (down to one warp) while the block's shared
// memory does not fit.
#define TTS_LB2S_THREADS 128
// Most rows a thread takes at once at one lane a row.
#define TTS_LB2S_ROWS 4

// The shared memory of a block: the pair rows, the ordered table at the
// stride ns (n | 1, odd: lanes on consecutive pairs read different banks;
// n where only that fits), ptm and min_heads; then, 16-aligned, the staged
// rows (16 bytes of head room), their limit1 and their fronts at the odd
// stride m | 1. GT (the GLOBAL route): the tables are the device-memory
// ones and the block holds only the rows (16-bit job ids) and their state.
template <bool GT>
struct Lb2sSmem {
  using Tab = typename Lb2Types<GT>::Tab;
  using Job = typename Lb2Types<GT>::Job;
  int4* pair;      // P: (ma0, ma1, tails0, tails1)
  Tab* tab;        // P*ns: slot t of pair q = (p0, p1, lag, job)
  int* ptm;        // n*m job-major processing times
  int* heads;      // m: min_heads
  Job* rows;       // the staged rows, job ids in [0, n)
  int* l1;         // their limit1, in [-1, n - 1]
  int* front;      // their fronts
};

// Bytes of a block of `threads` threads taking up to `rows` rows a thread,
// the ordered table at stride ns. `ops/lb2_self_kernel.py` mirrors it.
static inline size_t tts_lb2s_smem_bytes(bool gt, int n, int m, int P, int ns,
                                         int threads, int rows) {
  const int U = threads * rows;
  const size_t tables = gt ? 0 : 16 * static_cast<size_t>(P) +
                        8 * static_cast<size_t>(P) * ns +
                        4 * (static_cast<size_t>(n) * m + m);
  return (tables + 15) / 16 * 16 + tts_stash_block_bytes(U * n * (gt ? 2 : 1)) +
         4 * static_cast<size_t>(U) * (1 + (m | 1));
}

template <bool GT>
__device__ __forceinline__ Lb2sSmem<GT> lb2s_smem_layout(
    unsigned char* smem, int n, int m, int P, int ns, int U,
    const int* ptm_t, const int* heads, const int4* pairinfo,
    const typename Lb2Types<GT>::Tab* tab) {
  using Job = typename Lb2Types<GT>::Job;
  Lb2sSmem<GT> s;
  uintptr_t end;
  if constexpr (GT) {
    s.pair = const_cast<int4*>(pairinfo);
    s.tab = const_cast<int4*>(tab);
    s.ptm = const_cast<int*>(ptm_t);
    s.heads = const_cast<int*>(heads);
    end = reinterpret_cast<uintptr_t>(smem);
  } else {
    s.pair = reinterpret_cast<int4*>(smem);
    s.tab = reinterpret_cast<short4*>(s.pair + P);
    s.ptm = reinterpret_cast<int*>(s.tab + P * ns);
    s.heads = s.ptm + n * m;
    end = reinterpret_cast<uintptr_t>(s.heads + m);
  }
  s.rows = reinterpret_cast<Job*>((end + 15) & ~static_cast<uintptr_t>(15));
  s.l1 = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(s.rows) +
                                tts_stash_block_bytes(U * n * sizeof(Job)));
  s.front = s.l1 + U;
  return s;
}

template <bool GT>
__device__ __forceinline__ void lb2s_load_tables(const Lb2sSmem<GT>& s,
                                                 const int* ptm_t,
                                                 const int* heads,
                                                 const int4* pairinfo,
                                                 const short4* tab, int n,
                                                 int m, int P, int ns) {
  if constexpr (!GT) {
    for (int i = threadIdx.x; i < P; i += blockDim.x) s.pair[i] = pairinfo[i];
    for (int i = threadIdx.x; i < P * n; i += blockDim.x) {
      const int q = i / n;
      s.tab[q * ns + i - q * n] = tab[i];
    }
    for (int i = threadIdx.x; i < n * m; i += blockDim.x) s.ptm[i] = ptm_t[i];
    for (int i = threadIdx.x; i < m; i += blockDim.x) s.heads[i] = heads[i];
  }
}

// Lanes a row G and rows a thread RT of a launch: G the smallest power of
// two that covers the pairs and the machines (at most 32), halved while
// n_active rows of G lanes exceed the grid's threads; at one lane a row,
// RT the rows a thread that the threads need, up to `rows`. Every block
// computes the same pair.
__device__ __forceinline__ int2 lb2s_split(int nact, int P, int m, int rows) {
  const long long lanes = static_cast<long long>(gridDim.x) * blockDim.x;
  int G = 32;
  while (G > 1 && G / 2 >= max(P, m)) G >>= 1;
  while (G > 1 && static_cast<long long>(nact) * G > lanes) G >>= 1;
  const long long need = (nact + lanes - 1) / lanes;
  return make_int2(G, G > 1 ? 1 : static_cast<int>(need < rows ? need : rows));
}

// The rows r0.. of the block's pass into s.rows as bytes (GT: 16-bit ids),
// job ids outside [0, n) as 0, and their limit1 into s.l1 clamped to
// [-1, n - 1]; returns the first staged row. int8 rows by 16-byte words
// (the copy keeps the source's phase mod 16), then narrowed in place;
// int32 rows (and every GT row) by coalesced words. Ends with a barrier.
template <bool GT, typename T>
__device__ __forceinline__ const typename Lb2Types<GT>::Job* lb2s_stage(
    const Lb2sSmem<GT>& s, const T* src, const T* lim, int rows, int n) {
  using Job = typename Lb2Types<GT>::Job;
  const int len = rows * n;
  Job* row = s.rows;
  for (int p = threadIdx.x; p < rows; p += blockDim.x)
    s.l1[p] = min(max(static_cast<int>(lim[p]), -1), n - 1);
  if constexpr (sizeof(T) == 1 && !GT) {
    copy_keep_phase(reinterpret_cast<const uint8_t*>(src), len, s.rows,
                    nullptr);
    row = s.rows + (reinterpret_cast<uintptr_t>(src) & 15);
    __syncthreads();
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int j = static_cast<int8_t>(row[e]);
      if (static_cast<unsigned>(j) >= static_cast<unsigned>(n)) row[e] = 0;
    }
  } else {
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int j = static_cast<int>(src[e]);
      row[e] = static_cast<Job>(
          static_cast<unsigned>(j) < static_cast<unsigned>(n) ? j : 0);
    }
  }
  __syncthreads();
  return row;
}

// A row's front into f[0..m), by a group of G lanes (m <= G <= 32, lane j
// machine j): a wavefront over the machines, lane j taking position
// i = step - j with its left neighbour's time from the step before, the
// time of its next position loaded a step ahead. Every lane of the group
// calls it.
template <bool GT>
__device__ __forceinline__ void lb2s_front_lanes(const Lb2sSmem<GT>& s,
                                                 const typename Lb2Types<GT>::Job* row, int l1,
                                                 int m, int* f, int lane,
                                                 int G, unsigned gmask) {
  const bool mine = lane < m;
  int fv = (l1 == -1 && mine) ? s.heads[lane] : 0;
  auto time_at = [&](int i) {
    return (mine && i >= 0 && i <= l1) ? s.ptm[row[i] * m + lane] : 0;
  };
  int pt = time_at(-lane);
  for (int step = 0; step < l1 + m; ++step) {
    const int next = time_at(step + 1 - lane);
    const int left = __shfl_up_sync(gmask, fv, 1, G);
    const int i = step - lane;
    if (mine && i >= 0 && i <= l1) fv = (lane == 0 ? fv : max(fv, left)) + pt;
    pt = next;
  }
  if (mine) f[lane] = fv;
}

// The bounds of a pass of the block: rows_here staged rows, G lanes a row,
// RT rows a thread (RT > 1 only at G = 1). The thread's rows are
// p_i = t / G + i * (threads / G); a row past rows_here is computed from
// row 0's front and no free job, and not written.
template <bool GT, int W, int RT>
__device__ __forceinline__ void lb2s_pass(const Lb2sSmem<GT>& s,
                                          const typename Lb2Types<GT>::Job* staged, int* out,
                                          int rows_here, int n, int m, int P,
                                          int ns, int G) {
  const int t = threadIdx.x;
  const int lane = t & (G - 1);
  const int per = static_cast<int>(blockDim.x) / G;
  const int ms = m | 1;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((t & 31) & ~(G - 1));
  int prow[RT];
  bool ok[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    prow[i] = t / G + i * per;
    ok[i] = prow[i] < rows_here;
    if (!ok[i]) continue;  // a group's rows are the same: no shuffle splits
    const typename Lb2Types<GT>::Job* row = staged + prow[i] * n;
    const int l1 = s.l1[prow[i]];
    int* f = s.front + prow[i] * ms;
    if (m <= G)
      lb2s_front_lanes(s, row, l1, m, f, lane, G, gmask);
    else if (lane == 0)  // (l1 + 1) * m dependent steps
      pfsp_front(row, l1, n, m, s.ptm, s.heads, f, 1);
  }
  __syncwarp(gmask);
  // The free-job masks: each lane its positions, or-ed over the group.
  uint32_t fm[RT][W];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int w = 0; w < W; ++w) fm[i][w] = 0;
    if (ok[i]) {
      const typename Lb2Types<GT>::Job* row = staged + prow[i] * n;
      for (int k = s.l1[prow[i]] + 1 + lane; k < n; k += G) {
        const int job = row[k];
#pragma unroll
        for (int w = 0; w < W; ++w)
          if ((job >> 5) == w) fm[i][w] |= 1u << (job & 31);
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        fm[i][w] |= __shfl_xor_sync(gmask, fm[i][w], o, G);
    }
  }
  int lb[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) lb[i] = 0;
  for (int q = lane; q < P; q += G) {
    const int4 pr = s.pair[q];
    int tmp0[RT], tmp1[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int* f = s.front + (ok[i] ? prow[i] : 0) * ms;
      tmp0[i] = f[pr.x];
      tmp1[i] = f[pr.y];
    }
    // Every ordered slot of pair q, counted for a row when its job is in
    // the row's free-job mask: one load and unpack a slot for the RT rows.
    const typename Lb2Types<GT>::Tab* e = s.tab + q * ns;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const typename Lb2Types<GT>::Tab v = e[k];
      const uint32_t bit = 1u << (v.w & 31);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        uint32_t word = fm[i][0];
#pragma unroll
        for (int w = 1; w < W; ++w)
          if ((v.w >> 5) == w) word = fm[i][w];
        if (word & bit) {
          tmp0[i] += v.x;
          tmp1[i] = max(tmp1[i], tmp0[i] + v.z) + v.y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
      lb[i] = max(lb[i], max(tmp1[i] + pr.w, tmp0[i] + pr.z));
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    for (int o = G >> 1; o > 0; o >>= 1)
      lb[i] = max(lb[i], __shfl_xor_sync(gmask, lb[i], o, G));
    if (lane == 0 && ok[i]) out[prow[i]] = lb[i];
  }
}

// The (G, RT) the last launch took, written by its block 0 ((0, 0) when
// it had no rows); `lb2_self_bounds_last_split` reads it.
__device__ int2 lb2s_taken;

template <typename T, int W, bool GT>
__global__ void lb2_self_bounds_kernel(const T* __restrict__ rows,
                                       const T* __restrict__ limit1,
                                       const int* __restrict__ n_active,
                                       const int* __restrict__ ptm_t,
                                       const int* __restrict__ heads,
                                       const int4* __restrict__ pairinfo,
                                       const typename Lb2Types<GT>::Tab* __restrict__ tab,
                                       int* __restrict__ out, int R, int n,
                                       int m, int P, int ns, int max_rows) {
  const int nact = min(*n_active, R);
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  if (nact <= 0) {
    if (first) lb2s_taken = make_int2(0, 0);
    return;
  }
  const int2 split = lb2s_split(nact, P, m, max_rows);
  const int G = split.x, RT = split.y;
  if (first) lb2s_taken = make_int2(G, RT);
  const int U = static_cast<int>(blockDim.x) / G * RT;  // rows a pass
  if (static_cast<int>(blockIdx.x) * U >= nact) return;
  extern __shared__ __align__(16) unsigned char lb2_smem[];
  const Lb2sSmem<GT> s = lb2s_smem_layout<GT>(
      lb2_smem, n, m, P, ns, static_cast<int>(blockDim.x) * max_rows, ptm_t,
      heads, pairinfo, tab);
  lb2s_load_tables<GT>(s, ptm_t, heads, pairinfo,
                       reinterpret_cast<const short4*>(tab), n, m, P, ns);
  for (int r0 = blockIdx.x * U; r0 < nact; r0 += gridDim.x * U) {
    if (r0 != static_cast<int>(blockIdx.x) * U)
      __syncthreads();  // the last pass is done with the staged rows
    const int rows_here = min(U, nact - r0);
    const typename Lb2Types<GT>::Job* staged =
        lb2s_stage<GT>(s, rows + static_cast<size_t>(r0) * n, limit1 + r0,
                       rows_here, n);
    if (GT || RT == 1)  // GLOBAL: one row a thread at most (max_rows 1)
      lb2s_pass<GT, W, 1>(s, staged, out + r0, rows_here, n, m, P, ns, G);
    else if (RT == 2)
      lb2s_pass<GT, W, 2>(s, staged, out + r0, rows_here, n, m, P, ns, G);
    else if (RT == 3)
      lb2s_pass<GT, W, 3>(s, staged, out + r0, rows_here, n, m, P, ns, G);
    else
      lb2s_pass<GT, W, 4>(s, staged, out + r0, rows_here, n, m, P, ns, G);
  }
}

// A block shape: threads and rows a thread at most (halved while the
// block's shared memory does not fit, threads first down to one warp, the
// table's stride n | 1 before n), blocks, shared memory, blocks an SM by
// the occupancy, the table's stride, and the route (1 GLOBAL).
struct Lb2sShape {
  int threads;
  int rows;
  int blocks;
  int smem;
  int per_sm;
  int ns;
  int global;
};
static Lb2sShape lb2_self_bounds_last;

// The shape of the last launch: threads, rows a thread at most, blocks,
// shared memory, blocks an SM, the table's stride.
extern "C" void lb2_self_bounds_last_shape(int* out) {
  out[0] = lb2_self_bounds_last.threads;
  out[1] = lb2_self_bounds_last.rows;
  out[2] = lb2_self_bounds_last.blocks;
  out[3] = lb2_self_bounds_last.smem;
  out[4] = lb2_self_bounds_last.per_sm;
  out[5] = lb2_self_bounds_last.ns;
  out[6] = lb2_self_bounds_last.global;
}

// The lanes a row and rows a thread the last launch took (read on the
// default stream, after the launch). Returns the CUDA error, 0 on success.
extern "C" int lb2_self_bounds_last_split(int* out) {
  int2 v = make_int2(0, 0);
  const cudaError_t err = cudaMemcpyFromSymbol(&v, lb2s_taken, sizeof(v));
  out[0] = v.x;
  out[1] = v.y;
  return static_cast<int>(err);
}

static inline void tts_lb2s_block(bool gt, int n, int m, int P,
                                  Lb2sShape* sh) {
  sh->global = gt;
  for (sh->ns = gt ? n : n | 1;; sh->ns = n) {
    sh->threads = TTS_LB2S_THREADS;
    while (sh->threads > 32 && tts_lb2s_smem_bytes(gt, n, m, P, sh->ns,
                                                   sh->threads, 1) > TTS_LB2_SMEM_MAX)
      sh->threads >>= 1;
    if (sh->ns == n || tts_lb2s_smem_bytes(gt, n, m, P, sh->ns, sh->threads,
                                           1) <= TTS_LB2_SMEM_MAX)
      break;
  }
  sh->rows = gt ? 1 : TTS_LB2S_ROWS;
  while (sh->rows > 1 && tts_lb2s_smem_bytes(gt, n, m, P, sh->ns, sh->threads,
                                             sh->rows) > TTS_LB2_SMEM_MAX)
    sh->rows >>= 1;
  sh->smem = static_cast<int>(
      tts_lb2s_smem_bytes(gt, n, m, P, sh->ns, sh->threads, sh->rows));
}

// Dynamic shared memory of a block at this shape on a route.
extern "C" long long lb2_self_bounds_smem(int n, int m, int P, int global) {
  Lb2sShape sh;
  tts_lb2s_block(global != 0, n, m, P, &sh);
  return sh.smem;
}

// The block shape and blocks an SM of `kernel` at (n, m, P), kept for the
// last shape (a run of launches asks the occupancy once); opts the kernel
// in to its shared memory.
template <bool GT, typename K>
static int tts_lb2s_shape(K kernel, int n, int m, int P, Lb2sShape* sh) {
  static const void* key_fn = nullptr;
  static int key[3] = {-1, -1, -1};
  static Lb2sShape last;
  const void* fn = reinterpret_cast<const void*>(kernel);
  if (key_fn == fn && key[0] == n && key[1] == m && key[2] == P) {
    *sh = last;
    return 0;
  }
  tts_lb2s_block(GT, n, m, P, sh);
  if (sh->smem > TTS_LB2_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = tts_smem_optin(kernel, static_cast<size_t>(sh->smem));
  if (err) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &sh->per_sm, kernel, sh->threads, sh->smem));
  if (err) return err;
  key_fn = fn;
  key[0] = n;
  key[1] = m;
  key[2] = P;
  last = *sh;
  return 0;
}

template <typename T, int W, bool GT>
static int launch_lb2_self_bounds(const void* rows, const void* limit1,
                                  const void* n_active, const void* ptm_t,
                                  const void* heads, const void* pairinfo,
                                  const void* tab, void* out, int R, int n,
                                  int m, int P, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  Lb2sShape sh;
  int err = tts_lb2s_shape<GT>(lb2_self_bounds_kernel<T, W, GT>, n, m, P, &sh);
  if (err) return err;
  // One wave, and no more blocks than R rows at 32 lanes a row fill.
  const long long need = (32LL * R + sh.threads - 1) / sh.threads;
  const long long wave = static_cast<long long>(sh.per_sm) * tts_sm_count();
  sh.blocks = static_cast<int>(need < wave ? need : wave);
  lb2_self_bounds_last = sh;
  lb2_self_bounds_kernel<T, W, GT><<<sh.blocks, sh.threads, sh.smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(limit1),
      static_cast<const int*>(n_active), static_cast<const int*>(ptm_t),
      static_cast<const int*>(heads), static_cast<const int4*>(pairinfo),
      static_cast<const typename Lb2Types<GT>::Tab*>(tab),
      static_cast<int*>(out), R, n, m, P, sh.ns, sh.rows);
  return static_cast<int>(cudaGetLastError());
}

// The launch at n's free-mask words: SMEM 1, 2, 4 or 8 (n <= 256), GLOBAL
// 4, 8, 16 or 32 (n <= 1024).
template <typename T>
static int launch_lb2_self_words(const void* rows, const void* limit1,
                                 const void* n_active, const void* ptm_t,
                                 const void* heads, const void* pairinfo,
                                 const void* tab, void* out, int R, int n,
                                 int m, int P, int route, void* stream) {
#define TTS_LB2S_LAUNCH(W, GT)                                              \
  launch_lb2_self_bounds<T, W, GT>(rows, limit1, n_active, ptm_t, heads,    \
                                   pairinfo, tab, out, R, n, m, P, stream)
  if (route == 1) {
    if (n > TTS_LB2_MAX_JOBS) return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 128) return TTS_LB2S_LAUNCH(4, true);
    if (n <= 256) return TTS_LB2S_LAUNCH(8, true);
    if (n <= 512) return TTS_LB2S_LAUNCH(16, true);
    return TTS_LB2S_LAUNCH(32, true);
  }
  if (n > TTS_LB2_SMEM_JOBS) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 32) return TTS_LB2S_LAUNCH(1, false);
  if (n <= 64) return TTS_LB2S_LAUNCH(2, false);
  if (n <= 128) return TTS_LB2S_LAUNCH(4, false);
  return TTS_LB2S_LAUNCH(8, false);
#undef TTS_LB2S_LAUNCH
}

// `route` 0: tab is the int16 table; 1: the int32 table (lb2_common.cuh).
#define TTS_LB2_SELF_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* rows, const void* limit1,                 \
                      const void* n_active, const void* ptm_t,              \
                      const void* heads, const void* pairinfo,              \
                      const void* tab, void* out, int R, int n, int m,      \
                      int P, int route, void* stream) {                     \
    return launch_lb2_self_words<T>(rows, limit1, n_active, ptm_t, heads,   \
                                    pairinfo, tab, out, R, n, m, P, route,  \
                                    stream);                                \
  }

TTS_LB2_SELF_ENTRY(lb2_self_bounds_i8, int8_t)
TTS_LB2_SELF_ENTRY(lb2_self_bounds_i32, int32_t)
