// Shared device code of the lb2 kernels (lb2_bounds.cu, lb2_self_bounds.cu,
// and through cycle_lb2.cuh cycle_lb2.cu and tiled_lb2.cu): the
// shared-memory tables, the per-parent state and the two-machine Johnson
// bound lb2 (`c_bound_johnson.c:190-254`, forward branching, so the tails
// are the constant `min_tails` table).
//
// For machine pair q = (ma0, ma1) and a schedule front f, lb2 runs the
// Johnson recurrence of `c_bound_johnson.c:190-209` over the free jobs in
// pair q's Johnson order: tmp0 = f[ma0], tmp1 = f[ma1], then per free job
// tmp0 += p0; tmp1 = max(tmp1, tmp0 + lag) + p1; the pair's bound is
// max(tmp1 + tails1, tmp0 + tails0) and lb2 the max over pairs from 0. In
// max-plus algebra this equals the closed form the TPU kernel evaluates with
// triangular matrix products (`_lb2_tile_lb`), so on integers the planes are
// bit-identical. The C early exit is dropped, as in the JAX package.
//
// Two ways to evaluate it:
//   - kernel 7 (lb2_self_bounds.cu: one bound a row, no children to share
//     a pass with) runs the recurrence itself: each pair's n ordered slots
//     tested against the row's free-job mask, on its own shared-memory
//     layout (`Lb2sSmem` in lb2_self_bounds.cu);
//   - `lb2p_bounds` evaluates every open child of a parent at once
//     (kernels 6, 8 and 9c). The children of one parent share the pair pass
//     but for one job. With w[t] = cum0[t] + lag[t] + suf1[t] over the
//     parent's free jobs in pair q's Johnson order, S0, S1 their total
//     times on ma0, ma1, f the child's front and an empty max -2^30
//     (`pfsp_device.NEG`, the JAX kernel's `neg`), the child that schedules
//     job i has
//       tmp0 = f0 + S0 - p0[i]
//       tmp1 = max(f1 + S1 - p1[i], f0 + max_{t<i} w[t] - p1[i],
//                  f0 + max_{t>i} w[t] - p0[i])
//     and pair q's bound max(tmp1 + tails1, tmp0 + tails0). Two of the
//     four terms depend on one machine only (f1 + S1 - p1 + tails1 on ma1,
//     f0 + S0 - p0 + tails0 on ma0): they are taken per child and machine.
//     The other two are f0 plus a prefix or suffix maximum: per (parent,
//     pair) one forward and one backward walk over the free jobs computes
//     them less f0 into A[job][ma0] (a max over the pairs of that ma0).
//     Then each open child takes max_j c[j] + A[job][j] over its front c.
//     That is P*(n + c*r) operations a parent with r free jobs, against
//     P*n*r for r runs of the recurrence; the walks read no child front.
//
// The TPU kernel reordered the free-job flags into Johnson order with a
// one-hot (P, n, n) matrix product and picked the pair's machines with
// one-hot selectors; here the ordered table holds the job id of each slot,
// its inverse the slot of each job, and a walk finds the free slots as bit
// masks. All values are int32. Two table routes, chosen from the shape
// before the launch by `ops/lb2_kernel.py` (`route`), which passes it to
// each entry; a launch refuses a route whose shared memory the block
// cannot hold:
//   - SMEM: the ordered table packed as int16 (p0, p1, lag, job), so one
//     8-byte shared-memory load feeds each step, byte job ids and slots
//     (n <= 256), and every table in shared memory. It takes every
//     instance whose values are below 2^15 and whose tables and one parent
//     fit the 227 KB a block may hold: ta001-ta100 (n <= 100) and the
//     200-job, 10-machine ta091-ta100;
//   - GLOBAL: the ordered table as int32 (16 bytes an entry), its inverse
//     as 16-bit slots and ptm read from device memory through L2, where
//     every block finds them after the first; only the per-parent state
//     (rows as 16-bit job ids, fronts, free work, the (job, ma0) terms) is
//     in shared memory. It takes the rest up to TTS_LB2_MAX_JOBS jobs:
//     ta101-ta120 (200 and 500 jobs on 20 machines: the int16 table alone
//     would be 0.3 and 0.76 MB), the n <= 100 shapes with more than 20
//     machines whose tables pass shared memory, e.g. (100, 22, 231), and a
//     lag or time past int16.
#pragma once

#include "lb1_common.cuh"

// -- The per-parent pair pass of kernels 6, 8 and 9c --------------------------

// The empty max of the pair pass.
#define TTS_LB2_NEG (-(1 << 30))
// Parents of a block when the whole grid fits on the card at once (one
// thread a (parent, pair) task: the shortest chains), and when it does not
// (threads loop over the tasks of more parents: fewer table loads).
#define TTS_LB2_FIT_PARENTS 2
#define TTS_LB2_LOOP_PARENTS 32
#define TTS_LB2_LOOP_THREADS 512
// Dynamic shared memory a block may ask for on sm_90 (232,448 B) less room
// for static variables; `SMEM_LIMIT` of ops/lb2_kernel.py.
#define TTS_LB2_SMEM_MAX (232448 - 1024)
// The most jobs of the GLOBAL route (32 free-mask words a task), and of
// the SMEM route (byte job ids and slots).
#define TTS_LB2_MAX_JOBS 1024
#define TTS_LB2_SMEM_JOBS 256

// The two routes' types: the ordered table's entry and a job id or slot.
template <bool GT>
struct Lb2Types {
  using Tab = short4;
  using Job = uint8_t;
};
template <>
struct Lb2Types<true> {
  using Tab = int4;
  using Job = uint16_t;
};

// The tables and per-parent state of a block of kernels 6, 8 and 9c. Per
// parent, machine j at stride ms = m | 1 (odd: parents, and the jobs of one
// parent, fall on different banks). SMEM (GT false): every table in shared
// memory, the ordered table of pair q at stride ns = n | 1 entries and its
// inverse at 4 * nw bytes, nw = ((n + 3) / 4) | 1 words (lanes on
// consecutive pairs read different banks). GLOBAL (GT true): pair, tab,
// inv, ptm and heads point into device memory (strides n), the rest is in
// shared memory.
template <bool GT>
struct Lb2ParSmem {
  using Tab = typename Lb2Types<GT>::Tab;
  using Job = typename Lb2Types<GT>::Job;
  int4* pair;    // P: (ma0, ma1, tails0, tails1)
  Tab* tab;      // P*ns: slot t of pair q = (p0, p1, lag, job)
  Job* inv;      // P*is: the slot of job j in pair q's order
  int* ptm;      // n*m job-major processing times
  int* heads;    // m: min_heads
  int* tails;    // m: min_tails of the machines a pair names, else NEG
  int* l1;       // PB: limit1, n - 1 for a row outside the chunk
  int* front;    // PB*ms: the parent front
  int* remain;   // PB*ms: the parent's free work by machine
  int* A;        // PB*n*ms: the pair walks' terms by (job, ma0)
  Job* jobs;     // PB*n: the parent rows
};

// The ordered table's stride (entries) and its inverse's (Job entries).
template <bool GT>
__host__ __device__ __forceinline__ int lb2p_ns(int n) {
  return GT ? n : (n | 1);
}
template <bool GT>
__host__ __device__ __forceinline__ int lb2p_is(int n) {
  return GT ? n : 4 * (((n + 3) / 4) | 1);
}

static inline size_t tts_lb2p_smem_bytes(bool gt, int n, int m, int P,
                                         int PB) {
  const size_t ms = m | 1, ns = n | 1, nw = ((n + 3) / 4) | 1;
  const size_t per = static_cast<size_t>(PB) *
                     (4 + 8 * ms + 4 * n * ms + (gt ? 2 : 1) * n);
  if (gt) return 4 * static_cast<size_t>(m) + per;
  return 16 * static_cast<size_t>(P) + 8 * static_cast<size_t>(P) * ns +
         4 * static_cast<size_t>(P) * nw +
         4 * (static_cast<size_t>(n) * m + 2 * m) + per;
}

// The most parents, up to `want`, whose block fits TTS_LB2_SMEM_MAX (1 when
// none does: the route then refuses the shape).
static inline int tts_lb2p_parents(bool gt, int n, int m, int P, int want) {
  int pb = want;
  while (pb > 1 && tts_lb2p_smem_bytes(gt, n, m, P, pb) > TTS_LB2_SMEM_MAX)
    --pb;
  return pb;
}

// Shared memory of the largest block kernels 6 and 8 launch at this shape
// and route.
static inline long long tts_lb2p_smem_max(bool gt, int n, int m, int P) {
  return static_cast<long long>(tts_lb2p_smem_bytes(
      gt, n, m, P, tts_lb2p_parents(gt, n, m, P, TTS_LB2_LOOP_PARENTS)));
}

// A block shape of kernels 6 and 8: parents and threads a block, its shared
// memory, whether the whole grid is on the card at once, and the route
// (`global`: 1 for GLOBAL).
struct Lb2Shape {
  int parents;
  int threads;
  int smem;
  int fits;
  int global;
};

static inline int tts_sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The shape for `rows` parents: TTS_LB2_FIT_PARENTS parents a block and one
// thread a (parent, pair) task when the card holds every block at once (by
// the occupancy of `kernel` at that shape), else TTS_LB2_LOOP_THREADS and
// the most parents, up to TTS_LB2_LOOP_PARENTS, that leave a full wave of
// blocks; the parents cut to what fits in shared memory. The
// last shape is kept, so a run of launches at one shape asks once. Opts
// `kernel` in to the block's shared memory. Refuses a shape its route does
// not take.
template <bool GT, typename K>
static inline int tts_lb2p_shape(K kernel, int rows, int n, int m, int P,
                                 Lb2Shape* sh) {
  static const void* key_fn = nullptr;
  static int key[4] = {-1, -1, -1, -1};
  static Lb2Shape last;
  if (n > (GT ? TTS_LB2_MAX_JOBS : TTS_LB2_SMEM_JOBS) ||
      tts_lb2p_smem_bytes(GT, n, m, P, 1) > TTS_LB2_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(kernel);
  if (key_fn == fn && key[0] == rows && key[1] == n && key[2] == m &&
      key[3] == P) {
    *sh = last;
    return 0;
  }
  int err = tts_smem_optin(kernel,
                           static_cast<size_t>(tts_lb2p_smem_max(GT, n, m, P)));
  if (err) return err;
  sh->global = GT;
  sh->parents = tts_lb2p_parents(GT, n, m, P, TTS_LB2_FIT_PARENTS);
  sh->threads = tts_threads_for(sh->parents * P);
  sh->smem = static_cast<int>(tts_lb2p_smem_bytes(GT, n, m, P, sh->parents));
  int per_sm = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, sh->threads, sh->smem));
  if (err) return err;
  const long long nblk = (rows + sh->parents - 1) / sh->parents;
  sh->fits = static_cast<long long>(per_sm) * tts_sm_count() >= nblk;
  // Else the most parents a block, halving from TTS_LB2_LOOP_PARENTS,
  // that still leaves at least a full wave of blocks.
  for (int want = TTS_LB2_LOOP_PARENTS; !sh->fits; want /= 2) {
    sh->parents = tts_lb2p_parents(GT, n, m, P, want);
    sh->threads = TTS_LB2_LOOP_THREADS;
    sh->smem = static_cast<int>(tts_lb2p_smem_bytes(GT, n, m, P, sh->parents));
    if (want <= TTS_LB2_FIT_PARENTS) break;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, sh->threads, sh->smem));
    if (err) return err;
    if ((rows + sh->parents - 1) / sh->parents >=
        static_cast<long long>(per_sm) * tts_sm_count())
      break;
  }
  key_fn = fn;
  key[0] = rows;
  key[1] = n;
  key[2] = m;
  key[3] = P;
  last = *sh;
  return 0;
}

// The block's layout. SMEM: every table in the block's shared memory (the
// tables are loaded by lb2p_load_tables). GLOBAL: the tables are the
// device-memory ones (`tab` int4 (P, n), `inv` 16-bit (P, n), ptm_t,
// heads), and shared memory holds the tails and the parents.
template <bool GT>
__device__ __forceinline__ Lb2ParSmem<GT> lb2p_smem_layout(
    unsigned char* smem, int n, int m, int P, int PB, const int* ptm_t,
    const int* heads, const int4* pairinfo,
    const typename Lb2Types<GT>::Tab* tab,
    const typename Lb2Types<GT>::Job* inv) {
  using Job = typename Lb2Types<GT>::Job;
  const int ms = m | 1;
  Lb2ParSmem<GT> s;
  int* rest;
  if constexpr (GT) {
    s.pair = const_cast<int4*>(pairinfo);
    s.tab = const_cast<int4*>(tab);
    s.inv = const_cast<Job*>(inv);
    s.ptm = const_cast<int*>(ptm_t);
    s.heads = const_cast<int*>(heads);
    s.tails = reinterpret_cast<int*>(smem);
    rest = s.tails + m;
  } else {
    s.pair = reinterpret_cast<int4*>(smem);
    s.tab = reinterpret_cast<short4*>(s.pair + P);
    s.inv = reinterpret_cast<unsigned char*>(s.tab + P * lb2p_ns<GT>(n));
    s.ptm = reinterpret_cast<int*>(s.inv + P * lb2p_is<GT>(n));
    s.heads = s.ptm + n * m;
    s.tails = s.heads + m;
    rest = s.tails + m;
  }
  s.l1 = rest;
  s.front = s.l1 + PB;
  s.remain = s.front + PB * ms;
  s.A = s.remain + PB * ms;
  s.jobs = reinterpret_cast<Job*>(s.A + PB * n * ms);
  return s;
}

// SMEM: the tables into shared memory; both: the pair tails set to NEG
// (lb2p_bounds sets those of the pairs' machines).
template <bool GT>
__device__ __forceinline__ void lb2p_load_tables(const Lb2ParSmem<GT>& s,
                                                 const int* ptm_t,
                                                 const int* heads,
                                                 const int4* pairinfo,
                                                 const short4* tab, int n,
                                                 int m, int P) {
  if constexpr (!GT) {
    const int ns = lb2p_ns<GT>(n), is = lb2p_is<GT>(n);
    for (int i = threadIdx.x; i < P; i += blockDim.x) s.pair[i] = pairinfo[i];
    for (int i = threadIdx.x; i < P * n; i += blockDim.x) {
      const int q = i / n;
      const int t = i - q * n;
      const short4 v = tab[i];
      s.tab[q * ns + t] = v;
      s.inv[is * q + v.w] = static_cast<unsigned char>(t);
    }
    for (int i = threadIdx.x; i < n * m; i += blockDim.x) s.ptm[i] = ptm_t[i];
    for (int j = threadIdx.x; j < m; j += blockDim.x) s.heads[j] = heads[j];
  }
  for (int j = threadIdx.x; j < m; j += blockDim.x) s.tails[j] = TTS_LB2_NEG;
}

// Parents p in [0, rows) of the block: row p (n jobs at rows_base + p*n)
// into s.jobs, its limit1 into s.l1. A parent
// outside [lo, hi) is not in the chunk: its limit1 becomes n - 1 (no free
// job, no open slot). A job id outside [0, n) (a row that is no
// permutation, outside the caller's valid rows) is read as job 0, so no
// index leaves the block's tables.
template <bool GT, typename T>
__device__ __forceinline__ void lb2p_load_rows(const Lb2ParSmem<GT>& s,
                                               const T* rows_base,
                                               const T* l1_base, int rows,
                                               int lo, int hi, int n) {
  using Job = typename Lb2Types<GT>::Job;
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int p = e / n;
    if (p >= lo && p < hi) {
      const int job = static_cast<int>(rows_base[e]);
      s.jobs[e] = static_cast<Job>(
          static_cast<unsigned>(job) < static_cast<unsigned>(n) ? job : 0);
    }
  }
  for (int p = threadIdx.x; p < rows; p += blockDim.x)
    s.l1[p] = (p >= lo && p < hi) ? static_cast<int>(l1_base[p]) : n - 1;
}

// One (parent, pair) task: the forward and the backward walk over the
// parent's free jobs in pair q's Johnson order. The terms of the closed
// form that hold the child's front at ma0 and a prefix or suffix maximum,
// less that front, go to A[job][ma0] with a shared-memory atomicMax; the
// others depend on one machine only and are taken per child (lb2p_bounds).
// The free slots are found once, as W bit masks over the ordered slots:
// bit inv[job] of each free job (r steps, not one a slot).
template <bool GT, int W>
__device__ __forceinline__ void lb2p_pair(const Lb2ParSmem<GT>& s, int p,
                                          int q, int l1, int n, int m) {
  using Tab = typename Lb2Types<GT>::Tab;
  using Job = typename Lb2Types<GT>::Job;
  const int ms = m | 1;
  const int4 pr = s.pair[q];
  const Tab* e = s.tab + q * lb2p_ns<GT>(n);
  const Job* inv = s.inv + lb2p_is<GT>(n) * q;
  const Job* row = s.jobs + p * n;
  int* A = s.A + p * n * ms + pr.x;
  const int S0 = s.remain[p * ms + pr.x];
  const int S1 = s.remain[p * ms + pr.y];
  uint32_t mask[W];
#pragma unroll
  for (int w = 0; w < W; ++w) mask[w] = 0;
  for (int k = max(l1 + 1, 0); k < n; ++k) {
    const int t = inv[row[k]];
#pragma unroll
    for (int w = 0; w < W; ++w)
      if ((t >> 5) == w) mask[w] |= 1u << (t & 31);
  }
  // Forward: c0 = cum0 (inclusive), c1 = cum1 (exclusive), premax the max
  // of u = cum0 + lag - cum1 over the earlier free jobs (w = u + S1).
  int c0 = 0, c1 = 0, premax = TTS_LB2_NEG;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t bits = mask[w];
    while (bits) {
      const Tab v = e[32 * w + __ffs(bits) - 1];
      bits &= bits - 1;
      c0 += v.x;
      if (premax != TTS_LB2_NEG)
        atomicMax(A + v.w * ms, premax + S1 - v.y + pr.w);
      premax = max(premax, c0 + v.z - c1);
      c1 += v.y;
    }
  }
  // Backward: s1 = suf1 (inclusive), s0 = suf0 (exclusive), sufmax the max
  // of v = lag + suf1 - suf0 over the later free jobs (w = v + S0).
  int s0 = 0, s1 = 0, sufmax = TTS_LB2_NEG;
#pragma unroll
  for (int w = W - 1; w >= 0; --w) {
    uint32_t bits = mask[w];
    while (bits) {
      const int b = 31 - __clz(bits);
      bits ^= 1u << b;
      const Tab v = e[32 * w + b];
      s1 += v.y;
      if (sufmax != TTS_LB2_NEG)
        atomicMax(A + v.w * ms, sufmax + S0 - v.x + pr.w);
      sufmax = max(sufmax, v.z + s1 - s0);
      s0 += v.x;
    }
  }
}

// Parent p's front and free work by a group of G lanes of one warp (G a
// power of two, m <= G <= 32; lane j of the group is machine j; gmask
// names the group's lanes): the front as a wavefront over the machines
// (kernel 2's `lb1_parent_state_lanes`, l1 + m steps in place of
// (l1 + 1) * m dependent ones), the free work as lane j's sum over the
// free positions. Every lane of the group calls it.
template <bool GT>
__device__ __forceinline__ void lb2p_parent_lanes(const Lb2ParSmem<GT>& s,
                                                  int p, int l1, int n, int m,
                                                  int G, unsigned gmask) {
  const int ms = m | 1;
  const typename Lb2Types<GT>::Job* row = s.jobs + p * n;
  const int j = static_cast<int>(threadIdx.x) & (G - 1);
  const bool mine = j < m;
  int f = (l1 == -1 && mine) ? s.heads[j] : 0;
  for (int step = 0; step < l1 + m; ++step) {
    const int left = __shfl_up_sync(gmask, f, 1, G);
    const int i = step - j;
    if (mine && i >= 0 && i <= l1)
      f = (j == 0 ? f : max(f, left)) + s.ptm[row[i] * m + j];
  }
  if (mine) {
    int rem = 0;
    for (int k = max(l1 + 1, 0); k < n; ++k) rem += s.ptm[row[k] * m + j];
    s.front[p * ms + j] = f;
    s.remain[p * ms + j] = rem;
  }
}

// The pair tasks of the block at W free-mask words: 1, 2 or 4 by n through
// n = 128 (the kernels' narrow instantiation, WIDE false), 8, 16 or 32
// past it (WIDE true, a kernel of its own: the wide walks' registers and
// code stay out of the narrow kernels).
template <bool GT, bool WIDE>
__device__ __forceinline__ void lb2p_pairs(const Lb2ParSmem<GT>& s, int p,
                                           int q, int l1, int n, int m) {
  if constexpr (!WIDE) {
    if (n <= 32)
      lb2p_pair<GT, 1>(s, p, q, l1, n, m);
    else if (n <= 64)
      lb2p_pair<GT, 2>(s, p, q, l1, n, m);
    else
      lb2p_pair<GT, 4>(s, p, q, l1, n, m);
  } else if constexpr (!GT) {
    lb2p_pair<GT, 8>(s, p, q, l1, n, m);
  } else {
    if (n <= 256)
      lb2p_pair<GT, 8>(s, p, q, l1, n, m);
    else if (n <= 512)
      lb2p_pair<GT, 16>(s, p, q, l1, n, m);
    else
      lb2p_pair<GT, 32>(s, p, q, l1, n, m);
  }
}

// Whether n takes the kernels' WIDE instantiation (more than 128 jobs).
static inline bool tts_lb2p_wide(int n) { return n > 128; }

// lb2 of every open slot (k > limit1) of the block's `rows` parents, after
// lb2p_load_tables and lb2p_load_rows and a barrier: `emit(p, k, lb)` is
// called once for each. First the parent fronts and free work, as
// wavefronts over the machines (`lb2p_parent_lanes`; one thread a parent
// past 32 machines), beside the pair terms of the free jobs set to NEG;
// then the (parent, pair) tasks, consecutive threads on consecutive pairs
// of one parent (the same free count, so their walks run in step); then,
// one thread an open slot, the child front (one add_forward step) and its
// bound:
//   max(0, max_j c[j] + A[job][j], max_j c[j] + S[j] - p[j] + tails[j]),
// the second over the machines some pair names (T1 and T4 of the closed
// form depend on one machine).
template <bool GT, bool WIDE, typename F>
__device__ __forceinline__ void lb2p_bounds(const Lb2ParSmem<GT>& s, int rows,
                                            int n, int m, int P, F emit) {
  const int ms = m | 1;
  const int t = threadIdx.x;
  for (int q = t; q < P; q += blockDim.x) {  // same value for a machine
    const int4 pr = s.pair[q];
    s.tails[pr.x] = pr.z;
    s.tails[pr.y] = pr.w;
  }
  for (int pk = t; pk < rows * n; pk += blockDim.x) {  // parent p, slot k
    const int p = pk / n;
    if (pk - p * n > s.l1[p]) {
      int* a = s.A + (p * n + s.jobs[pk]) * ms;
      for (int j = 0; j < m; ++j) a[j] = TTS_LB2_NEG;
    }
  }
  if (m <= 32) {
    int G = 1;
    while (G < m) G <<= 1;
    const int groups = static_cast<int>(blockDim.x) / G;
    const unsigned gmask =
        G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((t & 31) & ~(G - 1));
    for (int p = t / G; p < rows; p += groups) {
      if (s.l1[p] < n - 1) lb2p_parent_lanes(s, p, s.l1[p], n, m, G, gmask);
    }
  } else {
    Lb1Smem s1;
    s1.ptm = s.ptm;
    s1.heads = s.heads;
    for (int p = t; p < rows; p += blockDim.x) {
      if (s.l1[p] < n - 1)
        lb1_parent_state(s.jobs + p * n, s.l1[p], n, m, s1, s.front + p * ms,
                         s.remain + p * ms);
    }
  }
  __syncthreads();
  for (int task = t; task < rows * P; task += blockDim.x) {
    const int p = task / P;
    const int l1 = s.l1[p];
    if (l1 >= n - 1) continue;
    lb2p_pairs<GT, WIDE>(s, p, task - p * P, l1, n, m);
  }
  __syncthreads();
  for (int e = t; e < rows * n; e += blockDim.x) {
    const int p = e / n;
    const int k = e - p * n;
    if (k <= s.l1[p]) continue;
    const int job = s.jobs[e];
    const int* f = s.front + p * ms;
    const int* S = s.remain + p * ms;
    const int* pt = s.ptm + job * m;
    const int* a = s.A + (p * n + job) * ms;
    int c = 0, lb = 0;
    for (int j = 0; j < m; ++j) {
      const int pj = pt[j];
      c = (j == 0 ? f[0] : max(c, f[j])) + pj;
      lb = max(lb, c + max(a[j], S[j] - pj + s.tails[j]));
    }
    emit(p, k, lb);
  }
}
