// Shared device code of the lb2 kernels (lb2_bounds.cu, lb2_self_bounds.cu,
// cycle_lb2.cu): the shared-memory tables, the per-parent state and the
// two-machine Johnson bound lb2 (`c_bound_johnson.c:190-254`, forward
// branching, so the tails are the constant `min_tails` table).
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
// The TPU kernel reordered the free-job flags into Johnson order with a
// one-hot (P, n, n) matrix product and picked the pair's machines with
// one-hot selectors; here the ordered table holds the job id of each slot,
// and "job j is free" is a shared-memory lookup of j's position in the row
// (pos[j] > limit1, and j is not the job the child appends). All values are
// int32; the ordered table is packed as int16 (p0, p1, lag, job) — exact for
// every Taillard instance (times <= 99, lags <= 18 * 99), checked by the
// wrapper — so one 8-byte shared-memory load feeds each step.
#pragma once

#include "lb1_common.cuh"

// Most threads of an lb2 child-bound block: each keeps an m-long child front
// in shared memory, so the cap bounds that buffer at large n.
#define TTS_LB2_THREADS 256

// Rows of a self-bound block (one thread a row).
#define TTS_LB2_SELF_THREADS 128

struct Lb2Smem {
  int4* pair;           // P: (ma0, ma1, tails0, tails1)
  short4* tab;          // P*n: slot t of pair q = (p0, p1, lag, job)
  int* ptm;             // n*m job-major processing times
  int* heads;           // m: min_heads
  int* front;           // `fronts` fronts of m ints
  int* cf;              // child fronts, machine j of thread t at j*T + t
  unsigned char* pos;   // `rows` arrays of n job positions
};

// Bytes of an Lb2Smem holding `fronts` fronts, `cfs` child fronts and `rows`
// position arrays.
static inline size_t tts_lb2_smem_bytes(int n, int m, int P, int fronts,
                                        int cfs, int rows) {
  return 16 * static_cast<size_t>(P) + 8 * static_cast<size_t>(P) * n +
         4 * (static_cast<size_t>(n) * m + m +
              static_cast<size_t>(fronts + cfs) * m) +
         static_cast<size_t>(rows) * n;
}

__device__ __forceinline__ Lb2Smem lb2_smem_layout(unsigned char* smem,
                                                   int n, int m, int P,
                                                   int fronts, int cfs) {
  Lb2Smem s;
  s.pair = reinterpret_cast<int4*>(smem);
  s.tab = reinterpret_cast<short4*>(s.pair + P);
  s.ptm = reinterpret_cast<int*>(s.tab + P * n);
  s.heads = s.ptm + n * m;
  s.front = s.heads + m;
  s.cf = s.front + fronts * m;
  s.pos = reinterpret_cast<unsigned char*>(s.cf + cfs * m);
  return s;
}

__device__ __forceinline__ void lb2_load_tables(const Lb2Smem& s,
                                                const int* ptm_t,
                                                const int* heads,
                                                const int4* pairinfo,
                                                const short4* tab, int n,
                                                int m, int P) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) s.pair[i] = pairinfo[i];
  for (int i = threadIdx.x; i < P * n; i += blockDim.x) s.tab[i] = tab[i];
  for (int i = threadIdx.x; i < n * m; i += blockDim.x) s.ptm[i] = ptm_t[i];
  for (int i = threadIdx.x; i < m; i += blockDim.x) s.heads[i] = heads[i];
}

// lb2 from the front f (machine j at f[j * fs]) over the jobs j with
// pos[j * ps] > l1 and j != skip.
__device__ __forceinline__ int lb2_johnson(const Lb2Smem& s, const int* f,
                                           int fs, const unsigned char* pos,
                                           int ps, int l1, int skip, int n,
                                           int P) {
  int lb = 0;
  for (int q = 0; q < P; ++q) {
    const int4 pr = s.pair[q];
    int tmp0 = f[pr.x * fs];
    int tmp1 = f[pr.y * fs];
    const short4* e = s.tab + q * n;
    for (int t = 0; t < n; ++t) {
      const short4 v = e[t];
      if (static_cast<int>(pos[v.w * ps]) > l1 && v.w != skip) {
        tmp0 += v.x;
        tmp1 = max(tmp1, tmp0 + v.z) + v.y;
      }
    }
    lb = max(lb, max(tmp1 + pr.w, tmp0 + pr.z));
  }
  return lb;
}

// Per parent: its front (`pfsp_front`) and the position of each job.
template <typename T>
__device__ __forceinline__ void lb2_parent_state(const T* row, int l1, int n,
                                                 int m, const Lb2Smem& s,
                                                 int* front,
                                                 unsigned char* pos) {
  pfsp_front(row, l1, n, m, s.ptm, s.heads, front, 1);
  for (int i = 0; i < n; ++i)
    pos[static_cast<int>(row[i])] = static_cast<unsigned char>(i);
}

// lb2 of child slot k: append the job at position k (one add_forward step
// from the parent front, into this thread's column of s.cf), then the
// Johnson bound over the parent's free jobs but that one.
template <typename T>
__device__ __forceinline__ int lb2_child(const T* row, int k, int l1, int n,
                                         int m, int P, const Lb2Smem& s,
                                         const int* front,
                                         const unsigned char* pos) {
  const int job = static_cast<int>(row[k]);
  const int* p = s.ptm + job * m;
  const int stride = blockDim.x;
  int* cf = s.cf + threadIdx.x;
  int c = front[0] + p[0];
  cf[0] = c;
  for (int j = 1; j < m; ++j) {
    c = max(c, front[j]) + p[j];
    cf[j * stride] = c;
  }
  return lb2_johnson(s, cf, stride, pos, 1, l1, job, n, P);
}

// lb2 of the row itself (the staged self bound): its own front and job
// positions in this thread's columns of s.front and s.pos.
template <typename T>
__device__ __forceinline__ int lb2_row(const T* row, int l1, int n, int m,
                                       int P, const Lb2Smem& s) {
  const int stride = blockDim.x;
  int* f = s.front + threadIdx.x;
  unsigned char* pos = s.pos + threadIdx.x;
  pfsp_front(row, l1, n, m, s.ptm, s.heads, f, stride);
  for (int i = 0; i < n; ++i)
    pos[static_cast<int>(row[i]) * stride] = static_cast<unsigned char>(i);
  return lb2_johnson(s, f, stride, pos, stride, l1, -1, n, P);
}
