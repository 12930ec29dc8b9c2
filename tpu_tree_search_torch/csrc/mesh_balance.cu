// The mesh-resident tier's balance step, a node of its dispatch graph: the
// counterpart of `shard_step`'s `lax.pmin` incumbent fold and ring
// diffusion (tpu_tree_search/parallel/resident_mesh.py:200-270). Not a TPU
// kernel: on the TPU these are XLA collectives over ICI; here the D pool
// shards sit on one card, so the collective is three launches over their
// memory. The plain version is `mesh_balance_plain` (ops/mesh.py).
//
// The operands: the (D, ST_LEN) int32 loop states (cycle_common.cuh
// layout, a row a shard), the (D, C, n) pool rows and (D, C) pool column
// as bytes (`rowb`, `auxb` bytes a row), a staging copy of D / 2 shards'
// rows and column, and a (D, 4) int32 plan.
//   1. `mesh_plan` (one block, a thread a shard): best := the min of the
//      shards' incumbents (the pmin) written to every shard; with D > 1
//      each shard's gift to its right neighbour and its intake from its
//      left one, by the JAX arithmetic (:207-233): shard d gives to
//      (d + 1) % D iff the receiver holds < m, the donor >= 2m, and the
//      receiver has room for T + M*n more rows; the gift is
//      min(size / 2, T). Each donor gets a staging slot, in shard order: a
//      donor's right neighbour is a receiver and no shard both gives and
//      takes (>= 2m and < m), so at most D / 2 shards give. The plan keeps
//      (size before, gift, intake, slot); the sizes become
//      size - gift + intake. It also adds the round's tree, sol, cycles and
//      body runs to the dispatch's sums (ST_MESH_*; the next round's init
//      zeroes the round's own) and, on the last round, writes the sums back
//      where the host reads a dispatch's counts, and zeroes the counter
//      block's last-seen tree and sol (the next round counts from zero).
//   2. `mesh_move` (a grid a shard): a receiver copies its left
//      neighbour's first `intake` rows to its rows [size, size + intake)
//      (the JAX `_append`, :256-263, of the live part of the T block); a
//      donor copies its live rows past the gift, [gift, size), to its
//      staging slot. This launch reads only donors and writes only
//      receivers and the staging copy: every donated row is read before
//      anything is written over it, at D = 2 too.
//   3. `mesh_shed` (a grid a shard): a donor copies its staged rows back
//      to its rows [0, size - gift): the front it gave is dropped and the
//      live rows keep their order (the JAX `jnp.roll`, :240-250, whose
//      rows past the live prefix are garbage). A shift in place by many
//      blocks would read rows that other blocks have already written;
//      hence the staging copy.
// The copies move 16-byte words where source and destination share their
// address mod 16, else 4-byte words, four loads in flight a thread.
// What bounds it: bytes. Without a gift, the plan's few words and two
// launches that return at once; with one, the donated rows once and the
// donor's kept rows twice (the staging round trip, twice the least
// traffic for them). A gift moves at most T rows, and only to a shard
// that is starving, so the step is rare work.
#include "cycle_common.cuh"

// The dispatch's sums over its rounds (words the cycles leave alone).
enum {
  ST_MESH_TREE = 10,
  ST_MESH_SOL = 11,
  ST_MESH_CYCLES = 12,
  ST_MESH_RUNS = 13,
  // Row 0 only: the condition node's runs, the sum over the rounds of the
  // most body runs a shard made in a round.
  ST_MESH_COND = 14,
};

#define TTS_MESH_MAX_SHARDS 1024
#define TTS_MESH_THREADS 256
#define TTS_MESH_BLOCKS 128

__device__ __forceinline__ int* mesh_row(int* st, int d) {
  return st + static_cast<long long>(d) * ST_LEN;
}

__global__ void mesh_plan(int* st, int D, int m, int T, long long Mn, int C,
                          int first, int last, int* plan) {
  __shared__ int s_size[TTS_MESH_MAX_SHARDS];
  __shared__ int s_best[TTS_MESH_MAX_SHARDS];
  __shared__ int s_runs[TTS_MESH_MAX_SHARDS];
  __shared__ int s_give[TTS_MESH_MAX_SHARDS];
  __shared__ int s_slot[TTS_MESH_MAX_SHARDS];
  __shared__ int s_fold[2];
  const int d = threadIdx.x;
  if (d < D) {
    const int* s = mesh_row(st, d);
    s_size[d] = s[ST_SIZE];
    s_best[d] = s[ST_BEST];
    s_runs[d] = s[ST_RUNS];
  }
  __syncthreads();
  int sz = 0, give = 0, take = 0;
  if (d < D) {
    sz = s_size[d];
    if (D > 1) {
      const int right = s_size[(d + 1) % D];
      const int left = s_size[(d + D - 1) % D];
      if (right < m && sz >= 2 * m &&
          static_cast<long long>(right) + T + Mn <= C)
        give = min(sz / 2, T);
      if (sz < m && left >= 2 * m &&
          static_cast<long long>(sz) + T + Mn <= C)
        take = min(left / 2, T);
    }
    s_give[d] = give;
  }
  __syncthreads();
  if (d == 0) {
    int best = s_best[0], runs = s_runs[0], slots = 0;
    for (int i = 0; i < D; ++i) {
      best = min(best, s_best[i]);
      runs = max(runs, s_runs[i]);
      s_slot[i] = s_give[i] ? slots++ : -1;
    }
    s_fold[0] = best;
    s_fold[1] = runs;
  }
  __syncthreads();
  if (d >= D) return;
  plan[4 * d] = sz;
  plan[4 * d + 1] = give;
  plan[4 * d + 2] = take;
  plan[4 * d + 3] = s_slot[d];
  int* s = mesh_row(st, d);
  s[ST_SIZE] = sz - give + take;
  s[ST_BEST] = s_fold[0];
  if (first) {
    s[ST_MESH_TREE] = s[ST_TREE];
    s[ST_MESH_SOL] = s[ST_SOL];
    s[ST_MESH_CYCLES] = s[ST_CYCLES];
    s[ST_MESH_RUNS] = s[ST_RUNS];
  } else {
    s[ST_MESH_TREE] += s[ST_TREE];
    s[ST_MESH_SOL] += s[ST_SOL];
    s[ST_MESH_CYCLES] += s[ST_CYCLES];
    s[ST_MESH_RUNS] += s[ST_RUNS];
  }
  if (d == 0) s[ST_MESH_COND] = (first ? 0 : s[ST_MESH_COND]) + s_fold[1];
  s[ST_CTR_TREE] = 0;
  s[ST_CTR_SOL] = 0;
  if (last) {
    s[ST_TREE] = s[ST_MESH_TREE];
    s[ST_SOL] = s[ST_MESH_SOL];
    s[ST_CYCLES] = s[ST_MESH_CYCLES];
    s[ST_RUNS] = s[ST_MESH_RUNS];
  }
}

// Items [0, n) by the threads of the grid's x dimension, each thread
// loading U items (a grid stride apart) before it stores them: U loads in
// flight a thread, enough of them to keep the card's memory busy from a
// grid of TTS_MESH_BLOCKS blocks a shard.
template <int U, typename Load, typename Store>
__device__ __forceinline__ void mesh_stride(long long n, Load load,
                                            Store store) {
  const long long tid =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid; i < n; i += U * step) {
    decltype(load(0LL)) v[U];
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (i + k * step < n) v[k] = load(i + k * step);
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (i + k * step < n) store(i + k * step, v[k]);
  }
}

// Bytes [0, n) of src to dst (not overlapping): 16-byte words where dst
// and src share their address mod 16, else 4-byte words of dst, the
// source's words funnel-shifted into place where the two differ mod 4;
// the bytes before dst's first word and after its last one alone. A
// shifted read may take up to 3 bytes before src, inside its first
// aligned word, and drops them.
__device__ __forceinline__ void mesh_copy(uint8_t* dst, const uint8_t* src,
                                          long long n) {
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const int w = ((da ^ sa) & 15) == 0 ? 16 : 4;
  long long head = static_cast<long long>((w - (da & (w - 1))) & (w - 1));
  if (head > n) head = n;
  const long long words = (n - head) / w;
  const long long tail = head + words * w;
  auto byte_at = [=](long long i) { return src[i < head ? i : tail + i - head]; };
  auto put_byte = [=](long long i, uint8_t b) {
    dst[i < head ? i : tail + i - head] = b;
  };
  mesh_stride<1>(head + n - tail, byte_at, put_byte);
  uint8_t* d = dst + head;
  const uint8_t* s = src + head;
  if (w == 16) {
    uint4* dw = reinterpret_cast<uint4*>(d);
    const uint4* sw = reinterpret_cast<const uint4*>(s);
    mesh_stride<4>(words, [=](long long i) { return sw[i]; },
                   [=](long long i, uint4 v) { dw[i] = v; });
    return;
  }
  uint32_t* dw = reinterpret_cast<uint32_t*>(d);
  const int r = static_cast<int>(reinterpret_cast<uintptr_t>(s) & 3);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(s - r);
  auto put = [=](long long i, uint32_t v) { dw[i] = v; };
  if (r == 0)
    mesh_stride<4>(words, [=](long long i) { return sw[i]; }, put);
  else
    mesh_stride<4>(words,
                   [=](long long i) {
                     return __funnelshift_r(sw[i], sw[i + 1], 8 * r);
                   },
                   put);
}

__global__ void mesh_move(uint8_t* vals, uint8_t* aux, uint8_t* stage_vals,
                          uint8_t* stage_aux, const int* plan, int D,
                          long long C, int rowb, int auxb) {
  const int d = blockIdx.y;
  const int sz = plan[4 * d], give = plan[4 * d + 1], take = plan[4 * d + 2];
  const int slot = plan[4 * d + 3];
  const long long shard_v = C * rowb, shard_a = C * auxb;
  if (take) {
    const int left = (d + D - 1) % D;
    mesh_copy(vals + d * shard_v + static_cast<long long>(sz) * rowb,
              vals + left * shard_v, static_cast<long long>(take) * rowb);
    mesh_copy(aux + d * shard_a + static_cast<long long>(sz) * auxb,
              aux + left * shard_a, static_cast<long long>(take) * auxb);
  }
  if (give) {
    const long long rows = sz - give;
    mesh_copy(stage_vals + slot * shard_v,
              vals + d * shard_v + static_cast<long long>(give) * rowb,
              rows * rowb);
    mesh_copy(stage_aux + slot * shard_a,
              aux + d * shard_a + static_cast<long long>(give) * auxb,
              rows * auxb);
  }
}

__global__ void mesh_shed(uint8_t* vals, uint8_t* aux,
                          const uint8_t* stage_vals,
                          const uint8_t* stage_aux, const int* plan,
                          long long C, int rowb, int auxb) {
  const int d = blockIdx.y;
  const int sz = plan[4 * d], give = plan[4 * d + 1];
  if (!give) return;
  const int slot = plan[4 * d + 3];
  const long long shard_v = C * rowb, shard_a = C * auxb;
  const long long rows = sz - give;
  mesh_copy(vals + d * shard_v, stage_vals + slot * shard_v, rows * rowb);
  mesh_copy(aux + d * shard_a, stage_aux + slot * shard_a, rows * auxb);
}

// The plan alone on `stream` (the mesh over several device groups: the
// states of all D shards gathered on one card, the moves made on each
// group's card). Returns the CUDA error, 0 on success.
extern "C" int mesh_plan_enqueue(void* st, int D, void* plan, int C, int m,
                                 int T, long long Mn, int first, int last,
                                 void* stream) {
  if (D < 1 || D > TTS_MESH_MAX_SHARDS)
    return static_cast<int>(cudaErrorInvalidValue);
  mesh_plan<<<1, tts_threads_for(D), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(st), D, m, T, Mn, C, first, last,
      static_cast<int*>(plan));
  return static_cast<int>(cudaGetLastError());
}

// One balance step on `stream`: `mesh_plan`, then with D > 1 `mesh_move`
// and `mesh_shed`. `first`/`last`: whether this is the dispatch's first or
// last round. Returns the CUDA error, 0 on success.
extern "C" int mesh_balance_enqueue(void* st, int D, void* vals, void* aux,
                                    void* stage_vals, void* stage_aux,
                                    void* plan, int rowb, int auxb, int C,
                                    int m, int T, long long Mn, int first,
                                    int last, void* stream) {
  if (D < 1 || D > TTS_MESH_MAX_SHARDS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mesh_plan<<<1, tts_threads_for(D), 0, s>>>(static_cast<int*>(st), D, m, T,
                                              Mn, C, first, last,
                                              static_cast<int*>(plan));
  cudaError_t err = cudaGetLastError();
  if (err || D == 1) return static_cast<int>(err);
  const dim3 grid(TTS_MESH_BLOCKS, D);
  mesh_move<<<grid, TTS_MESH_THREADS, 0, s>>>(
      static_cast<uint8_t*>(vals), static_cast<uint8_t*>(aux),
      static_cast<uint8_t*>(stage_vals), static_cast<uint8_t*>(stage_aux),
      static_cast<const int*>(plan), D, C, rowb, auxb);
  err = cudaGetLastError();
  if (err) return static_cast<int>(err);
  mesh_shed<<<grid, TTS_MESH_THREADS, 0, s>>>(
      static_cast<uint8_t*>(vals), static_cast<uint8_t*>(aux),
      static_cast<const uint8_t*>(stage_vals),
      static_cast<const uint8_t*>(stage_aux), static_cast<const int*>(plan),
      C, rowb, auxb);
  return static_cast<int>(cudaGetLastError());
}
