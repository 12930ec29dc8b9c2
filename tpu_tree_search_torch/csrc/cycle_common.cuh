// Shared device code of the fused search cycles (cycle_lb1.cu, cycle_lb2.cu,
// cycle_nqueens.cu, and the streamed ones through their headers; kernel 3,
// nqueens_labels.cu, takes its phase-keeping copies): the layout of the
// loop state tensor, the block size rule, the per-block counts and the
// emit's survivor offsets summed from them, the copies that keep a byte
// range's phase mod 16 (so the middle moves as aligned 16-byte words), and
// the emit of a block's survivors as one contiguous span of the pool.
#pragma once

#include "tts_common.cuh"

// The loop state: one small int32 device tensor `st` (mirrored by
// ST_* in tpu_tree_search_torch/ops/cycle.py).
enum {
  ST_SIZE = 0,
  ST_BEST = 1,
  ST_TREE = 2,
  ST_SOL = 3,
  ST_CYCLES = 4,
  ST_ACTIVE = 5,
  ST_CNT = 6,
  ST_START2 = 7,
  ST_BASE = 8,
  ST_RUNS = 9,  // the dispatch graph's body runs (dispatch_graph.cu)
  // The counter block (TTS_OBS=1, dispatch_cond_obs in dispatch_graph.cu):
  // eight slots in obs/counters.py SLOTS order, then the tree and sol it
  // last saw (st[2], st[3] accumulate over a dispatch).
  ST_CTR = 16,
  ST_CTR_TREE = 24,
  ST_CTR_SOL = 25,
  ST_LEN = 32,
};

// The loop condition of a K-cycle dispatch (`resident.py:421-423`) on a
// state's size and cycles: size >= m, size + M*n <= C (the headroom of one
// fan-out) and cycles < K. The dispatch graph's own nodes
// (dispatch_graph.cu) and a cycle that sets its while node's condition
// itself evaluate this one function.
__device__ __forceinline__ bool tts_loop_active(int size, int cycles, int m,
                                                long long Mn, int C, int K) {
  return size >= m && static_cast<long long>(size) + Mn <= C && cycles < K;
}

// A cycle's hold on the while node of the dispatch graph it runs in
// (`ops/dispatch.py` DispatchGraph): with `on`, the cycle is the node's
// whole body, and its emit (the last launch) counts the body's run in
// st[ST_RUNS] and sets the node's condition `h`: the last block from the
// state it has just written, block 0 of a no-op cycle to 0. So no
// condition node follows the cycle. The emit, not launch 1, does both: a
// store to st in launch 1 made the PFSP bounds launch a third slower on
// the H100 (PERF.md §6). cudaGraphSetConditional is legal only inside
// a graph launch: an eager cycle, and a cycle in a batched or mesh graph
// (whose own node sets the condition), pass `on` 0, and the flag, never
// the handle's value, gates the call. m, C and K are the loop
// condition's (the cycle's own arguments).
struct TtsCond {
  unsigned long long h;  // cudaGraphConditionalHandle
  int on;
  int m;
  int C;
  int K;
};

// The end of a body's run, by one thread of the emit: the run counted (a
// run past termination would show as more runs than cycles) and the
// node's condition set to `live`.
__device__ __forceinline__ void tts_cond_end(int* st, const TtsCond& c,
                                             bool live) {
  if (c.on) {
    st[ST_RUNS] += 1;
    cudaGraphSetConditional(c.h, live ? 1u : 0u);
  }
}

// The emit's early return on a no-op cycle (launch 1 found the loop
// condition false): block 0 ends the run with the condition cleared, so
// every path through the body sets it.
__device__ __forceinline__ void tts_cond_idle(int* st, const TtsCond& c) {
  if (blockIdx.x == 0 && threadIdx.x == 0) tts_cond_end(st, c, false);
}

// Parents of one block of the counting and emit launches (one warp scans
// their survivor counts, so at most 32).
#define TTS_CYCLE_PARENTS 32
// Threads of a counting or emit block (and of kernel 4's labels block) that
// loops over its slots, when the grid of one thread a slot does not fit on
// the card at once.
#define TTS_CYCLE_LOOP_THREADS 128

// Threads the card holds at once (SMs times threads an SM), read once.
static inline long long tts_resident_threads() {
  static long long cap = 0;
  if (!cap) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    cap = static_cast<long long>(sms) * per;
  }
  return cap;
}

// Threads of each of nblk blocks of `slots` slots: one a slot when the
// whole grid fits on the card at once (one wave), else `loop` threads that
// loop over the slots, so the grid is fewer waves.
static inline int tts_cycle_threads(int nblk, int slots, int loop) {
  const int t = tts_threads_for(slots);
  if (loop >= t || static_cast<long long>(nblk) * t <= tts_resident_threads())
    return t;
  return loop;
}

// Bytes of one block's region of the stash: its rows (`bytes` of them) at
// the phase mod 16 of their pool address, so the region is 16-aligned and
// holds up to 15 bytes of head room.
__host__ __device__ __forceinline__ int tts_stash_block_bytes(int bytes) {
  return (bytes + 15) / 16 * 16 + 16;
}

extern "C" int tts_cycle_parents_per_block() { return TTS_CYCLE_PARENTS; }

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The end of the counting launch, called by every thread of a block with
// the block's survivors and solutions in keeps and sols (thread 0's are
// used). The single-tile cycle (TILES false): the survivor count goes to
// blkcnt[b] for the emit's offsets, the solutions straight into st[3] (a
// reduction nothing reads this cycle). The streamed cycle (TILES true):
// the pair (survivors, solutions) goes to blkcnt[2b, 2b + 1], since its
// emit also places the tile boundaries' solution counts
// (emit_tile_bounds); its last emit block adds the cycle's solutions to
// st[3].
template <bool TILES>
__device__ __forceinline__ void cycle_publish_counts(int* st, int* blkcnt,
                                                     int keeps, int sols) {
  if (threadIdx.x == 0) {
    if constexpr (TILES) {
      reinterpret_cast<int2*>(blkcnt)[blockIdx.x] = make_int2(keeps, sols);
    } else {
      blkcnt[blockIdx.x] = keeps;
      if (sols) atomicAdd(&st[ST_SOL], sols);
    }
  }
}

// Copy the bytes [src, src + len) of device memory to d1 (device memory)
// and, unless null, d2 (shared memory), both 16-aligned: the byte at
// address a lands at offset a - floor16(src), i.e. the copies keep the
// source's phase mod 16. Aligned 16-byte words in the middle, single bytes
// at the two ends. All threads of the block take part.
__device__ __forceinline__ void copy_keep_phase(const uint8_t* src, int len,
                                                uint8_t* d1, uint8_t* d2) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  const uintptr_t end = a + len;
  const uintptr_t up = (a + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t a0 = up < end ? up : end;
  const uintptr_t dn = end & ~static_cast<uintptr_t>(15);
  const uintptr_t a1 = dn > a0 ? dn : a0;
  const int head = static_cast<int>(a0 - a);
  const int tail = static_cast<int>(end - a1);
  const int words = static_cast<int>((a1 - a0) / 16);
  const uint4* mid = reinterpret_cast<const uint4*>(a0);
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const uint4 v = mid[w];
    const size_t off = a0 - lo + 16 * static_cast<size_t>(w);
    *reinterpret_cast<uint4*>(d1 + off) = v;
    if (d2) *reinterpret_cast<uint4*>(d2 + off) = v;
  }
  for (int e = threadIdx.x; e < head + tail; e += blockDim.x) {
    const uintptr_t x = e < head ? a + e : a1 + (e - head);
    const uint8_t v = *reinterpret_cast<const uint8_t*>(x);
    d1[x - lo] = v;
    if (d2) d2[x - lo] = v;
  }
}

// The inverse: store [dst, dst + len) from the 16-aligned shared buffer s,
// where the byte for address a sits at s[a - floor16(dst)]. The bytes
// outside [dst, dst + len) are not written (other blocks own them).
__device__ __forceinline__ void store_keep_phase(uint8_t* dst, int len,
                                                 const uint8_t* s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  const uintptr_t end = a + len;
  const uintptr_t up = (a + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t a0 = up < end ? up : end;
  const uintptr_t dn = end & ~static_cast<uintptr_t>(15);
  const uintptr_t a1 = dn > a0 ? dn : a0;
  const int head = static_cast<int>(a0 - a);
  const int tail = static_cast<int>(end - a1);
  const int words = static_cast<int>((a1 - a0) / 16);
  uint4* mid = reinterpret_cast<uint4*>(a0);
  for (int w = threadIdx.x; w < words; w += blockDim.x)
    mid[w] = *reinterpret_cast<const uint4*>(s + (a0 - lo) + 16 * w);
  for (int e = threadIdx.x; e < head + tail; e += blockDim.x) {
    const uintptr_t x = e < head ? a + e : a1 + (e - head);
    *reinterpret_cast<uint8_t*>(x) = s[x - lo];
  }
}

// Per-parent survivor offsets of a block (one warp: rows <= 32 parents):
// s_off[p] = survivors of parents before p, from the W keep-mask words of
// each parent; returns the block's total to every lane of warp 0.
__device__ __forceinline__ int warp_parent_offsets(const uint32_t* s_mask,
                                                   int W, int rows,
                                                   int* s_off) {
  const int lane = threadIdx.x & 31;
  int c = 0;
  if (lane < rows)
    for (int w = 0; w < W; ++w) c += __popc(s_mask[lane * W + w]);
  int x = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  s_off[lane] = x - c;
  return __shfl_sync(0xffffffffu, x, 31);
}

// The first half of an emit block's offset: each thread's share of the
// survivor counts of the blocks before this one (blkcnt[0..b), 16 bytes a
// load, all in flight at once), summed a warp at a time into s_red[warp].
// The loads go out beside the block's stash loads. TILES (the streamed
// cycle's (survivors, solutions) pairs, two blocks a load): the solutions
// of the blocks before this one go to s_red[32 + warp] (s_red holds 64
// ints).
template <bool TILES>
__device__ __forceinline__ void emit_sum_counts(const int* __restrict__ blkcnt,
                                                int* s_red) {
  const int b = blockIdx.x;
  const int4* v = reinterpret_cast<const int4*>(blkcnt);
  int pre = 0;
  if constexpr (TILES) {
    int sol = 0;
#pragma unroll 4
    for (int j = threadIdx.x; j < (b >> 1); j += blockDim.x) {
      const int4 x = v[j];
      pre += x.x + x.z;
      sol += x.y + x.w;
    }
    if ((b & 1) && threadIdx.x == 0) {
      pre += blkcnt[2 * b - 2];
      sol += blkcnt[2 * b - 1];
    }
    sol = warp_sum(sol);
    if ((threadIdx.x & 31) == 0) s_red[32 + (threadIdx.x >> 5)] = sol;
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < (b >> 2); j += blockDim.x) {
      const int4 x = v[j];
      pre += x.x + x.y + x.z + x.w;
    }
    for (int j = ((b >> 2) << 2) + threadIdx.x; j < b; j += blockDim.x)
      pre += blkcnt[j];
  }
  pre = warp_sum(pre);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = pre;
}

// The second half, by warp 0 after a barrier: the per-parent offsets of
// warp_parent_offsets, the block's total in *s_total and its first pool
// row in *s_dst0 (base + the survivors of the blocks before it). The last
// block writes the rest of the cycle's state update: size = base +
// tree_inc, tree += tree_inc, cycles += 1; under a graph's while node
// (`cond`) it then ends the body's run with the node's condition set from
// that state (Mn: the chunk's child slots, M*n).
__device__ __forceinline__ void emit_block_offsets(int* st,
                                                   const uint32_t* s_mask,
                                                   int W, int rows,
                                                   int* s_off,
                                                   const int* s_red, int base,
                                                   int* s_dst0,
                                                   int* s_total,
                                                   const TtsCond& cond,
                                                   long long Mn) {
  const int lane = threadIdx.x & 31;
  const int total = warp_parent_offsets(s_mask, W, rows, s_off);
  const int pre = warp_sum(lane < static_cast<int>(blockDim.x >> 5)
                               ? s_red[lane] : 0);
  if (lane == 0) {
    *s_total = total;
    *s_dst0 = base + pre;
    if (blockIdx.x == gridDim.x - 1) {
      const int size = base + pre + total;
      const int cycles = st[ST_CYCLES] + 1;
      st[ST_SIZE] = size;
      st[ST_TREE] += pre + total;
      st[ST_CYCLES] = cycles;
      tts_cond_end(st, cond, tts_loop_active(size, cycles, cond.m, Mn,
                                             cond.C, cond.K));
    }
  }
}

// The streamed cycles' carry (kernels 9a, 9b and 9c), by warp 0 of an emit
// block after emit_block_offsets and a __syncwarp: the block's rows of the
// boundary row bnd, G + 1 rows of three ints (G = M / mt tiles). Row b is
// the chunk's parent b*mt: the survivors of the parents before it, their
// solutions (N-Queens: popped parents at depth N; PFSP: the leaves, one a
// popped parent at limit1 = n - 2), and the incumbent `best` the cycle
// ends with; row G holds the cycle's tree_inc and sol_inc. Every parent
// index is in one block, so each row is written once: by the block whose
// parent starts that tile (a tile boundary may fall anywhere in a block of
// TTS_CYCLE_PARENTS parents, and a block may hold several), and row G by
// the last block, which also adds sol_inc to st[3]. `pre` and `total` are
// the survivors of the blocks before this one and of this one, s_off[p]
// those of parent p's predecessors in the block, s_red[32..] the
// solutions of the blocks before this one by warp (emit_sum_counts<true>),
// and `sol` lane p's solution flag. The per-tile scalars (offs, cnt,
// sol_cum, best) of the TPU kernel are rows t and t + 1 of bnd
// (`ops/tiled.py` `scal_from_bounds`).
__device__ __forceinline__ void emit_tile_bounds(int* st, int* __restrict__ bnd,
                                                 int mt, int rows,
                                                 const int* s_off,
                                                 const int* s_red, int pre,
                                                 int total, bool sol,
                                                 int best) {
  const int lane = threadIdx.x & 31;
  const int presol = warp_sum(
      lane < static_cast<int>(blockDim.x >> 5) ? s_red[32 + lane] : 0);
  const unsigned flags = __ballot_sync(0xffffffffu, lane < rows && sol);
  const int i = blockIdx.x * TTS_CYCLE_PARENTS + lane;
  if (lane < rows && i % mt == 0) {
    int* r = bnd + 3 * (i / mt);
    r[0] = pre + s_off[lane];
    r[1] = presol + __popc(flags & ((1u << lane) - 1u));
    r[2] = best;
  }
  if (lane == 0 && blockIdx.x == gridDim.x - 1) {
    const int sols = presol + __popc(flags);
    int* r = bnd + 3 * ((i + rows) / mt);
    r[0] = pre + total;
    r[1] = sols;
    r[2] = best;
    st[ST_SOL] += sols;
  }
}

// The emit of one block: every kept slot (p, k) of its `rows` parents
// (bit k of parent p's W mask words) becomes a child, the parent row
// s_par + p*n with positions s_d[p] and k swapped and aux s_caux[p], at
// pool row dst_row0 + s_off[p] + (kept slots of p before k): the block's
// `total` survivors are one contiguous span of the pool in (parent, slot)
// order. The span is built in shared memory (s_span, s_aspan: 16-aligned,
// room for span_rows rows and their aux plus 16 bytes each) and stored
// as aligned 16-byte words, in waves of span_rows rows.
template <typename V, typename A>
__device__ void emit_block_children(V* __restrict__ pool_vals,
                                    A* __restrict__ pool_aux, int dst_row0,
                                    const V* s_par, const int* s_d,
                                    const int* s_caux, const uint32_t* s_mask,
                                    int W, const int* s_off, int rows, int n,
                                    int total, uint8_t* s_span,
                                    uint8_t* s_aspan, int span_rows) {
  const int slots = rows * n;
  // This thread's first slot and the stride between its slots, split once.
  const int p0 = static_cast<int>(threadIdx.x) / n;
  const int k0 = static_cast<int>(threadIdx.x) - p0 * n;
  const int dp = static_cast<int>(blockDim.x) / n;
  const int dk = static_cast<int>(blockDim.x) - dp * n;
  for (int r0 = 0; r0 < total; r0 += span_rows) {
    const int wr = min(span_rows, total - r0);
    V* dst = pool_vals + static_cast<size_t>(dst_row0 + r0) * n;
    A* adst = pool_aux + dst_row0 + r0;
    V* sv = reinterpret_cast<V*>(s_span +
                                 (reinterpret_cast<uintptr_t>(dst) & 15));
    A* sa = reinterpret_cast<A*>(s_aspan +
                                 (reinterpret_cast<uintptr_t>(adst) & 15));
    int p = p0, k = k0;
    for (int s = threadIdx.x; s < slots; s += blockDim.x) {
      const uint32_t* mk = s_mask + p * W;
      const int w = k >> 5;
      const uint32_t word = mk[w];
      if ((word >> (k & 31)) & 1u) {
        int rank = s_off[p] + __popc(word & ((1u << (k & 31)) - 1u)) - r0;
        for (int j = 0; j < w; ++j) rank += __popc(mk[j]);
        if (rank >= 0 && rank < wr) {
          const V* par = s_par + p * n;
          const int d = s_d[p];
          V* ch = sv + static_cast<size_t>(rank) * n;
          for (int j = 0; j < n; ++j) ch[j] = par[j];
          ch[d] = par[k];
          ch[k] = par[d];
          sa[rank] = static_cast<A>(s_caux[p]);
        }
      }
      p += dp;
      k += dk;
      if (k >= n) {
        k -= n;
        ++p;
      }
    }
    __syncthreads();
    store_keep_phase(reinterpret_cast<uint8_t*>(dst),
                     wr * n * static_cast<int>(sizeof(V)), s_span);
    store_keep_phase(reinterpret_cast<uint8_t*>(adst),
                     wr * static_cast<int>(sizeof(A)), s_aspan);
    __syncthreads();
  }
}
