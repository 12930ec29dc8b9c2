// Kernel 3: N-Queens diagonal-safety labels of every candidate slot of a
// chunk of parents.
//
// Replaces the TPU kernel `_nqueens_kernel` (tpu_tree_search/ops/pallas_kernels.py,
// built by `_nqueens_call`, tile body `_nqueens_tile_labels`), entry
// `nqueens_labels`, and the TPU kernel `_eval_nqueens_kernel`
// (tpu_tree_search/ops/megakernel.py, built by `_eval_nqueens_call`), the
// same labels tile by tile: `ops/tiled.streamed_eval_bounds` launches this
// kernel for it and widens the labels to int32.
//
// In:  board (B, N) uint8, depth (B,) of type D (int8 or int32, the device
//      pool's storage types), N <= 256 (what a uint8 board holds), g >= 1
//      rounds.
// Out: (B, N) uint8; slot k of parent b is 1 iff the queen board[b, k],
//      placed at column depth_b, clashes with no placed queen board[b, i]
//      (i < depth_b) on either diagonal; 0 for k < depth_b.
//
// What bounds it on an H100: at g = 1, memory and launch latency. Each
// parent moves 2N + 1 bytes (its row in, its labels out, its depth), so a
// 50,000-parent chunk at N = 15 moves 1.55 MB (0.46 us at 3.35 TB/s) and
// the launch costs more. The compares, 4 integer operations per (placed
// queen, open slot) and round, are g * sum depth*(N - depth) * 4: at
// g = 256 they bound it.
//
// Design. A block of TTS_NQL_PARENTS threads takes tiles of as many
// parents in turn, or of fewer (halved while the tiles are fewer than the
// SMs, until a tile's slots fit the block's threads); the grid is as many
// blocks as the card holds at once (registers and shared memory decide,
// `cudaOccupancyMaxActiveBlocks...`), at most one a tile, so the chunk is
// one wave. For each tile:
//   1. the rows move into shared memory as aligned 16-byte words
//      (`copy_keep_phase`, which takes a board view at any address), and
//      the labels' staging buffer is cleared (the slots k < depth stay 0);
//   2. one thread a parent packs its diagonal offsets once, outside the
//      rounds, four queens a word: u_i = board[i] + (depth - i) and
//      w_i = board[i] - (depth - i) + 64, so the candidate v clashes with
//      queen i iff v == u_i or v + 64 == w_i. Unplaced queens (and the
//      bytes past N of the last word) get 0x7F, which no candidate in
//      [0, 32) equals. It counts its open slots k >= depth;
//   3. a block scan of the open counts (a shuffle scan a warp, one
//      barrier) numbers the tile's (parent, open slot) items, so no thread
//      runs a closed slot and a warp holds the open slots of a few parents;
//   4. one thread an item runs the g rounds: each round the candidate is
//      made opaque (the empty asm: nvcc can neither hoist the compares out
//      of the round loop nor fold the rounds), broadcast to the four bytes,
//      and compared with every word of placed queens by an XOR and a
//      zero-byte test. Every byte of v ^ u and (v + 64) ^ w lies below
//      0x80, so a byte is zero iff adding 0x7F leaves its top bit clear,
//      and no carry crosses a byte: 5 instructions for 4 queens, where the
//      scalar check took about 6 for 1. The label goes to the staging
//      buffer;
//   5. the labels move out as aligned 16-byte words (`store_keep_phase`).
// A tile whose slots the block's threads cover (the tiles of a small
// chunk) skips steps 2-5 past the rows' barrier: one thread a slot packs
// its parent's offsets itself, runs the rounds and stores its label.
// The words' arithmetic needs every byte of the row below 32, as every
// board the search makes has (N <= 32): a parent with a byte of 32 or more
// takes the scalar check of the fused cycle (`nq_label`), so the labels are
// exact for any input. The g rounds stay real work: the reference uses g
// as a workload knob, and the JAX package keeps them with a fori_loop for
// the same reason.
//
// Boards wider than 32 (N up to 256) take neither the packed words nor the
// tiles: `nqueens_labels_wide_kernel` runs the scalar check (`nq_label`)
// one thread a (parent, slot), reading the row from device memory through
// the caches. The packed compare is for the boards the search times
// (N <= 32); the wide boards only need to be right.
#include "cycle_common.cuh"
#include "nqueens_common.cuh"

// Threads of a block, and the most parents of a tile.
#define TTS_NQL_PARENTS 128

// The diagonal offsets of one parent (its N bytes at s + off in shared
// memory, s 16-aligned, at depth d) packed into NW words: uw[j].x the u
// bytes and uw[j].y the w bytes of queens 4j..4j+3, 0x7F where no queen is
// placed. Returns whether a byte of the row is 32 or more (the words do
// not hold such a row).
template <int NW>
__device__ __forceinline__ bool nq_pack(const uint8_t* s, int off, int d,
                                        int N, uint2* uw) {
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(s + (off & ~3));
  const uint32_t sh = (off & 3) * 8;
  const int dd = min(max(d, 0), N);
  uint32_t x = w32[0], bytes = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t y = w32[j + 1];
    const uint32_t bw = __funnelshift_r(x, y, sh);  // bytes 4j..4j+3
    x = y;
    const int in_row = min(max(N - 4 * j, 0), 4);
    const int placed = min(max(dd - 4 * j, 0), 4);
    const uint32_t pm = static_cast<uint32_t>((1ull << (8 * placed)) - 1);
    bytes |= bw & static_cast<uint32_t>((1ull << (8 * in_row)) - 1);
    // depth - i for i = 4j + b in byte b (bytes past the placed ones may
    // borrow; they are masked).
    const uint32_t dist =
        static_cast<uint32_t>(dd - 4 * j) * 0x01010101u - 0x03020100u;
    const uint32_t none = 0x7f7f7f7fu & ~pm;
    uw[j] = make_uint2(((bw + dist) & pm) | none,
                       ((bw + 0x40404040u - dist) & pm) | none);
  }
  return (bytes & 0xe0e0e0e0u) != 0;
}

// 1 iff the candidate v clashes with none of the NW words of packed
// offsets (nq_pack), checked g times.
template <int NW>
__device__ __forceinline__ int nq_packed_label(const uint2* uw, uint32_t v,
                                               int g) {
  uint2 q[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) q[j] = uw[j];
  int safe = 1;
#pragma unroll 1
  for (int r = 0; r < g; ++r) {
    uint32_t c = v;
    asm volatile("" : "+r"(c));
    const uint32_t V = c * 0x01010101u;
    const uint32_t V2 = V ^ 0x40404040u;  // v + 64 in each byte
    uint32_t acc = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      acc &= ((q[j].x ^ V) + 0x7f7f7f7fu) & ((q[j].y ^ V2) + 0x7f7f7f7fu);
    safe &= (acc & 0x80808080u) == 0x80808080u;
  }
  return safe;
}

// NW words of packed queens a parent: N <= 4 * NW. PB parents a tile
// (PB <= TTS_NQL_PARENTS, the threads of the block).
template <int NW, typename D>
__global__ void __launch_bounds__(TTS_NQL_PARENTS, 8)
    nqueens_labels_kernel(const uint8_t* __restrict__ board,
                          const D* __restrict__ depth,
                          uint8_t* __restrict__ out, int B, int N, int g,
                          int PB) {
  constexpr int T = TTS_NQL_PARENTS;
  constexpr int ROW_BYTES = TTS_NQL_PARENTS * 4 * NW + 32;
  __shared__ __align__(16) uint8_t s_rows[ROW_BYTES];
  __shared__ __align__(16) uint8_t s_out[ROW_BYTES];
  __shared__ uint2 s_uw[TTS_NQL_PARENTS * NW];
  __shared__ uint8_t s_item[TTS_NQL_PARENTS * 4 * NW];
  __shared__ int s_base[TTS_NQL_PARENTS], s_depth[TTS_NQL_PARENTS];
  __shared__ bool s_wide[TTS_NQL_PARENTS];
  __shared__ int s_warp[TTS_NQL_PARENTS / 32];
  const int t = threadIdx.x;
  const int tiles = (B + PB - 1) / PB;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = tile * PB;
    const int rows = min(PB, B - b0);
    const int nbytes = rows * N;
    const uint8_t* src = board + static_cast<size_t>(b0) * N;
    uint8_t* dst = out + static_cast<size_t>(b0) * N;
    const int ph_in = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    const int ph_out = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    // A small tile (its slots within the block's threads) takes one thread
    // a slot, which packs its parent's offsets itself and stores its label
    // straight to the output: no barrier past the rows'.
    const bool direct = PB * N <= T;
    copy_keep_phase(src, nbytes, s_rows, nullptr);
    if (!direct)
      for (int w = t; w < (ph_out + nbytes + 15) / 16; w += T)
        reinterpret_cast<uint4*>(s_out)[w] = make_uint4(0, 0, 0, 0);
    const int d = t < rows ? static_cast<int>(depth[b0 + t]) : N;
    if (t < rows) s_depth[t] = d;
    __syncthreads();  // the rows and depths are in shared memory
    if (direct) {
      if (t < nbytes) {
        const int p = t / N;
        const int k = t - p * N;
        const int dp = s_depth[p];
        int safe = 0;
        if (k >= dp) {
          const uint8_t* row = s_rows + ph_in + p * N;
          uint2 q[NW];
          safe = nq_pack<NW>(s_rows, ph_in + p * N, dp, N, q)
                     ? nq_label(row, dp, k, g)
                     : nq_packed_label<NW>(q, row[k], g);
        }
        dst[t] = static_cast<uint8_t>(safe);
      }
      __syncthreads();  // the next tile reuses the rows
      continue;
    }

    // Thread t packs parent t's offsets and counts its open slots.
    int open = 0;
    if (t < rows) {
      uint2 q[NW];
      s_wide[t] = nq_pack<NW>(s_rows, ph_in + t * N, d, N, q);
#pragma unroll
      for (int j = 0; j < NW; ++j) s_uw[t * NW + j] = q[j];
      open = d < N ? N - max(d, 0) : 0;
    }
    // The exclusive scan of the open counts over the block: a shuffle scan
    // a warp, then the warps' totals (one barrier).
    int x = open;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if ((t & 31) >= o) x += y;
    }
    if ((t & 31) == 31) s_warp[t >> 5] = x;
    __syncthreads();  // the warps' totals, the offsets and flags
    int first = x - open, total = 0;
#pragma unroll
    for (int w = 0; w < TTS_NQL_PARENTS / 32; ++w) {
      const int c = s_warp[w];
      first += w < (t >> 5) ? c : 0;
      total += c;
    }
    if (t < rows) {
      s_base[t] = first - max(d, 0);  // item of slot k: s_base[t] + k
      for (int j = 0; j < open; ++j)
        s_item[first + j] = static_cast<uint8_t>(t);
    }
    __syncthreads();  // the offsets and the item map are in shared memory

    for (int it = t; it < total; it += T) {
      const int p = s_item[it];
      const int k = it - s_base[p];
      const uint8_t* row = s_rows + ph_in + p * N;
      const int safe =
          s_wide[p] ? nq_label(row, s_depth[p], k, g)
                    : nq_packed_label<NW>(s_uw + p * NW, row[k], g);
      s_out[ph_out + p * N + k] = static_cast<uint8_t>(safe);
    }
    __syncthreads();  // the tile's labels are in shared memory
    store_keep_phase(dst, nbytes, s_out);
    __syncthreads();  // the next tile reuses the buffers
  }
}

// Boards past 32: the scalar check of every (parent, slot), a grid-stride
// loop of one thread a slot.
template <typename D>
__global__ void nqueens_labels_wide_kernel(const uint8_t* __restrict__ board,
                                           const D* __restrict__ depth,
                                           uint8_t* __restrict__ out, int B,
                                           int N, int g) {
  const long long total = static_cast<long long>(B) * N;
  for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       s < total; s += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int b = static_cast<int>(s / N);
    const int k = static_cast<int>(s - static_cast<long long>(b) * N);
    out[s] = static_cast<uint8_t>(
        nq_label(board + static_cast<size_t>(b) * N, static_cast<int>(depth[b]),
                 k, g));
  }
}

// The shape of the last launch: parents a tile, blocks, tiles, packed
// words a parent (0: the wide kernel), blocks an SM.
static int nql_last[5];
extern "C" void nqueens_labels_last_shape(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = nql_last[i];
}

template <int NW, typename D>
static int launch_nql(const void* board, const void* depth, void* out, int B,
                      int N, int g, cudaStream_t stream) {
  static int per_sm = 0;
  if (!per_sm) {
    const int err =
        static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, nqueens_labels_kernel<NW, D>, TTS_NQL_PARENTS, 0));
    if (err) return err;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Fewer parents a tile while the tiles are fewer than the SMs, until a
  // tile's slots fit the block's threads (one thread a slot): a small
  // chunk spreads over more SMs, and each block's chain is shorter.
  int pb = TTS_NQL_PARENTS;
  while ((B + pb - 1) / pb < sms && pb * N > TTS_NQL_PARENTS) pb >>= 1;
  const int tiles = (B + pb - 1) / pb;
  const int blocks = min(tiles, max(per_sm, 1) * sms);
  nqueens_labels_kernel<NW, D><<<blocks, TTS_NQL_PARENTS, 0, stream>>>(
      static_cast<const uint8_t*>(board), static_cast<const D*>(depth),
      static_cast<uint8_t*>(out), B, N, g, pb);
  const int last[5] = {pb, blocks, tiles, NW, per_sm};
  for (int i = 0; i < 5; ++i) nql_last[i] = last[i];
  return static_cast<int>(cudaGetLastError());
}

template <typename D>
static int launch_nql_wide(const void* board, const void* depth, void* out,
                           int B, int N, int g, cudaStream_t stream) {
  static int per_sm = 0;
  if (!per_sm) {
    const int err =
        static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, nqueens_labels_wide_kernel<D>, 256, 0));
    if (err) return err;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (static_cast<long long>(B) * N + 255) / 256;
  const long long wave = static_cast<long long>(max(per_sm, 1)) * sms;
  const int blocks = static_cast<int>(need < wave ? need : wave);
  nqueens_labels_wide_kernel<D><<<blocks, 256, 0, stream>>>(
      static_cast<const uint8_t*>(board), static_cast<const D*>(depth),
      static_cast<uint8_t*>(out), B, N, g);
  const int last[5] = {0, blocks, 0, 0, per_sm};
  for (int i = 0; i < 5; ++i) nql_last[i] = last[i];
  return static_cast<int>(cudaGetLastError());
}

template <typename D>
static int launch_nqueens_labels(const void* board, const void* depth,
                                 void* out, int B, int N, int g,
                                 void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 32) return launch_nql_wide<D>(board, depth, out, B, N, g, s);
  if (N <= 8) return launch_nql<2, D>(board, depth, out, B, N, g, s);
  if (N <= 16) return launch_nql<4, D>(board, depth, out, B, N, g, s);
  if (N <= 24) return launch_nql<6, D>(board, depth, out, B, N, g, s);
  return launch_nql<8, D>(board, depth, out, B, N, g, s);
}

extern "C" int nqueens_labels_i8(const void* board, const void* depth,
                                 void* out, int B, int N, int g,
                                 void* stream) {
  return launch_nqueens_labels<int8_t>(board, depth, out, B, N, g, stream);
}

extern "C" int nqueens_labels_i32(const void* board, const void* depth,
                                  void* out, int B, int N, int g,
                                  void* stream) {
  return launch_nqueens_labels<int32_t>(board, depth, out, B, N, g, stream);
}
