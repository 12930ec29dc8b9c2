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
//      pool's storage types), N <= 32, g >= 1 rounds.
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
// Design: one block per TTS_NQ_PARENTS_PER_BLOCK parents stages their rows
// and depths in shared memory (coalesced reads), then one thread per
// (parent, slot) runs the check from shared memory, so consecutive threads
// write consecutive label bytes. The g rounds stay real work (see
// nq_label): the reference uses g as a workload knob, and the JAX package
// keeps them with a fori_loop for the same reason.
#include "nqueens_common.cuh"

template <typename D>
__global__ void nqueens_labels_kernel(const uint8_t* __restrict__ board,
                                      const D* __restrict__ depth,
                                      uint8_t* __restrict__ out, int B, int N,
                                      int g) {
  __shared__ uint8_t s_board[TTS_NQ_PARENTS_PER_BLOCK * TTS_NQ_MAX_N];
  __shared__ int s_depth[TTS_NQ_PARENTS_PER_BLOCK];
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  const int b0 = blockIdx.x * PB;
  const int rows = min(PB, B - b0);
  const uint8_t* src = board + static_cast<size_t>(b0) * N;
  for (int e = threadIdx.x; e < rows * N; e += blockDim.x) s_board[e] = src[e];
  for (int e = threadIdx.x; e < rows; e += blockDim.x)
    s_depth[e] = static_cast<int>(depth[b0 + e]);
  __syncthreads();
  uint8_t* dst = out + static_cast<size_t>(b0) * N;
  for (int slot = threadIdx.x; slot < rows * N; slot += blockDim.x) {
    const int p = slot / N;
    const int k = slot - p * N;
    dst[slot] = static_cast<uint8_t>(nq_label(s_board + p * N, s_depth[p], k, g));
  }
}

template <typename D>
static int launch_nqueens_labels(const void* board, const void* depth,
                                 void* out, int B, int N, int g,
                                 void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int PB = TTS_NQ_PARENTS_PER_BLOCK;
  const int blocks = (B + PB - 1) / PB;
  nqueens_labels_kernel<D><<<blocks, tts_threads_for(PB * N), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(board), static_cast<const D*>(depth),
      static_cast<uint8_t*>(out), B, N, g);
  return static_cast<int>(cudaGetLastError());
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
