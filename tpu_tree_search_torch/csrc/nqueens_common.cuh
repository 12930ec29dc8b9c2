// Shared device code of the N-Queens kernels (nqueens_labels.cu,
// cycle_nqueens.cu): the diagonal-safety label of one candidate slot, the
// body of the JAX package's `_nqueens_tile_labels`
// (tpu_tree_search/ops/pallas_kernels.py), as the reference's scalar check
// (`nqueens_gpu_chpl.chpl:99-123`, `nqueens_gpu_cuda.cu:137-164`).
#pragma once

#include "tts_common.cuh"

// Parents a block handles. Their board rows (N <= TTS_NQ_MAX_N bytes each)
// are staged once in shared memory; then the block's threads run each
// (parent, slot). A uint8 board holds rows 0..255, so N <= 256; a parent's
// keeps are W = 1, 2, 4 or 8 uint32 mask words (TTS_NQ_WORDS: N <= 32 W).
#define TTS_NQ_PARENTS_PER_BLOCK 32
#define TTS_NQ_MAX_N 256
#define TTS_NQ_WORDS(N) ((N) <= 32 ? 1 : (N) <= 64 ? 2 : (N) <= 128 ? 4 : 8)

// 1 iff the queen of slot k (row[k]), placed at column `depth`, is safe on
// both diagonals from every placed queen row[i], i < depth; 0 for k < depth.
// The check runs g real rounds (the reference's workload knob): the empty
// asm makes each round's candidate value opaque to the compiler, and
// `unroll 1` keeps the rounds a loop, so nvcc can neither hoist the
// compares out of the round loop nor fold the rounds into one.
__device__ __forceinline__ int nq_label(const uint8_t* row, int depth, int k,
                                        int g) {
  if (k < depth) return 0;
  int safe = 1;
#pragma unroll 1
  for (int r = 0; r < g; ++r) {
    int v = row[k];
    asm volatile("" : "+r"(v));
    int ok = 1;
    for (int i = 0; i < depth; ++i) {
      const int b = row[i];
      const int d = depth - i;
      ok &= (b != v - d) & (b != v + d);
    }
    safe &= ok;
  }
  return safe;
}
