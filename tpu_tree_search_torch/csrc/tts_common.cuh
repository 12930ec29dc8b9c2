// What every kernel library of the port shares: the error string entry
// that `ops/_build.py` binds in each library, the INF incumbent, the block
// size rule and the shared-memory opt-in.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TTS_INF_BOUND 0x7fffffff

extern "C" const char* tts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Threads of a block that runs one thread a slot: the slot count rounded
// up to a whole warp, at most 1024.
static inline int tts_threads_for(int slots) {
  int t = ((slots + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
}

// Allow `kernel` more than 48 KB of dynamic shared memory when a launch
// asks for `smem` bytes (without it such a launch is refused). Returns the
// CUDA error, 0 on success.
template <typename K>
static inline int tts_smem_optin(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}
