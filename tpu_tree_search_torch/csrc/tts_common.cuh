// What every kernel library of the port shares: the error string entry
// that `ops/_build.py` binds in each library, the INF incumbent, the block
// size rule and the shared-memory opt-in (made once a kernel).
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
// asks for `smem` bytes (without it such a launch is refused). Each
// library keeps the size it set last a (kernel, device) and sets the
// attribute again only when a launch asks for another: a run of launches
// at one size sets it once, and every launch runs with the attribute at
// its own size. Returns the CUDA error, 0 on success.
#define TTS_OPTIN_SLOTS 16
template <typename K>
static inline int tts_smem_optin(K kernel, size_t smem) {
  static const void* fns[TTS_OPTIN_SLOTS];
  static int devs[TTS_OPTIN_SLOTS];
  static size_t done[TTS_OPTIN_SLOTS];
  static int used = 0;
  if (smem <= 48 * 1024) return 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaGetDevice(&dev);
  int i = 0;
  while (i < used && !(fns[i] == fn && devs[i] == dev)) ++i;
  if (i < used && done[i] == smem) return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  if (i == used && used < TTS_OPTIN_SLOTS) ++used;
  if (i < used) {
    fns[i] = fn;
    devs[i] = dev;
    done[i] = smem;
  }
  return 0;
}
