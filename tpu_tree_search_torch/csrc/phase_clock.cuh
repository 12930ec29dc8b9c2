// The phase clock of the resident cycle (TTS_PHASEPROF=1): `phase_mark`,
// the counterpart of `obs_phases.boundary` (tpu_tree_search/obs/phases.py).
// Not a TPU kernel: the JAX clock is a host callback (`jax.pure_callback`
// to `time.perf_counter_ns`, one host round trip a boundary); on Hopper the
// clock is read on the device, from PTX `%globaltimer` (64-bit ns).
//
// The block is one int64 tensor of PH_LEN slots, `obs/phases.py` SLOTS
// order (pop, eval, compact, push, overflow, balance, loop, total), then
// the last reading (PH_TPREV) and the cycle's first reading (PH_T0). A
// mark, one thread, charges `now - clk[PH_TPREV]` to its slot and moves
// PH_TPREV to now; the cycle's first mark (PH_OPEN) charges `loop` and sets
// PH_T0, its last (PH_CLOSE) adds `now - clk[PH_T0]` to `total`. So the
// cycle's slots sum to its total exactly: the deltas telescope. A seed
// mark (PH_SEED) zeroes the block and sets PH_TPREV; it opens each
// dispatch. 64 bits: no wrap to handle (the JAX block is uint32).
//
// The marks sit on the stream between a cycle's launches, so a reading is
// taken when the launch before it has finished; the time from one mark to
// the next is that launch's run plus the latency between the two nodes.
// The cycle launchers enqueue them through `tts_phase_mark` when their
// clock pointer is not null; with null they enqueue exactly their own
// launches. What bounds it: one thread, a few loads and stores of one
// cache line; its cost is a launch (a graph node), about what
// `dispatch_cond` costs.
#pragma once

#include <cuda_runtime.h>

enum {
  PH_POP = 0,
  PH_EVAL = 1,
  PH_COMPACT = 2,
  PH_PUSH = 3,
  PH_OVERFLOW = 4,
  PH_BALANCE = 5,
  PH_LOOP = 6,
  PH_TOTAL = 7,
  PH_TPREV = 8,
  PH_T0 = 9,
  PH_LEN = 10,
};
// Mark flags: the cycle's first mark, its last, a dispatch's seed.
enum { PH_OPEN = 1, PH_CLOSE = 2, PH_SEED = 4 };

__device__ __forceinline__ long long tts_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void phase_mark(long long* clk, int slot, int flags) {
  const long long now = tts_globaltimer();
  if (flags & PH_SEED) {
    for (int i = 0; i < PH_LEN; ++i) clk[i] = 0;
    clk[PH_TPREV] = now;
    return;
  }
  clk[slot] += now - clk[PH_TPREV];
  clk[PH_TPREV] = now;
  if (flags & PH_OPEN) clk[PH_T0] = now;
  if (flags & PH_CLOSE) clk[PH_TOTAL] += now - clk[PH_T0];
}

// Enqueue one mark on `s` when `clk` is not null; returns the launch's
// error (0 when nothing was enqueued).
static inline int tts_phase_mark(void* clk, int slot, int flags,
                                 cudaStream_t s) {
  if (!clk) return 0;
  phase_mark<<<1, 1, 0, s>>>(static_cast<long long*>(clk), slot, flags);
  return static_cast<int>(cudaGetLastError());
}
