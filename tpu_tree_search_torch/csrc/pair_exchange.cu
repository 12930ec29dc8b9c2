// The pair-max exchange between the copies of one mesh shard under the lb2
// pair axis (`--mp`): the counterpart of the `lax.pmax` over the mp axis
// inside the JAX evaluators (tpu_tree_search/ops/pfsp_device.py:893-922
// `lb2_bounds_mp`, :723-764 `lb2_self_bounds_mp`). Not a TPU kernel: on the
// TPU this is an XLA collective over ICI. Here each copy of a shard sits on
// a device position of its own (`parallel/resident_mesh.py`), runs the
// whole unfused cycle in its own dispatch graph, bounds the pair blocks
// placed at its position and exchanges its plane with its peers, so every
// copy keeps the same rows and reaches the same loop condition on the same
// cycle. The plain version is `PairExchange`'s host path in
// ops/pair_exchange.py (copies in host threads, a barrier, torch.maximum).
//
// The operands of one copy, all on its own device and allocated once,
// outside any capture: its int32 plane (the (M, n) child bounds, or the
// first `count` of the (R,) self bounds); a receive buffer of two parity
// slots of P = copies - 1 planes of L words, (2, P, L); one flag word a peer
// (the last sequence number that peer posted here); a control block (the
// copy's sequence number, the post's finished blocks); an error word; and a
// table of 2P addresses: for each peer, the base of this copy's plane in
// the peer's receive buffer and this copy's flag word there (peer pointers
// where the peer is on another card, whose access the entry
// `pair_exchange_peers` enables).
//   1. `xchg_post` (a grid): seq = the copy's number + 1; the plane's first
//      n words to every peer's slot seq & 1; `__threadfence_system`; the
//      last block to finish stores seq into every peer's flag with a
//      release at system scope and advances the copy's number.
//   2. `xchg_wait` (ONE block, a thread a peer): spins with acquire loads
//      and `__nanosleep` until every peer's flag here reads seq. One block
//      only: a many-block spinning kernel could fill the card and starve
//      the peer copy's kernels where both copies sit on one card, a
//      deadlock. It gives up after `timeout_ns` of %globaltimer and sets
//      the error word, which the host checks at each dispatch's read; with
//      the word set every later wait returns at once, so a missing peer
//      fails the run and never hangs the card.
//   3. `xchg_max` (a grid): the plane's first n words := the max of the
//      plane and the peers' planes in slot seq & 1.
// The three kernels are loaded when a group is made (`pair_exchange_load`):
// under CUDA's lazy loading a kernel's first launch may wait for the card
// to go idle, and a copy's first `xchg_max`, launched while its wait spins
// for a peer the host has not launched yet, would never return.
// Two parity slots suffice: a copy posts seq + 2 into a peer's slot seq & 1
// only after its wait for seq + 1, which needs the peer's post of seq + 1,
// which the peer's stream runs after its max of seq has read the slot.
// The copies run the same cycles, so their numbers stay equal.
// What bounds it: bytes. Each copy writes its n words to each peer and
// reads P + 1 planes for the max: at M = 49152, n = 20 and mp = 2 a 3.93 MB
// plane written and two read. 16-byte words where the addresses allow.
#include "tts_common.cuh"

#define TTS_XCHG_THREADS 256
#define TTS_XCHG_BLOCKS 528
#define TTS_XCHG_MAX_PEERS 32
// The error word's value when a peer did not post in time.
#define TTS_XCHG_TIMEOUT 1

__device__ __forceinline__ unsigned long long xchg_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned xchg_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void xchg_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The words an exchange moves: the live count where the caller gave one
// (a device word), clamped to the plane's capacity.
__device__ __forceinline__ int xchg_words(const int* count, int n) {
  if (count == nullptr) return n;
  const int c = *count;
  return c < 0 ? 0 : (c < n ? c : n);
}

__device__ __forceinline__ bool xchg_aligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

__global__ void xchg_post(const int* __restrict__ plane, const int* count, int n_max,
                          const long long* links, int P, long long slot_words,
                          unsigned* ctl) {
  const unsigned seq = ctl[0] + 1;  // read before this block counts itself done
  const int n = xchg_words(count, n_max);
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int k = 0; k < P; ++k) {
    int* dst = reinterpret_cast<int*>(links[2 * k]) + (seq & 1) * slot_words;
    long long done = 0;
    if (xchg_aligned(dst, plane)) {
      const int4* s4 = reinterpret_cast<const int4*>(plane);
      int4* d4 = reinterpret_cast<int4*>(dst);
      const long long n4 = n / 4;
      for (long long i = tid; i < n4; i += step) d4[i] = s4[i];
      done = n4 * 4;
    }
    for (long long i = done + tid; i < n; i += step) dst[i] = plane[i];
  }
  __threadfence_system();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(&ctl[1], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  ctl[1] = 0;
  __threadfence_system();
  for (int k = 0; k < P; ++k)
    xchg_release(reinterpret_cast<unsigned*>(links[2 * k + 1]), seq);
  ctl[0] = seq;
}

__global__ void xchg_wait(const unsigned* ctl, const unsigned* flags, int P, int* err,
                          unsigned long long timeout_ns) {
  const unsigned seq = ctl[0];
  const int k = threadIdx.x;
  volatile int* e = err;
  if (k < P && *e == 0) {
    const unsigned long long t0 = xchg_now();
    unsigned ns = 32;
    while (static_cast<int>(xchg_acquire(flags + k) - seq) < 0) {
      if (*e != 0) break;
      if (xchg_now() - t0 > timeout_ns) {
        atomicCAS(err, 0, TTS_XCHG_TIMEOUT);
        break;
      }
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
  }
  __threadfence_system();
}

__global__ void xchg_max(int* __restrict__ plane, const int* count, int n_max,
                         const int* __restrict__ recv, int P, long long L,
                         const unsigned* ctl) {
  const unsigned seq = ctl[0];
  const int n = xchg_words(count, n_max);
  const int* slot = recv + (seq & 1) * P * L;
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (xchg_aligned(plane, slot) && (L & 3) == 0) {
    int4* p4 = reinterpret_cast<int4*>(plane);
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += step) {
      int4 v = p4[i];
      for (int k = 0; k < P; ++k) {
        const int4 w = __ldcg(reinterpret_cast<const int4*>(slot + k * L) + i);
        v.x = max(v.x, w.x);
        v.y = max(v.y, w.y);
        v.z = max(v.z, w.z);
        v.w = max(v.w, w.w);
      }
      p4[i] = v;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += step) {
    int v = plane[i];
    for (int k = 0; k < P; ++k) v = max(v, __ldcg(slot + k * L + i));
    plane[i] = v;
  }
}

// One exchange of a copy's plane on `stream`: post, wait, max. `count`
// (nullable) a device word bounding the words exchanged; `n` the plane's
// words (at most `L`, a receive plane's). Returns the CUDA error, 0 on
// success.
extern "C" int pair_exchange_enqueue(void* plane, void* count, int n, void* links, int P,
                                     long long L, void* recv, void* flags, void* ctl,
                                     void* err, unsigned long long timeout_ns,
                                     void* stream) {
  if (P < 1 || P > TTS_XCHG_MAX_PEERS || n < 0 || n > L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (n / 4 + TTS_XCHG_THREADS - 1) / TTS_XCHG_THREADS;
  blocks = blocks < 1 ? 1 : (blocks > TTS_XCHG_BLOCKS ? TTS_XCHG_BLOCKS : blocks);
  xchg_post<<<static_cast<int>(blocks), TTS_XCHG_THREADS, 0, s>>>(
      static_cast<const int*>(plane), static_cast<const int*>(count), n,
      static_cast<const long long*>(links), P, P * L, static_cast<unsigned*>(ctl));
  cudaError_t e = cudaGetLastError();
  if (e) return static_cast<int>(e);
  xchg_wait<<<1, 32, 0, s>>>(static_cast<const unsigned*>(ctl),
                             static_cast<const unsigned*>(flags), P,
                             static_cast<int*>(err), timeout_ns);
  e = cudaGetLastError();
  if (e) return static_cast<int>(e);
  xchg_max<<<static_cast<int>(blocks), TTS_XCHG_THREADS, 0, s>>>(
      static_cast<int*>(plane), static_cast<const int*>(count), n,
      static_cast<const int*>(recv), P, L, static_cast<const unsigned*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

// Load the three kernels on card `dev` (see the note above). Returns the
// CUDA error, 0 on success.
extern "C" int pair_exchange_load(int dev) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(dev);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, xchg_post);
  if (!e) e = cudaFuncGetAttributes(&a, xchg_wait);
  if (!e) e = cudaFuncGetAttributes(&a, xchg_max);
  cudaSetDevice(prev);
  return static_cast<int>(e);
}

// Peer access between cards `a` and `b`, both ways. `*can` is 0 where the
// hardware has none (the caller raises: the exchange never falls back).
// Returns the CUDA error, 0 on success (access already enabled included).
extern "C" int pair_exchange_peers(int a, int b, int* can) {
  int ab = 0, ba = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&ab, a, b);
  if (!e) e = cudaDeviceCanAccessPeer(&ba, b, a);
  if (e) return static_cast<int>(e);
  *can = ab && ba;
  if (!*can) return 0;
  int prev = 0;
  cudaGetDevice(&prev);
  const int pairs[2][2] = {{a, b}, {b, a}};
  for (const auto& p : pairs) {
    cudaSetDevice(p[0]);
    e = cudaDeviceEnablePeerAccess(p[1], 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
    if (e) break;
  }
  cudaSetDevice(prev);
  return static_cast<int>(e);
}
