"""Kernel 2: one whole device-resident PFSP lb1 cycle, as CUDA for Hopper.

Replaces the TPU kernel `_mega_lb1_kernel` (`tpu_tree_search/ops/megakernel.py`,
with `_pfsp_epilogue`, `_compact_push` and the lb1 branch of `make_cycle`)
and the engine's pop and write-back around it; source `csrc/cycle_lb1.cu`,
whose header note gives the launch sequence, the state layout and what
bounds it on the card.

The loop state is one int32 tensor ``st`` (``new_state``): size, best, tree,
sol, cycles, and this cycle's pop. One call of ``cycle_lb1_cuda`` enqueues
one cycle; when the loop condition is false it is an exact no-op, so the
engine enqueues K of them with no host synchronisation.
``cycle_lb1_cuda.launches`` counts the calls (one cycle, four launches).

Plain PyTorch versions beside it: ``cycle_chunk_plain`` computes what the
JAX ``make_cycle`` returns for one popped chunk (the CPU tests hold it to
the Pallas kernel in interpret mode), and ``cycle_lb1_plain`` is the whole
in-pool cycle — the kernel's plain version, used on the CPU and in the
on-card comparison. The state layout, ``plain_pool_cycle`` and
``CycleScratch`` are shared with the N-Queens cycle (`ops/cycle_nqueens.py`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..problems.base import INF_BOUND
from . import _build
from .pfsp_device import PFSPDeviceTables, lb1_chunk

# Layout of the state tensor (mirrors the enum of csrc/cycle_common.cuh).
ST_SIZE, ST_BEST, ST_TREE, ST_SOL, ST_CYCLES = 0, 1, 2, 3, 4
ST_ACTIVE, ST_CNT, ST_START2, ST_BASE = 5, 6, 7, 8
ST_LEN = 16


def new_state(size: int, best: int, device) -> torch.Tensor:
    st = torch.zeros(ST_LEN, dtype=torch.int32)
    st[ST_SIZE] = size
    st[ST_BEST] = best
    return st.to(device)


def cycle_chunk_plain(vals_c: torch.Tensor, aux_c: torch.Tensor,
                      valid: torch.Tensor, best: torch.Tensor,
                      tables: PFSPDeviceTables):
    """One cycle on a popped chunk — the JAX ``make_cycle`` lb1 contract.

    vals_c (M, n), aux_c (M,) limit1, valid (M,) bool, best 0-d int32.
    Returns ``(rows (M*n, n) int32, caux (M*n,) int32, tree_inc, sol_inc,
    best)`` (0-d int32 tensors): the survivors in (parent, slot) order, each
    its parent with positions limit1+1 and k swapped, with caux = limit1+1;
    rows past tree_inc are zero. Leaves fold into best before the keep test
    (`pfsp_chpl.chpl:100-111`).
    """
    M, n = vals_c.shape
    dev = vals_c.device
    aux = aux_c.to(torch.int32)
    lb = lb1_chunk(vals_c, aux, tables)
    pdepth = aux + 1
    kk = torch.arange(n, dtype=torch.int32, device=dev)
    open_ = (kk[None, :] >= pdepth[:, None]) & valid[:, None]
    leaf = open_ & ((pdepth + 1) == n)[:, None]
    sol_inc = torch.sum(leaf, dtype=torch.int32)
    inf = torch.full_like(lb, INF_BOUND)
    best = torch.minimum(best.to(torch.int32), torch.where(leaf, lb, inf).min())
    keep = open_ & ~leaf & (lb < best)
    pi, kj = keep.nonzero(as_tuple=True)
    tree_inc = pi.numel()
    parent = vals_c[pi].to(torch.int32)
    d = pdepth[pi].long()
    ar = torch.arange(tree_inc, device=dev)
    v_d = parent[ar, d]
    v_k = parent[ar, kj]
    child = parent.clone()
    child[ar, kj] = v_d
    child[ar, d] = v_k
    rows = torch.zeros((M * n, n), dtype=torch.int32, device=dev)
    caux = torch.zeros(M * n, dtype=torch.int32, device=dev)
    rows[:tree_inc] = child
    caux[:tree_inc] = pdepth[pi]
    return (rows, caux, torch.tensor(tree_inc, dtype=torch.int32, device=dev),
            sol_inc, best)


def plain_pool_cycle(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                     st: torch.Tensor, M: int, m: int, K: int,
                     chunk_cycle) -> None:
    """One cycle on the pool, in place, around ``chunk_cycle(vals_c, aux_c,
    valid, best) -> (rows, caux, tree_inc, sol_inc, best)`` (a problem's
    chunk contract): the loop condition, the pop, the push of the survivors
    at the pool's size and the state update — what one fused CUDA cycle
    computes (reads the state on the host: plain, not the hot path)."""
    C, n = pool_vals.shape
    size, _, _, _, cycles = (int(v) for v in st[:ST_ACTIVE].tolist())
    if not (size >= m and size + M * n <= C and cycles < K):
        st[ST_ACTIVE] = 0
        return
    cnt = min(size, M)
    start = size - cnt
    start2 = min(max(start, 0), C - M)
    idx = start2 + torch.arange(M, device=pool_vals.device)
    valid = (idx >= start) & (idx < size)
    rows, caux, tree_inc, sol_inc, best = chunk_cycle(
        pool_vals[start2:start2 + M], pool_aux[start2:start2 + M], valid,
        st[ST_BEST])
    t = int(tree_inc)
    pool_vals[start:start + t] = rows[:t].to(pool_vals.dtype)
    pool_aux[start:start + t] = caux[:t].to(pool_aux.dtype)
    st[ST_SIZE] = start + t
    st[ST_BEST] = best
    st[ST_TREE] += t
    st[ST_SOL] += sol_inc
    st[ST_CYCLES] += 1
    st[ST_ACTIVE] = 1
    st[ST_CNT] = cnt
    st[ST_START2] = start2
    st[ST_BASE] = start


def cycle_lb1_plain(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                    st: torch.Tensor, tables: PFSPDeviceTables, M: int,
                    m: int, K: int) -> None:
    """The whole lb1 cycle on the pool, in place: condition, pop, bounds,
    prune, compaction and push, and the state update — what one
    ``cycle_lb1_cuda`` call computes."""
    plain_pool_cycle(
        pool_vals, pool_aux, st, M, m, K,
        lambda v, a, valid, best: cycle_chunk_plain(v, a, valid, best, tables))


@dataclass
class CycleScratch:
    """Device buffers of one fused cycle: the popped chunk's stash, the
    (M*n) plane (lb1 bounds, or N-Queens keep flags) and the per-block
    survivor counts and offsets."""

    chunk_vals: torch.Tensor
    chunk_aux: torch.Tensor
    plane: torch.Tensor
    blkcnt: torch.Tensor
    blkoff: torch.Tensor

    @classmethod
    def make(cls, M: int, n: int, vals_dtype: torch.dtype,
             aux_dtype: torch.dtype, plane_dtype: torch.dtype,
             parents_per_block: int, device) -> "CycleScratch":
        nblk = -(-M // parents_per_block)
        return cls(
            chunk_vals=torch.empty((M, n), dtype=vals_dtype, device=device),
            chunk_aux=torch.empty(M, dtype=aux_dtype, device=device),
            plane=torch.empty(M * n, dtype=plane_dtype, device=device),
            blkcnt=torch.empty(2 * nblk, dtype=torch.int32, device=device),
            blkoff=torch.empty(nblk, dtype=torch.int32, device=device),
        )


def cycle_scratch(M: int, n: int, dtype: torch.dtype,
                  device: torch.device) -> CycleScratch:
    """The lb1 cycle's scratch: pool-dtype stash, int32 lb plane."""
    pb = _build.library("cycle_lb1").tts_parents_per_block()
    return CycleScratch.make(M, n, dtype, dtype, torch.int32, pb, device)


_ENTRIES = {torch.int8: "cycle_lb1_i8", torch.int32: "cycle_lb1_i32"}
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.cache
def _entry(dtype: torch.dtype):
    """The loaded library and its C entry for ``dtype`` (bound once)."""
    lib = _build.library("cycle_lb1")
    fn = getattr(lib, _ENTRIES[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def cycle_lb1_cuda(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                   st: torch.Tensor, scratch: CycleScratch,
                   tables: PFSPDeviceTables, M: int, m: int, K: int) -> None:
    """Enqueue one cycle (four launches) on the current stream; updates the
    pool and ``st`` in place on the device, never synchronises."""
    if not pool_vals.is_cuda:
        raise ValueError("cycle_lb1_cuda takes CUDA tensors")
    if pool_vals.dtype not in _ENTRIES or pool_aux.dtype != pool_vals.dtype:
        raise TypeError("pool_vals and pool_aux must both be int8 or int32")
    C, n = pool_vals.shape
    if pool_aux.shape != (C,) or st.dtype != torch.int32 or st.numel() < ST_LEN:
        raise ValueError("pool_aux must be (C,) and st int32 of ST_LEN")
    if not (pool_vals.is_contiguous() and pool_aux.is_contiguous()
            and st.is_contiguous()):
        raise ValueError("pool and state tensors must be contiguous")
    if (n, tables.machines) != tuple(tables.ptm_t.shape):
        raise ValueError("pool width does not match the tables' job count")
    if C < M or scratch.chunk_vals.shape != (M, n) \
            or scratch.chunk_vals.dtype != pool_vals.dtype:
        raise ValueError("scratch must be cycle_scratch(M, n) of the pool "
                         "dtype, and the pool hold at least M rows")
    lib, fn = _entry(pool_vals.dtype)
    stream = torch.cuda.current_stream(pool_vals.device).cuda_stream
    err = fn(pool_vals.data_ptr(), pool_aux.data_ptr(), st.data_ptr(),
             scratch.chunk_vals.data_ptr(), scratch.chunk_aux.data_ptr(),
             scratch.plane.data_ptr(), scratch.blkcnt.data_ptr(),
             scratch.blkoff.data_ptr(), tables.ptm_t.data_ptr(),
             tables.min_heads.data_ptr(), tables.min_tails.data_ptr(),
             n, tables.machines, M, C, m, K, stream)
    _build.check(lib, err, "cycle_lb1")
    cycle_lb1_cuda.launches += 1  # type: ignore[attr-defined]


cycle_lb1_cuda.launches = 0  # type: ignore[attr-defined]


def cycle_lb1(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
              st: torch.Tensor, scratch: CycleScratch | None,
              tables: PFSPDeviceTables, M: int, m: int, K: int) -> None:
    """One cycle routed by device: the CUDA kernel for a CUDA pool (which
    launches or raises), the plain version for a CPU pool."""
    if pool_vals.is_cuda:
        if scratch is None:
            raise ValueError("the CUDA cycle needs its cycle_scratch buffers")
        cycle_lb1_cuda(pool_vals, pool_aux, st, scratch, tables, M, m, K)
    else:
        cycle_lb1_plain(pool_vals, pool_aux, st, tables, M, m, K)
