"""Kernel 4: one whole device-resident N-Queens cycle, as CUDA for Hopper.

Replaces the TPU kernel `_mega_nqueens_kernel` (`tpu_tree_search/ops/megakernel.py`,
with `_compact_push` and the N-Queens branch of `make_cycle`) and the
engine's pop and write-back around it; source `csrc/cycle_nqueens.cu`,
whose header note gives the launch sequence and what bounds it on the card.

The pool is ``board`` (C, N) uint8 and ``depth`` (C,) int8 through N = 127,
int32 beyond (``depth_dtype``; N <= 256), and the loop state is the int32
tensor of `ops/cycle.py` (``new_state``); a parent's keeps are
``nq_mask_words(N)`` uint32 words (1 through N = 32, up to 8). One
call of ``cycle_nqueens_cuda`` enqueues one cycle (two launches); when the
loop condition is false it is an exact no-op. The engine captures one
call into its dispatch graph (`ops/dispatch.py`);
``cycle_nqueens_cuda.launches`` counts the cycles launched, as
`ops/cycle.py`'s wrappers do (``count_launch``).

Plain PyTorch versions beside it: ``cycle_nqueens_chunk_plain`` computes
what the JAX ``make_cycle`` returns for one popped chunk (the CPU tests hold
it to the Pallas kernel in interpret mode), and ``cycle_nqueens_plain`` is
the whole in-pool cycle — the kernel's plain version, used on the CPU and in
the on-card comparison.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs.phases import IDX
from . import _build
from .cycle import (NQ_MARKS, ST_LEN, CycleScratch, parents_per_block,
                    plain_marker, plain_pool_cycle)
from .dispatch import (COND_ARGTYPES, clock_pointer, count_launch, count_marks,
                       cycle_condition, route)
from .nqueens_device import labels_chunk
from .nqueens_kernel import MAX_N


def cycle_nqueens_chunk_plain(board_c: torch.Tensor, depth_c: torch.Tensor,
                              valid: torch.Tensor, best: torch.Tensor,
                              N: int, g: int, mark=None):
    """One cycle on a popped chunk — the JAX ``make_cycle`` N-Queens
    contract.

    board_c (M, N), depth_c (M,), valid (M,) bool, best 0-d int32. Returns
    ``(rows (M*N, N) int32, caux (M*N,) int32, tree_inc, sol_inc, best)``
    (0-d int32 tensors): a popped valid parent at depth == N counts one
    solution; the survivors ``label & valid & depth < N`` in (parent, slot)
    order, each its parent with positions depth and k swapped, with
    caux = depth + 1; rows past tree_inc are zero. ``best`` passes through.
    ``mark(slot)``, when given, is called after the labels (``eval``).
    """
    M = board_c.shape[0]
    dev = board_c.device
    depth = depth_c.to(torch.int32)
    labels = labels_chunk(board_c, depth, N, g).bool()
    if mark is not None:
        mark(IDX["eval"])
    keep = labels & valid[:, None] & (depth < N)[:, None]
    sol_inc = torch.sum(valid & (depth == N), dtype=torch.int32)
    pi, kj = keep.nonzero(as_tuple=True)
    tree_inc = pi.numel()
    parent = board_c[pi].to(torch.int32)
    d = depth[pi].long()
    ar = torch.arange(tree_inc, device=dev)
    v_d = parent[ar, d]
    v_k = parent[ar, kj]
    child = parent.clone()
    child[ar, kj] = v_d
    child[ar, d] = v_k
    rows = torch.zeros((M * N, N), dtype=torch.int32, device=dev)
    caux = torch.zeros(M * N, dtype=torch.int32, device=dev)
    rows[:tree_inc] = child
    caux[:tree_inc] = depth[pi] + 1
    return (rows, caux, torch.tensor(tree_inc, dtype=torch.int32, device=dev),
            sol_inc, best.to(torch.int32))


def cycle_nqueens_plain(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                        st: torch.Tensor, N: int, g: int, M: int, m: int,
                        K: int, clk=None) -> None:
    """The whole N-Queens cycle on the pool, in place: condition, pop,
    labels, solution count, compaction and push, and the state update —
    what one ``cycle_nqueens_cuda`` call computes; with a CPU phase clock
    ``clk``, its marks (``loop``, ``eval``, ``push``) on the host's
    clock."""
    mark = plain_marker(clk)
    plain_pool_cycle(
        pool_vals, pool_aux, st, M, m, K,
        lambda v, a, valid, best: cycle_nqueens_chunk_plain(v, a, valid, best,
                                                            N, g, mark), mark)


def depth_dtype(N: int) -> torch.dtype:
    """The N-Queens pool's depth type: int8 through N = 127, int32 beyond
    (the JAX ``_NQueensResident`` pool)."""
    return torch.int8 if N <= 127 else torch.int32


def nq_mask_words(N: int) -> int:
    """uint32 keep-mask words a parent of the N-Queens cycles
    (``TTS_NQ_WORDS`` of csrc/nqueens_common.cuh): bit k % 32 of word k // 32
    is slot k; 1, 2, 4 or 8."""
    return 1 if N <= 32 else 2 if N <= 64 else 4 if N <= 128 else 8


def nqueens_scratch(M: int, N: int, device) -> CycleScratch:
    """The N-Queens cycle's scratch: the board stash, the pool's depth
    type, and ``nq_mask_words(N)`` int32 keep-mask words a parent."""
    return CycleScratch.make(M, N, 1, depth_dtype(N), M * nq_mask_words(N),
                             parents_per_block("cycle_nqueens"), device)


def check_nqueens_pool(source: str, pool_vals: torch.Tensor,
                       pool_aux: torch.Tensor, st: torch.Tensor, N: int,
                       g: int) -> str:
    """Check an N-Queens pool for the cycle entries of ``csrc/<source>.cu``
    and return the entry of its depth type (``source`` or
    ``<source>_i32``)."""
    if not pool_vals.is_cuda:
        raise ValueError(f"{source} takes CUDA tensors")
    if not 1 <= N <= MAX_N or g < 1:
        raise ValueError(f"the kernel takes 1 <= N <= {MAX_N} and g >= 1 "
                         f"(got N={N}, g={g})")
    if pool_vals.dtype != torch.uint8 or pool_aux.dtype != depth_dtype(N):
        raise TypeError(f"the N-Queens pool is a uint8 board and an "
                        f"{depth_dtype(N)} depth at N = {N}")
    C = pool_vals.shape[0]
    if pool_vals.shape != (C, N) or pool_aux.shape != (C,) \
            or st.dtype != torch.int32 or st.numel() < ST_LEN:
        raise ValueError("pool_vals must be (C, N), pool_aux (C,) and st "
                         "int32 of ST_LEN")
    if not (pool_vals.is_contiguous() and pool_aux.is_contiguous()
            and st.is_contiguous()):
        raise ValueError("pool and state tensors must be contiguous")
    return source if N <= 127 else f"{source}_i32"


_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + COND_ARGTYPES
             + (ctypes.c_void_p,) * 2)


def cycle_nqueens_cuda(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                       st: torch.Tensor, scratch: CycleScratch, N: int,
                       g: int, M: int, m: int, K: int,
                       clk: torch.Tensor | None = None) -> None:
    """Enqueue one cycle (two launches; with a phase clock ``clk`` three
    ``phase_mark`` launches around them) on the current stream; updates
    the pool and ``st`` in place on the device, never synchronises."""
    entry = check_nqueens_pool("cycle_nqueens", pool_vals, pool_aux, st, N, g)
    C = pool_vals.shape[0]
    lib, fn = _build.entry("cycle_nqueens", entry, _ARGTYPES)
    if C < M or not scratch.fits(M, N, 1, depth_dtype(N),
                                 M * nq_mask_words(N),
                                 parents_per_block("cycle_nqueens")):
        raise ValueError("scratch must be nqueens_scratch(M, N), and the "
                         "pool hold at least M rows")
    clk_ptr = clock_pointer(clk)
    stream = torch.cuda.current_stream(pool_vals.device).cuda_stream
    err = fn(pool_vals.data_ptr(), pool_aux.data_ptr(), st.data_ptr(),
             scratch.chunk_vals.data_ptr(), scratch.chunk_aux.data_ptr(),
             scratch.plane.data_ptr(), scratch.blkcnt.data_ptr(), N, g, M, C,
             m, K, *cycle_condition("cycle_nqueens"), clk_ptr, stream)
    _build.check(lib, err, "cycle_nqueens")
    count_marks(clk, NQ_MARKS)
    count_launch(cycle_nqueens_cuda)


cycle_nqueens_cuda.launches = 0  # type: ignore[attr-defined]
cycle_nqueens_cuda.captures = 0  # type: ignore[attr-defined]


def cycle_nqueens(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                  st: torch.Tensor, scratch: CycleScratch | None, N: int,
                  g: int, M: int, m: int, K: int,
                  clk: torch.Tensor | None = None) -> None:
    """One cycle routed by device: the CUDA kernel for a CUDA pool (which
    launches or raises), the plain version for a CPU pool; ``clk`` arms
    the phase marks."""
    with route("cycle_nqueens_cuda"):
        if pool_vals.is_cuda:
            if scratch is None:
                raise ValueError("the CUDA cycle needs its nqueens_scratch "
                                 "buffers")
            cycle_nqueens_cuda(pool_vals, pool_aux, st, scratch, N, g, M, m,
                               K, clk)
        else:
            cycle_nqueens_plain(pool_vals, pool_aux, st, N, g, M, m, K, clk)
