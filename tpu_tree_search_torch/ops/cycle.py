"""Kernels 2 and 8: one whole device-resident PFSP cycle (lb1, lb2), as
CUDA for Hopper.

Kernel 2 replaces the TPU kernel `_mega_lb1_kernel` and kernel 8
`_mega_lb2_kernel` (`tpu_tree_search/ops/megakernel.py`, with
`_pfsp_epilogue`, `_compact_push` and the lb1 and lb2 branches of
`make_cycle`), each with the engine's pop and write-back around it; sources
`csrc/cycle_lb1.cu` and `csrc/cycle_lb2.cu`, which differ only in the bound
of their first launch (the rest is `csrc/cycle_pfsp.cuh`). `cycle_lb1.cu`'s
header note gives the launch sequence, the state layout and what bounds it
on the card.

The loop state is one int32 tensor ``st`` (``new_state``): size, best, tree,
sol, cycles, and this cycle's pop. One call of ``cycle_lb1_cuda`` or
``cycle_lb2_cuda`` enqueues one cycle; when the loop condition is false it
is an exact no-op. The engine captures one call into the body of its
dispatch graph (`ops/dispatch.py`). Each wrapper's ``launches`` counts the
cycles it launched (three launches each: bounds, count, emit): one a call,
or under the graph the body's runs (``count_launch``); ``captures`` counts
its captures.

Plain PyTorch versions beside them: ``cycle_chunk_plain`` computes what the
JAX ``make_cycle`` returns for one popped chunk under a given bound (the CPU
tests hold it to the Pallas kernels in interpret mode), and
``cycle_lb1_plain``/``cycle_lb2_plain`` are the whole in-pool cycles — the
kernels' plain versions, used on the CPU and in the on-card comparison. The
state layout, ``plain_pool_cycle`` and ``CycleScratch`` are shared with the
N-Queens cycle (`ops/cycle_nqueens.py`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import torch

from ..obs.phases import CLOSE, IDX, OPEN
from ..problems.base import INF_BOUND
from . import _build
from .dispatch import (COND_ARGTYPES, clock_pointer, count_launch, count_marks,
                       cycle_condition, phase_mark, route)
from .lb2_kernel import johnson_operands
from .pfsp_device import PFSPDeviceTables, lb1_chunk, lb2_chunk

# Layout of the state tensor (mirrors the enum of csrc/cycle_common.cuh).
ST_SIZE, ST_BEST, ST_TREE, ST_SOL, ST_CYCLES = 0, 1, 2, 3, 4
ST_ACTIVE, ST_CNT, ST_START2, ST_BASE = 5, 6, 7, 8
ST_RUNS = 9  # the dispatch graph's body runs (`ops/dispatch.py`)
# The counter block (TTS_OBS=1, `obs/counters.py`): its eight slots, then the
# tree and sol the block last saw.
ST_CTR, ST_CTR_TREE, ST_CTR_SOL = 16, 24, 25
ST_LEN = 32


def new_state(size: int, best: int, device) -> torch.Tensor:
    st = torch.zeros(ST_LEN, dtype=torch.int32)
    st[ST_SIZE] = size
    st[ST_BEST] = best
    return st.to(device)


def cycle_chunk_plain(vals_c: torch.Tensor, aux_c: torch.Tensor,
                      valid: torch.Tensor, best: torch.Tensor,
                      tables: PFSPDeviceTables, bound=lb1_chunk, mark=None):
    """One cycle on a popped chunk — the JAX ``make_cycle`` PFSP contract
    under ``bound`` (``lb1_chunk`` or ``lb2_chunk``; the keep test is the
    unstaged one, as in the JAX megakernel).

    vals_c (M, n), aux_c (M,) limit1, valid (M,) bool, best 0-d int32.
    Returns ``(rows (M*n, n) int32, caux (M*n,) int32, tree_inc, sol_inc,
    best)`` (0-d int32 tensors): the survivors in (parent, slot) order, each
    its parent with positions limit1+1 and k swapped, with caux = limit1+1;
    rows past tree_inc are zero. Leaves fold into best before the keep test
    (`pfsp_chpl.chpl:100-111`). ``mark(slot)``, when given, is called after
    the bounds (``eval``) and after the keep ranks (``compact``): the
    boundaries of the CUDA cycle's phase marks.
    """
    M, n = vals_c.shape
    dev = vals_c.device
    aux = aux_c.to(torch.int32)
    lb = bound(vals_c, aux, tables)
    pdepth = aux + 1
    kk = torch.arange(n, dtype=torch.int32, device=dev)
    open_ = (kk[None, :] >= pdepth[:, None]) & valid[:, None]
    leaf = open_ & ((pdepth + 1) == n)[:, None]
    sol_inc = torch.sum(leaf, dtype=torch.int32)
    inf = torch.full_like(lb, INF_BOUND)
    best = torch.minimum(best.to(torch.int32), torch.where(leaf, lb, inf).min())
    if mark is not None:
        mark(IDX["eval"])
    keep = open_ & ~leaf & (lb < best)
    pi, kj = keep.nonzero(as_tuple=True)
    tree_inc = pi.numel()
    if mark is not None:
        mark(IDX["compact"])
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


def plain_marker(clk: torch.Tensor | None):
    """``mark(slot, flags=0)`` on a CPU phase clock (``phase_mark``), or
    None without one: the plain cycles' phase marks."""
    if clk is None:
        return None
    return lambda slot, flags=0: phase_mark(clk, slot, flags)


def plain_pool_cycle(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                     st: torch.Tensor, M: int, m: int, K: int,
                     chunk_cycle, mark=None) -> None:
    """One cycle on the pool, in place, around ``chunk_cycle(vals_c, aux_c,
    valid, best) -> (rows, caux, tree_inc, sol_inc, best)`` (a problem's
    chunk contract): the loop condition, the pop, the push of the survivors
    at the pool's size and the state update — what one fused CUDA cycle
    computes (reads the state on the host: plain, not the hot path).
    ``mark`` (``plain_marker``) opens an active cycle (``loop``) and closes
    it after the push (``push``); ``chunk_cycle`` marks in between."""
    C, n = pool_vals.shape
    size, _, _, _, cycles = (int(v) for v in st[:ST_ACTIVE].tolist())
    if not (size >= m and size + M * n <= C and cycles < K):
        st[ST_ACTIVE] = 0
        return
    if mark is not None:
        mark(IDX["loop"], OPEN)
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
    if mark is not None:
        mark(IDX["push"], CLOSE)


def cycle_pfsp_plain(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                     st: torch.Tensor, tables: PFSPDeviceTables, M: int,
                     m: int, K: int, bound, clk=None) -> None:
    """The whole PFSP cycle under ``bound`` on the pool, in place:
    condition, pop, bounds, prune, compaction and push, and the state
    update; with a CPU phase clock ``clk``, the CUDA cycle's marks
    (``loop``, ``eval``, ``compact``, ``push``) on the host's clock."""
    mark = plain_marker(clk)
    plain_pool_cycle(
        pool_vals, pool_aux, st, M, m, K,
        lambda v, a, valid, best: cycle_chunk_plain(v, a, valid, best, tables,
                                                    bound, mark), mark)


def cycle_lb1_plain(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                    st: torch.Tensor, tables: PFSPDeviceTables, M: int,
                    m: int, K: int, clk=None) -> None:
    """What one ``cycle_lb1_cuda`` call computes (kernel 2's plain
    version)."""
    cycle_pfsp_plain(pool_vals, pool_aux, st, tables, M, m, K, lb1_chunk, clk)


def cycle_lb2_plain(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                    st: torch.Tensor, tables: PFSPDeviceTables, M: int,
                    m: int, K: int, clk=None) -> None:
    """What one ``cycle_lb2_cuda`` call computes (kernel 8's plain
    version)."""
    cycle_pfsp_plain(pool_vals, pool_aux, st, tables, M, m, K, lb2_chunk, clk)


def mask_words(n: int) -> int:
    """uint32 keep-mask words of a parent with n child slots (bit k % 32
    of word k // 32 is slot k)."""
    return -(-n // 32)


def stash_block_bytes(nbytes: int) -> int:
    """Bytes of one block's stash region holding ``nbytes`` of popped rows
    at their pool address's phase mod 16 (``tts_stash_block_bytes`` of
    csrc/cycle_common.cuh): rounded up to 16, plus 16 of head room."""
    return -(-nbytes // 16) * 16 + 16


def scratch_sizes(M: int, n: int, itemsize: int, parents_per_block: int,
                  plane_words: int, counts: int = 1) -> dict:
    """Element counts of a ``CycleScratch`` for chunks of M parents of n
    elements of ``itemsize`` bytes, in blocks of ``parents_per_block``, with
    ``counts`` ints a block in ``blkcnt``."""
    nblk = -(-M // parents_per_block)
    return dict(
        chunk_vals=nblk * stash_block_bytes(parents_per_block * n * itemsize),
        chunk_aux=M, plane=plane_words, blkcnt=counts * nblk)


def pfsp_plane_words(M: int, n: int) -> int:
    """int32 words of the PFSP cycles' plane: the (M*n) bounds, then
    ``mask_words(n)`` keep-mask words a parent."""
    return M * n + M * mask_words(n)


@dataclass
class CycleScratch:
    """Device buffers of one fused cycle: the stash of the popped rows (a
    uint8 region of ``stash_block_bytes`` a block, the rows at the phase
    mod 16 of their pool address), the popped aux, the int32 plane (PFSP:
    the bounds and the keep masks, ``pfsp_plane_words``; N-Queens: one
    keep-mask word a parent) and the per-block survivor counts (the
    streamed cycles of `ops/tiled.py`: a (survivors, solutions) pair a
    block, ``counts`` = 2)."""

    chunk_vals: torch.Tensor
    chunk_aux: torch.Tensor
    plane: torch.Tensor
    blkcnt: torch.Tensor
    # The arguments of the last ``fits`` that held (the check runs once).
    _fits: tuple | None = field(default=None, repr=False, compare=False)

    @classmethod
    def make(cls, M: int, n: int, itemsize: int, aux_dtype: torch.dtype,
             plane_words: int, parents_per_block: int, device,
             counts: int = 1) -> "CycleScratch":
        sz = scratch_sizes(M, n, itemsize, parents_per_block, plane_words,
                           counts)
        return cls(
            chunk_vals=torch.empty(sz["chunk_vals"], dtype=torch.uint8,
                                   device=device),
            chunk_aux=torch.empty(M, dtype=aux_dtype, device=device),
            plane=torch.empty(plane_words, dtype=torch.int32, device=device),
            blkcnt=torch.empty(sz["blkcnt"], dtype=torch.int32, device=device),
        )

    def fits(self, M: int, n: int, itemsize: int, aux_dtype: torch.dtype,
             plane_words: int, parents_per_block: int,
             counts: int = 1) -> bool:
        """Whether these buffers are ``make``'s for those arguments, with
        a 16-aligned stash."""
        key = (M, n, itemsize, aux_dtype, plane_words, parents_per_block,
               counts)
        if self._fits == key:
            return True
        want = scratch_sizes(M, n, itemsize, parents_per_block, plane_words,
                             counts)
        ok = (all(getattr(self, k).numel() == v for k, v in want.items())
              and self.chunk_aux.dtype == aux_dtype
              and self.chunk_vals.data_ptr() % 16 == 0)
        self._fits = key if ok else None
        return ok


@functools.cache
def parents_per_block(source: str) -> int:
    """Parents a block of the counting and emit launches of
    ``csrc/<source>.cu`` holds (its stash and count layout)."""
    return _build.library(source).tts_cycle_parents_per_block()


def cycle_scratch(M: int, n: int, dtype: torch.dtype,
                  device: torch.device) -> CycleScratch:
    """The PFSP cycles' scratch (both take the same): the stash, pool-dtype
    limit1, and the int32 bounds and keep masks."""
    return CycleScratch.make(M, n, dtype.itemsize, dtype,
                             pfsp_plane_words(M, n),
                             parents_per_block("cycle_lb1"), device)


_ENTRIES = {
    "cycle_lb1": {torch.int8: "cycle_lb1_i8", torch.int32: "cycle_lb1_i32"},
    "cycle_lb2": {torch.int8: "cycle_lb2_i8", torch.int32: "cycle_lb2_i32"},
}
_ARGTYPES = {
    "cycle_lb1": (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6
    + COND_ARGTYPES + (ctypes.c_void_p,) * 2,
    "cycle_lb2": (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 8
    + COND_ARGTYPES + (ctypes.c_void_p,) * 2,
}
#: Phase marks a PFSP cycle enqueues with a clock (loop, eval, compact,
#: push), and an N-Queens cycle (loop, eval, push).
PFSP_MARKS, NQ_MARKS = 4, 3


def _launch_pfsp_cycle(source: str, pool_vals: torch.Tensor,
                       pool_aux: torch.Tensor, st: torch.Tensor,
                       scratch: CycleScratch, tables: PFSPDeviceTables,
                       M: int, m: int, K: int, table_args: tuple,
                       table_sizes: tuple, clk=None) -> None:
    """Check the operands of a PFSP cycle and enqueue the entry of
    ``csrc/<source>.cu``: the pool, state and scratch pointers, then
    ``table_args`` (tensors) and ``table_sizes`` (ints), then M, C, m, K,
    the graph's while node when the cycle is its body
    (``cycle_condition``), and the phase clock (None: no marks)."""
    if not pool_vals.is_cuda:
        raise ValueError(f"{source} takes CUDA tensors")
    entries = _ENTRIES[source]
    if pool_vals.dtype not in entries or pool_aux.dtype != pool_vals.dtype:
        raise TypeError("pool_vals and pool_aux must both be int8 or int32")
    C, n = pool_vals.shape
    if pool_aux.shape != (C,) or st.dtype != torch.int32 or st.numel() < ST_LEN:
        raise ValueError("pool_aux must be (C,) and st int32 of ST_LEN")
    if not (pool_vals.is_contiguous() and pool_aux.is_contiguous()
            and st.is_contiguous()):
        raise ValueError("pool and state tensors must be contiguous")
    if (n, tables.machines) != tuple(tables.ptm_t.shape):
        raise ValueError("pool width does not match the tables' job count")
    lib, fn = _build.entry(source, entries[pool_vals.dtype], _ARGTYPES[source])
    if C < M or not scratch.fits(M, n, pool_vals.element_size(),
                                 pool_vals.dtype, pfsp_plane_words(M, n),
                                 parents_per_block(source)):
        raise ValueError("scratch must be cycle_scratch(M, n) of the pool "
                         "dtype, and the pool hold at least M rows")
    clk_ptr = clock_pointer(clk)
    stream = torch.cuda.current_stream(pool_vals.device).cuda_stream
    err = fn(pool_vals.data_ptr(), pool_aux.data_ptr(), st.data_ptr(),
             scratch.chunk_vals.data_ptr(), scratch.chunk_aux.data_ptr(),
             scratch.plane.data_ptr(), scratch.blkcnt.data_ptr(),
             *(t.data_ptr() for t in table_args),
             *table_sizes, M, C, m, K, *cycle_condition(source), clk_ptr,
             stream)
    _build.check(lib, err, source)
    count_marks(clk, PFSP_MARKS)


def cycle_lb1_cuda(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                   st: torch.Tensor, scratch: CycleScratch,
                   tables: PFSPDeviceTables, M: int, m: int, K: int,
                   clk: torch.Tensor | None = None) -> None:
    """Enqueue one lb1 cycle (three launches; with a phase clock ``clk``
    four ``phase_mark`` launches between them) on the current stream;
    updates the pool and ``st`` in place on the device, never
    synchronises."""
    _launch_pfsp_cycle(
        "cycle_lb1", pool_vals, pool_aux, st, scratch, tables, M, m, K,
        (tables.ptm_t, tables.min_heads, tables.min_tails),
        (tables.jobs, tables.machines), clk)
    count_launch(cycle_lb1_cuda)


cycle_lb1_cuda.launches = 0  # type: ignore[attr-defined]
cycle_lb1_cuda.captures = 0  # type: ignore[attr-defined]


def cycle_lb2_cuda(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                   st: torch.Tensor, scratch: CycleScratch,
                   tables: PFSPDeviceTables, M: int, m: int, K: int,
                   clk: torch.Tensor | None = None) -> None:
    """Enqueue one lb2 cycle (three launches, and the marks of a phase
    clock ``clk``) on the current stream; updates the pool and ``st`` in
    place on the device, never synchronises."""
    if not pool_vals.is_cuda:
        raise ValueError("cycle_lb2 takes CUDA tensors")
    J = johnson_operands("cycle_lb2", tables)
    _launch_pfsp_cycle(
        "cycle_lb2", pool_vals, pool_aux, st, scratch, tables, M, m, K,
        (tables.ptm_t, tables.min_heads, J.pairinfo, J.tab, J.inv),
        (tables.jobs, tables.machines, J.pair_count, J.route), clk)
    count_launch(cycle_lb2_cuda)


cycle_lb2_cuda.launches = 0  # type: ignore[attr-defined]
cycle_lb2_cuda.captures = 0  # type: ignore[attr-defined]


def _route(cuda_cycle, plain_cycle, pool_vals, pool_aux, st, scratch, tables,
           M, m, K, clk) -> None:
    with route(cuda_cycle.__name__):
        if pool_vals.is_cuda:
            if scratch is None:
                raise ValueError("the CUDA cycle needs its cycle_scratch "
                                 "buffers")
            cuda_cycle(pool_vals, pool_aux, st, scratch, tables, M, m, K,
                       clk)
        else:
            plain_cycle(pool_vals, pool_aux, st, tables, M, m, K, clk)


def cycle_lb1(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
              st: torch.Tensor, scratch: CycleScratch | None,
              tables: PFSPDeviceTables, M: int, m: int, K: int,
              clk: torch.Tensor | None = None) -> None:
    """One lb1 cycle routed by device: the CUDA kernel for a CUDA pool
    (which launches or raises), the plain version for a CPU pool; ``clk``
    (on the pool's device) arms the phase marks."""
    _route(cycle_lb1_cuda, cycle_lb1_plain, pool_vals, pool_aux, st, scratch,
           tables, M, m, K, clk)


def cycle_lb2(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
              st: torch.Tensor, scratch: CycleScratch | None,
              tables: PFSPDeviceTables, M: int, m: int, K: int,
              clk: torch.Tensor | None = None) -> None:
    """One lb2 cycle routed like ``cycle_lb1``."""
    _route(cycle_lb2_cuda, cycle_lb2_plain, pool_vals, pool_aux, st, scratch,
           tables, M, m, K, clk)


# -- program contracts (`check`, analysis/contracts.py) ------------------------
# The fused cycle's claims (the JAX megakernel's, `megakernel.py:1295-1370`):
# here for the single-tile cycles, `ops/tiled.py` for the streamed ones.

from ..analysis.contracts import contract  # noqa: E402

#: Node kinds of a fused body besides its kernels: none.
_COPY_NODES = ("memcpy", "memcpy_host", "memset", "host")


@contract(
    "megakernel-knobs-inert",
    claim="the port chooses the cycle by its arguments (fused=, mt=): "
          "TTS_MEGAKERNEL and TTS_MEGAKERNEL_MT set in the environment "
          "record the unset program, and a tile width passed to the "
          "unfused cycle has no effect on it (the JAX Mt knob is inert "
          "with the kernel off)",
    artifact="variants",
)
def _contract_megakernel_knobs(art, cell):
    out = []
    if art.has("off", "mk-env") and art.text("off") != art.text("mk-env"):
        out.append("TTS_MEGAKERNEL/TTS_MEGAKERNEL_MT leaked into the "
                   "recorded program")
    if art.has("off", "mt") and art.text("off") != art.text("mt"):
        out.append("a tile width changed the unfused cycle")
    return out


@contract(
    "fused-single-launch",
    claim="the fused body (single-tile and streamed alike) is its cycle "
          "wrapper's launches alone, the cycle setting the loop condition "
          "itself (under TTS_OBS=1 the counter node dispatch_cond_obs after "
          "them): one route entry (cycle_* or tiled_*), no torch operation "
          "between, no dispatch_cond, and on the card no torch kernel, copy "
          "or memset node in the body; a build asked for the fused cycle "
          "that runs unfused (lb1_d, the mp pair axis) recorded why",
    artifact="cycle",
    applies=lambda cell: cell is not None and cell.fused,
)
def _contract_fused_single_launch(art, cell):
    prog, rec = art.prog, art.record
    if not prog.fused:
        if not getattr(prog, "unfused_reason", None):
            return ["a fused build runs the unfused cycle and recorded no "
                    "reason"]
        return []
    out = []
    cycle = rec.cycle_entries()
    routes = [e.name for e in cycle if e.kind == "route"]
    ops = [e.name for e in cycle if e.kind != "route"]
    want = "tiled_" if prog.tiled else "cycle_"
    if len(routes) != 1 or not routes[0].startswith(want):
        out.append(f"fused body routes {routes} (want one {want}* wrapper)")
    if ops:
        out.append(f"torch operations in the fused body: {sorted(set(ops))}")
    conds = [e.name for e in rec.body if e.name.startswith("dispatch_cond")]
    if conds != (["dispatch_cond_obs"] if prog.obs else []):
        out.append(f"fused body's condition nodes {conds} (want "
                   f"{'dispatch_cond_obs' if prog.obs else 'none'})")
    if rec.nodes is not None:
        bad = [nm for nm, k in rec.nodes["body"]
               if k in _COPY_NODES or "at6native" in nm
               or (not prog.obs and "dispatch_cond" in nm)]
        if bad:
            out.append(f"fused graph body holds {bad}")
    return out
