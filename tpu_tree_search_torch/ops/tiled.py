"""Kernels 9a, 9b and 9c: the streamed (tiled) resident cycle, as CUDA for
Hopper, and the streamed eval-only bound pass.

Kernel 9a replaces the TPU kernel `_mega_nqueens_tiled_kernel`, kernel 9b
`_mega_lb1_tiled_kernel`, kernel 9c `_mega_lb2_tiled_kernel`
(`tpu_tree_search/ops/megakernel.py`, with the tiled branch of `make_cycle`
and the stitch of `engine/resident.py`); sources `csrc/tiled_nqueens.cu`,
`csrc/tiled_lb1.cu` and `csrc/tiled_lb2.cu`, whose header notes give the
launches of a cycle and what bounds them on the card. Each runs the
single-tile cycle's launches (kernels 4, 2 and 8: `csrc/cycle_nqueens.cuh`,
`csrc/cycle_lb1.cuh`, `csrc/cycle_lb2.cuh`) and writes beside them a
boundary row, from which ``scal_from_bounds`` derives the per-tile scalars.

The streamed cycle computes what the single-tile cycle of `ops/cycle.py` and
`ops/cycle_nqueens.py` computes, with the popped chunk of M parents cut into
G = M / mt tiles: every tile compacts its survivors to the front of its own
(mt*n)-row block, and a carry across tiles (each tile's survivor offset and
cumulative solution count) places the blocks so that the pool ends up as
after the single-tile cycle. PFSP sweeps twice: every tile is bounded and
its leaves folded into the incumbent before any tile prunes. ``mt`` is the
counterpart of the JAX ``TTS_MEGAKERNEL_MT``; ``check_tile`` holds it to the
JAX rule (a multiple of 8 that divides M) and raises where the JAX resolver
records a refusal.

One call of ``tiled_lb1_cuda``, ``tiled_lb2_cuda`` or ``tiled_nqueens_cuda``
enqueues one cycle (three launches; two for N-Queens) on the loop state of
`ops/cycle.py`; when the loop condition is false it is an exact no-op. The
engine captures one call into its dispatch graph (`ops/dispatch.py`); each
wrapper's ``launches`` counts the cycles launched, as `ops/cycle.py`'s
wrappers do (``count_launch``).

The eval-only pass (``streamed_eval_bounds``, ``megakernel_lb2_bounds``;
the TPU kernels `_eval_lb1_kernel`, `_eval_nqueens_kernel` and
`_eval_lb2_kernel`) has no carry: its tiles are independent, so it is the
bound or label plane of the whole chunk, which kernels 1, 3 and 6
(`lb1_bounds_cuda`, `nqueens_labels_cuda`, `lb2_bounds_cuda`) compute for
any B.

Plain PyTorch versions beside them: ``tiled_chunk_plain`` computes what the
JAX tiled ``make_cycle`` returns for one popped chunk (the CPU tests hold it
to the Pallas kernels in interpret mode), ``tiled_cycle_plain`` is the whole
in-pool cycle with the stitch (the kernels' plain version, used on the CPU
and in the on-card comparison), and the eval pass's plain version is the
bound or label plane of the chunk.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable
from dataclasses import dataclass

import torch

from . import _build
from ..obs.phases import IDX
from .cycle import (
    NQ_MARKS,
    PFSP_MARKS,
    ST_LEN,
    CycleScratch,
    cycle_chunk_plain,
    parents_per_block,
    pfsp_plane_words,
    plain_marker,
    plain_pool_cycle,
)
from .cycle_nqueens import (
    check_nqueens_pool,
    cycle_nqueens_chunk_plain,
    depth_dtype,
    nq_mask_words,
)
from .dispatch import (COND_ARGTYPES, clock_pointer, count_launch, count_marks,
                       cycle_condition, route)
from .lb1_kernel import lb1_bounds_cuda
from .lb2_kernel import johnson_operands, lb2_bounds_cuda
from .nqueens_device import labels_chunk
from .nqueens_kernel import nqueens_labels_cuda
from .pfsp_device import PFSPDeviceTables, lb1_chunk, lb2_chunk


def check_tile(M: int, mt: int) -> int:
    """The tile count G = M // mt of a tile width that the streamed cycle
    takes: a positive multiple of 8 that divides M (`megakernel.py:371-376`).
    Raises ``ValueError`` naming the rule otherwise."""
    if mt <= 0 or mt % 8 or M % mt:
        raise ValueError(f"tile width mt={mt} must be a positive multiple "
                         f"of 8 that divides M={M}")
    return M // mt


def scal_from_bounds(bounds: torch.Tensor) -> torch.Tensor:
    """The (G, 4) per-tile scalars (offs, cnt, sol_cum, best) of the TPU
    kernels (`_tile_scalar_lanes`) from a (G + 1, 3) boundary row: row b
    holds, at the chunk's parent b*mt, the survivors and the solutions (or
    leaves) of the parents before it, and the incumbent; row G the cycle's
    tree_inc and sol_inc."""
    S, sol, best = bounds[:, 0], bounds[:, 1], bounds[:, 2]
    return torch.stack([S[:-1], S[1:] - S[:-1], sol[1:], best[1:]], 1)


@dataclass
class TileBoundsScratch:
    """Device buffers of kernels 9a, 9b and 9c: the single-tile cycle's scratch
    (``CycleScratch`` of `ops/cycle.py`, with a (survivors, solutions) pair
    a block in ``blkcnt``) and the boundary row ``bounds`` (G + 1, 3) int32
    that their emit writes (``scal_from_bounds``).

    ``scal`` derives the (G, 4) per-tile scalars from the boundary row when
    it is read. A tile's count needs the rows of both its boundaries, which
    two blocks may write; derived on read it needs no atomics and no second
    pass on the card, and no search reads the scalars (the single-tile
    cycle's offsets place the survivors)."""

    cycle: CycleScratch
    bounds: torch.Tensor

    @property
    def scal(self) -> torch.Tensor:
        return scal_from_bounds(self.bounds)

    @classmethod
    def make(cls, M: int, n: int, mt: int, itemsize: int,
             aux_dtype: torch.dtype, plane_words: int, parents_per_block: int,
             device) -> "TileBoundsScratch":
        G = check_tile(M, mt)
        return cls(
            cycle=CycleScratch.make(M, n, itemsize, aux_dtype, plane_words,
                                    parents_per_block, device, counts=2),
            bounds=torch.zeros((G + 1, 3), dtype=torch.int32, device=device))

    def pointers(self) -> tuple[int, ...]:
        """The scratch operands in the C entries' order."""
        c = self.cycle
        return (c.chunk_vals.data_ptr(), c.chunk_aux.data_ptr(),
                c.plane.data_ptr(), c.blkcnt.data_ptr(),
                self.bounds.data_ptr())


def tiled_lb1_scratch(M: int, n: int, mt: int, dtype: torch.dtype,
                      device) -> TileBoundsScratch:
    """Kernel 9b's (the streamed lb1 cycle's) scratch: kernel 2's
    (``cycle_scratch``) and the boundary row."""
    return TileBoundsScratch.make(M, n, mt, dtype.itemsize, dtype,
                                  pfsp_plane_words(M, n),
                                  parents_per_block("tiled_lb1"), device)


def tiled_lb2_scratch(M: int, n: int, mt: int, dtype: torch.dtype,
                      device) -> TileBoundsScratch:
    """Kernel 9c's (the streamed lb2 cycle's) scratch: kernel 8's
    (``cycle_scratch``) and the boundary row."""
    return TileBoundsScratch.make(M, n, mt, dtype.itemsize, dtype,
                                  pfsp_plane_words(M, n),
                                  parents_per_block("tiled_lb2"), device)


def tiled_nqueens_scratch(M: int, N: int, mt: int,
                          device) -> TileBoundsScratch:
    """Kernel 9a's (the streamed N-Queens cycle's) scratch: kernel 4's
    (``nqueens_scratch``) and the boundary row."""
    return TileBoundsScratch.make(M, N, mt, 1, depth_dtype(N),
                                  M * nq_mask_words(N),
                                  parents_per_block("tiled_nqueens"), device)


# -- plain versions ----------------------------------------------------------


def tiled_chunk_plain(spec, vals_c: torch.Tensor, aux_c: torch.Tensor,
                      valid: torch.Tensor, best: torch.Tensor, mt: int,
                      bound=lb1_chunk):
    """One streamed cycle on a popped chunk — the JAX tiled ``make_cycle``
    contract. ``spec`` is the PFSP tables (``bound`` ``lb1_chunk`` or
    ``lb2_chunk``) or an ``NQueensProblem``.

    Returns ``(rows (M*n, n) int32, caux (M*n,) int32, offs (G,), tree_inc,
    sol_inc, best, scal (G, 4))``: tile t's survivors compacted to the front
    of rows/caux block t (rows t*mt*n onwards; rows past its count are
    zero), ``scal[t]`` = (offs, cnt, sol_cum, best) (`_tile_scalar_lanes`),
    and the cycle's scalars from the last tile. PFSP bounds every tile and
    folds every leaf into the incumbent (phase 0) before any tile prunes
    (phase 1); tiles are compacted one by one with the single-tile chunk
    contract."""
    M = vals_c.shape[0]
    G = check_tile(M, mt)
    if isinstance(spec, PFSPDeviceTables):
        lb = bound(vals_c, aux_c.to(torch.int32), spec)  # phase 0: the stash
        # The incumbent folded over the leaves of every tile.
        best = cycle_chunk_plain(vals_c, aux_c, valid, best, spec,
                                 lambda *_: lb)[4]

        def tile(sl):
            return cycle_chunk_plain(vals_c[sl], aux_c[sl], valid[sl], best,
                                     spec, lambda *_: lb[sl])
    else:
        def tile(sl):
            return cycle_nqueens_chunk_plain(vals_c[sl], aux_c[sl], valid[sl],
                                             best, spec.N, spec.g)
    outs = [tile(slice(t * mt, (t + 1) * mt)) for t in range(G)]
    cnt = torch.stack([o[2] for o in outs])
    sol_cum = torch.cumsum(torch.stack([o[3] for o in outs]), 0,
                           dtype=torch.int32)
    offs = (torch.cumsum(cnt, 0, dtype=torch.int32) - cnt).to(torch.int32)
    best = outs[-1][4]
    scal = torch.stack([offs, cnt, sol_cum, best.expand(G)], 1)
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            offs, offs[-1] + cnt[-1], sol_cum[-1], best, scal)


def tiled_cycle_plain(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                      st: torch.Tensor, spec, M: int, mt: int, m: int, K: int,
                      bound=lb1_chunk, clk=None) -> torch.Tensor | None:
    """The whole streamed cycle on the pool, in place: condition, pop,
    ``tiled_chunk_plain``, the stitch of `engine/resident.py:257-270` (tile
    t's block written at the pool's size + offs[t], in tile order, so each
    block's zero tail is overwritten by the next tile's rows) and the state
    update. The pool and state end as after the single-tile cycle. Returns
    the (G, 4) per-tile scalars, or None when the cycle is a no-op. With a
    CPU phase clock ``clk``, the streamed CUDA cycle's marks: ``eval``
    after the tiles, for PFSP ``compact`` after their stitch, ``push``."""
    n = pool_vals.shape[1]
    Mtn = mt * n
    out = {}
    mark = plain_marker(clk)
    pfsp = isinstance(spec, PFSPDeviceTables)

    def chunk_cycle(vals_c, aux_c, valid, best):
        rows, caux, offs, tree_inc, sol_inc, best, scal = tiled_chunk_plain(
            spec, vals_c, aux_c, valid, best, mt, bound)
        if mark is not None:
            mark(IDX["eval"])
        out["scal"] = scal
        stitched_rows, stitched_aux = torch.zeros_like(rows), torch.zeros_like(caux)
        for t, o in enumerate(offs.tolist()):
            stitched_rows[o:o + Mtn] = rows[t * Mtn:(t + 1) * Mtn]
            stitched_aux[o:o + Mtn] = caux[t * Mtn:(t + 1) * Mtn]
        if mark is not None and pfsp:
            mark(IDX["compact"])
        return stitched_rows, stitched_aux, tree_inc, sol_inc, best

    plain_pool_cycle(pool_vals, pool_aux, st, M, m, K, chunk_cycle, mark)
    return out.get("scal")


def tiled_lb1_plain(pool_vals, pool_aux, st, tables: PFSPDeviceTables,
                    M: int, mt: int, m: int, K: int, clk=None):
    """What one ``tiled_lb1_cuda`` call computes (kernel 9b's plain
    version); returns the (G, 4) per-tile scalars or None."""
    return tiled_cycle_plain(pool_vals, pool_aux, st, tables, M, mt, m, K,
                             lb1_chunk, clk)


def tiled_lb2_plain(pool_vals, pool_aux, st, tables: PFSPDeviceTables,
                    M: int, mt: int, m: int, K: int, clk=None):
    """What one ``tiled_lb2_cuda`` call computes (kernel 9c's plain
    version)."""
    return tiled_cycle_plain(pool_vals, pool_aux, st, tables, M, mt, m, K,
                             lb2_chunk, clk)


def tiled_nqueens_plain(pool_vals, pool_aux, st, problem, M: int, mt: int,
                        m: int, K: int, clk=None):
    """What one ``tiled_nqueens_cuda`` call computes (kernel 9a's plain
    version); ``problem`` is the ``NQueensProblem`` (N and g)."""
    return tiled_cycle_plain(pool_vals, pool_aux, st, problem, M, mt, m, K,
                             clk=clk)


# -- the CUDA cycles ---------------------------------------------------------

_ENTRIES = {
    "tiled_lb1": {torch.int8: "tiled_lb1_i8", torch.int32: "tiled_lb1_i32"},
    "tiled_lb2": {torch.int8: "tiled_lb2_i8", torch.int32: "tiled_lb2_i32"},
    "tiled_nqueens": {torch.int8: "tiled_nqueens",
                      torch.int32: "tiled_nqueens_i32"},
}
_ARGTYPES = {
    "tiled_lb1": (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 7
    + COND_ARGTYPES + (ctypes.c_void_p,) * 2,
    "tiled_lb2": (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 9
    + COND_ARGTYPES + (ctypes.c_void_p,) * 2,
    "tiled_nqueens": (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7
    + COND_ARGTYPES + (ctypes.c_void_p,) * 2,
}


def _launch_tiled(source: str, pool_vals: torch.Tensor,
                  pool_aux: torch.Tensor, st: torch.Tensor,
                  scratch: TileBoundsScratch, n: int,
                  M: int, mt: int, m: int, K: int,
                  operands: Callable[[], tuple],
                  scratch_fits: Callable[[], bool], clk=None,
                  marks: int = 0) -> None:
    """Check the operands of a streamed cycle and enqueue the entry of
    ``csrc/<source>.cu``: the pool, state and scratch pointers, then the
    table tensors and the sizes (ints: the width and the tables' sizes) that
    ``operands()`` returns once the pool is checked, then M, mt, C, m, K.
    ``scratch_fits()``, called once the library is loaded, says whether
    ``scratch`` is the one the entry takes. ``clk`` (None: no marks) is the
    phase clock, whose ``marks`` launches the entry then enqueues."""
    if not pool_vals.is_cuda:
        raise ValueError(f"{source} takes CUDA tensors")
    check_tile(M, mt)
    entries = _ENTRIES[source]
    C = pool_vals.shape[0]
    # The PFSP entries are by the pool's one type; N-Queens (a uint8 board,
    # checked by check_nqueens_pool) by its depth's.
    key = pool_aux.dtype if source == "tiled_nqueens" else pool_vals.dtype
    if key not in entries or pool_aux.dtype != key:
        raise TypeError(f"{source}: the pool's types are not the kernel's")
    if pool_vals.shape != (C, n) or pool_aux.shape != (C,) \
            or st.dtype != torch.int32 or st.numel() < ST_LEN:
        raise ValueError(f"pool_vals must be (C, {n}), pool_aux (C,) and st "
                         "int32 of ST_LEN")
    if not (pool_vals.is_contiguous() and pool_aux.is_contiguous()
            and st.is_contiguous()):
        raise ValueError("pool and state tensors must be contiguous")
    table_args, sizes = operands()
    lib, fn = _build.entry(source, entries[key], _ARGTYPES[source])
    if C < M or not scratch_fits():
        raise ValueError(f"scratch must be the {source} scratch of (M, mt), "
                         "and the pool hold at least M rows")
    clk_ptr = clock_pointer(clk)
    stream = torch.cuda.current_stream(pool_vals.device).cuda_stream
    err = fn(pool_vals.data_ptr(), pool_aux.data_ptr(), st.data_ptr(),
             *scratch.pointers(), *(t.data_ptr() for t in table_args),
             *sizes, M, mt, C, m, K, *cycle_condition(source), clk_ptr,
             stream)
    _build.check(lib, err, source)
    count_marks(clk, marks)


def _bounds_fits(source: str, scratch, M: int, n: int, mt: int,
                 itemsize: int, aux_dtype: torch.dtype,
                 plane_words: int) -> bool:
    """Whether ``scratch`` is kernel 9a's, 9b's or 9c's for these sizes."""
    return (isinstance(scratch, TileBoundsScratch)
            and scratch.bounds.shape == (M // mt + 1, 3)
            and scratch.bounds.dtype == torch.int32
            and scratch.cycle.fits(M, n, itemsize, aux_dtype, plane_words,
                                   parents_per_block(source), counts=2))


def tiled_lb1_cuda(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                   st: torch.Tensor, scratch: TileBoundsScratch,
                   tables: PFSPDeviceTables, M: int, mt: int, m: int,
                   K: int, clk: torch.Tensor | None = None) -> None:
    """Enqueue one streamed lb1 cycle (kernel 2's three launches, with the
    boundary row) on the current stream; updates the pool, ``st`` and
    ``scratch.bounds`` in place on the device, never synchronises."""
    n = tables.jobs
    _launch_tiled(
        "tiled_lb1", pool_vals, pool_aux, st, scratch, n, M, mt, m, K,
        lambda: ((tables.ptm_t, tables.min_heads, tables.min_tails),
                 (tables.jobs, tables.machines)),
        lambda: _bounds_fits("tiled_lb1", scratch, M, n, mt,
                             pool_vals.element_size(), pool_vals.dtype,
                             pfsp_plane_words(M, n)), clk, PFSP_MARKS)
    count_launch(tiled_lb1_cuda)


tiled_lb1_cuda.launches = 0  # type: ignore[attr-defined]
tiled_lb1_cuda.captures = 0  # type: ignore[attr-defined]


def tiled_lb2_cuda(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                   st: torch.Tensor, scratch: TileBoundsScratch,
                   tables: PFSPDeviceTables, M: int, mt: int, m: int,
                   K: int, clk: torch.Tensor | None = None) -> None:
    """Enqueue one streamed lb2 cycle (kernel 8's three launches, with the
    boundary row) on the current stream; updates the pool, ``st`` and
    ``scratch.bounds`` in place on the device, never synchronises. Raises
    ``NotImplementedError`` on an instance kernel 8 does not take."""
    n = tables.jobs

    def operands():
        J = johnson_operands("tiled_lb2", tables)
        return ((tables.ptm_t, tables.min_heads, J.pairinfo, J.tab, J.inv),
                (tables.jobs, tables.machines, J.pair_count, J.route))

    _launch_tiled(
        "tiled_lb2", pool_vals, pool_aux, st, scratch, n, M, mt, m, K,
        operands,
        lambda: _bounds_fits("tiled_lb2", scratch, M, n, mt,
                             pool_vals.element_size(), pool_vals.dtype,
                             pfsp_plane_words(M, n)), clk, PFSP_MARKS)
    count_launch(tiled_lb2_cuda)


tiled_lb2_cuda.launches = 0  # type: ignore[attr-defined]
tiled_lb2_cuda.captures = 0  # type: ignore[attr-defined]


def tiled_nqueens_cuda(pool_vals: torch.Tensor, pool_aux: torch.Tensor,
                       st: torch.Tensor, scratch: TileBoundsScratch, problem,
                       M: int, mt: int, m: int, K: int,
                       clk: torch.Tensor | None = None) -> None:
    """Enqueue one streamed N-Queens cycle (kernel 4's two launches, with
    the boundary row) on the current stream; ``problem`` gives N (<= 256)
    and g."""
    N, g = problem.N, problem.g
    check_nqueens_pool("tiled_nqueens", pool_vals, pool_aux, st, N, g)
    _launch_tiled(
        "tiled_nqueens", pool_vals, pool_aux, st, scratch, N, M, mt, m, K,
        lambda: ((), (N, g)),
        lambda: _bounds_fits("tiled_nqueens", scratch, M, N, mt, 1,
                             depth_dtype(N), M * nq_mask_words(N)), clk,
        NQ_MARKS)
    count_launch(tiled_nqueens_cuda)


tiled_nqueens_cuda.launches = 0  # type: ignore[attr-defined]
tiled_nqueens_cuda.captures = 0  # type: ignore[attr-defined]


def _route(cuda_cycle, plain_cycle, pool_vals, pool_aux, st, scratch, spec,
           M, mt, m, K, clk) -> None:
    with route(cuda_cycle.__name__):
        if pool_vals.is_cuda:
            if scratch is None:
                raise ValueError("the CUDA streamed cycle needs its scratch "
                                 "buffers")
            cuda_cycle(pool_vals, pool_aux, st, scratch, spec, M, mt, m, K,
                       clk)
        else:
            plain_cycle(pool_vals, pool_aux, st, spec, M, mt, m, K, clk)


def tiled_lb1(pool_vals, pool_aux, st, scratch: TileBoundsScratch | None,
              tables: PFSPDeviceTables, M: int, mt: int, m: int, K: int,
              clk: torch.Tensor | None = None):
    """One streamed lb1 cycle routed by device: the CUDA kernel for a CUDA
    pool (which launches or raises), the plain version for a CPU pool;
    ``clk`` arms the phase marks."""
    _route(tiled_lb1_cuda, tiled_lb1_plain, pool_vals, pool_aux, st, scratch,
           tables, M, mt, m, K, clk)


def tiled_lb2(pool_vals, pool_aux, st, scratch: TileBoundsScratch | None,
              tables: PFSPDeviceTables, M: int, mt: int, m: int, K: int,
              clk: torch.Tensor | None = None):
    """One streamed lb2 cycle routed like ``tiled_lb1``."""
    _route(tiled_lb2_cuda, tiled_lb2_plain, pool_vals, pool_aux, st, scratch,
           tables, M, mt, m, K, clk)


def tiled_nqueens(pool_vals, pool_aux, st, scratch: TileBoundsScratch | None,
                  problem, M: int, mt: int, m: int, K: int,
                  clk: torch.Tensor | None = None):
    """One streamed N-Queens cycle routed like ``tiled_lb1``."""
    _route(tiled_nqueens_cuda, tiled_nqueens_plain, pool_vals, pool_aux, st,
           scratch, problem, M, mt, m, K, clk)


# -- the eval-only pass ------------------------------------------------------


def _family(problem) -> str:
    fam = problem.lb if problem.name == "pfsp" else problem.name
    if fam not in ("nqueens", "lb1", "lb2"):
        raise ValueError(f"streamed_eval_bounds: unsupported family {fam!r}")
    return fam


def streamed_eval_bounds(problem, vals: torch.Tensor, aux: torch.Tensor,
                         mt: int | None = None) -> torch.Tensor:
    """The eval-only streamed pass over a (B, n) chunk
    (`megakernel.py:1230`): the (B, n) int32 bound plane (PFSP lb1 or lb2;
    slots k <= limit1 are not children) or label plane (N-Queens, every
    slot). ``mt`` defaults to B and must divide B and be a multiple of 8, as
    in the JAX entry; the tiles are independent, so the plane does not
    depend on it. A CUDA chunk goes to kernel 1, 6 or 3 (PFSP rows int8 or
    int32; an N-Queens board uint8), a CPU chunk to the plain plane."""
    fam = _family(problem)
    B = vals.shape[0]
    mt = mt or B
    if B % mt or mt % 8:
        raise ValueError(f"streamed_eval_bounds: tile {mt} must divide B={B} "
                         "and be a multiple of 8")
    if fam == "nqueens":
        if vals.is_cuda:
            labels = nqueens_labels_cuda(vals, aux, problem.N, problem.g)
        else:
            labels = labels_chunk(vals, aux, problem.N, problem.g)
        return labels.to(torch.int32)
    tables = problem.device_tables(vals.device)
    if vals.is_cuda:
        cuda = lb1_bounds_cuda if fam == "lb1" else lb2_bounds_cuda
        return cuda(vals, aux, tables)
    return (lb1_chunk if fam == "lb1" else lb2_chunk)(vals, aux, tables)


def megakernel_lb2_bounds(prmu: torch.Tensor, limit1: torch.Tensor,
                          tables: PFSPDeviceTables) -> torch.Tensor:
    """The lb2 plane the streamed lb2 cycle bounds with, as a standalone
    (B, n) call for any B (`megakernel.py:1279`): kernel 6 for a CUDA chunk,
    ``lb2_chunk`` for a CPU one. int32 throughout, so it is exact with no
    bf16 gate."""
    if prmu.is_cuda:
        return lb2_bounds_cuda(prmu, limit1, tables)
    return lb2_chunk(prmu, limit1, tables)
