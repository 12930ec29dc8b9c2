"""The mesh-resident tier's balance step and its dispatch graph.

``mesh_balance`` is what the JAX ``shard_step`` does after each round of
its K-cycle loops (`tpu_tree_search/parallel/resident_mesh.py:200-270`):
the ``lax.pmin`` of the shards' incumbents and one round of ring diffusion,
in which shard d gives the front of its pool to shard (d + 1) % D when
that one is starving. On the card the D shards sit on one device, and the
step is three launches of ``csrc/mesh_balance.cu`` (its header note gives
the design); ``mesh_balance_plain`` is the same step in plain PyTorch, used
on the CPU and by the tests. Each also keeps the dispatch's sums over its
rounds in the state words ``ST_MESH_*`` and, on the last round, writes them
where a dispatch's counts are read. Not a TPU kernel: the JAX step is XLA
collectives (``pmin``, ``all_gather``, ``ppermute``).

``MeshGraph`` is one mesh dispatch as one CUDA graph (the builders in
`csrc/dispatch_graph.cu`): for each round, the batched engine's
``batch_init``, a ``while`` node over the D shards' cycles (captured in
shard order, then ``batch_cond``: a shard whose condition fails is frozen,
as a batch slot is) and the balance step captured as a child graph, with
the phase clock's ``loop`` and ``balance`` marks around it when armed.

Layout: the states are one (D, ST_LEN) int32 tensor, a row a shard; the
pools one (D, C, n) tensor of rows and one (D, C) column; the kernel also
takes a staging copy of D // 2 shards of both (at most D // 2 shards give
in a round: a donor's right neighbour is a receiver, and no shard both
gives and takes) and a (D, 4) int32 plan (``MeshScratch``).
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass

import torch

from ..obs import phases as obs_phases
from . import _build
from .cycle import (ST_BEST, ST_CTR_SOL, ST_CTR_TREE, ST_CYCLES, ST_LEN,
                    ST_RUNS, ST_SIZE, ST_SOL, ST_TREE)
from .dispatch import (DispatchGraph, _fn, batch_cond, batch_cond_obs,
                       batch_init, clock_pointer, count_launch,
                       phase_mark_cuda, recording)

# The dispatch's sums over its rounds (csrc/mesh_balance.cu); row 0's
# ST_MESH_COND counts the condition node's runs.
ST_MESH_TREE, ST_MESH_SOL, ST_MESH_CYCLES, ST_MESH_RUNS = 10, 11, 12, 13
ST_MESH_COND = 14

_VP = ctypes.c_void_p
# st, D, the pools, the staging copies, the plan; rowb, auxb, C, m, T; Mn;
# first, last; the stream.
_ARGTYPES = (_VP, ctypes.c_int, _VP, _VP, _VP, _VP, _VP) + (ctypes.c_int,) * 5 \
    + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP)


def balance_plan(sizes: list[int], m: int, T: int, Mn: int,
                 C: int) -> tuple[list[int], list[int]]:
    """Each shard's gift to its right neighbour and intake from its left
    one, from the size vector (`resident_mesh.py:207-233`): d gives
    ``min(size // 2, T)`` iff the receiver holds < m, the donor >= 2m and
    the receiver has room for ``T + Mn`` more rows (the capacity ``C``)."""
    D = len(sizes)
    give, take = [0] * D, [0] * D
    if D == 1:
        return give, take
    for d, sz in enumerate(sizes):
        right, left = sizes[(d + 1) % D], sizes[(d - 1) % D]
        if right < m and sz >= 2 * m and right + T + Mn <= C:
            give[d] = min(sz // 2, T)
        if sz < m and left >= 2 * m and sz + T + Mn <= C:
            take[d] = min(left // 2, T)
    return give, take


def mesh_balance_plain(st: torch.Tensor, pool_vals: torch.Tensor,
                       pool_aux: torch.Tensor, m: int, T: int, Mn: int,
                       first: bool, last: bool) -> None:
    """One balance step in plain PyTorch, in place: ``st`` (D, ST_LEN),
    ``pool_vals`` (D, C, n), ``pool_aux`` (D, C) on any device. What
    ``mesh_balance_cuda`` computes, word for word and for every live row:
    the incumbent fold, the gifts (each receiver appends its left
    neighbour's first ``take`` rows at its size, each donor drops its first
    ``give`` rows, the live rows in order), the sizes, and the round's
    counts added to the dispatch's sums (``first``: the first round;
    ``last``: written back where the counts are read)."""
    D, C = pool_aux.shape
    v = st.tolist()
    sizes = [r[ST_SIZE] for r in v]
    best = min(r[ST_BEST] for r in v)
    runs = max(r[ST_RUNS] for r in v)
    give, take = balance_plan(sizes, m, T, Mn, C)
    for d in range(D):
        if take[d]:
            left, sz, k = (d - 1) % D, sizes[d], take[d]
            pool_vals[d, sz:sz + k] = pool_vals[left, :k].clone()
            pool_aux[d, sz:sz + k] = pool_aux[left, :k].clone()
    for d in range(D):
        if give[d]:
            g, sz = give[d], sizes[d]
            pool_vals[d, :sz - g] = pool_vals[d, g:sz].clone()
            pool_aux[d, :sz - g] = pool_aux[d, g:sz].clone()
    for d, r in enumerate(v):
        r[ST_SIZE] = sizes[d] - give[d] + take[d]
        r[ST_BEST] = best
        sums = (r[ST_TREE], r[ST_SOL], r[ST_CYCLES], r[ST_RUNS])
        for word, val in zip((ST_MESH_TREE, ST_MESH_SOL, ST_MESH_CYCLES,
                              ST_MESH_RUNS), sums):
            r[word] = val if first else r[word] + val
        r[ST_CTR_TREE] = r[ST_CTR_SOL] = 0
        if last:
            r[ST_TREE], r[ST_SOL] = r[ST_MESH_TREE], r[ST_MESH_SOL]
            r[ST_CYCLES], r[ST_RUNS] = r[ST_MESH_CYCLES], r[ST_MESH_RUNS]
    v[0][ST_MESH_COND] = (0 if first else v[0][ST_MESH_COND]) + runs
    st.copy_(torch.tensor(v, dtype=torch.int32))


@dataclass
class MeshScratch:
    """The balance kernel's buffers: a staging slot of a shard's rows and
    column for each of at most D // 2 donors (where a donor's kept rows
    wait while its front is dropped) and the (D, 4) plan (size before,
    gift, intake, the donor's slot)."""

    stage_vals: torch.Tensor
    stage_aux: torch.Tensor
    plan: torch.Tensor

    @classmethod
    def make(cls, pool_vals: torch.Tensor,
             pool_aux: torch.Tensor) -> "MeshScratch":
        D, C = pool_aux.shape
        return cls(pool_vals.new_empty((D // 2,) + tuple(pool_vals.shape[1:])),
                   pool_aux.new_empty((D // 2, C)),
                   torch.zeros((D, 4), dtype=torch.int32,
                               device=pool_aux.device))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.stage_vals, self.stage_aux, self.plan))


def mesh_balance_cuda(st: torch.Tensor, pool_vals: torch.Tensor,
                      pool_aux: torch.Tensor, scratch: MeshScratch, m: int,
                      T: int, Mn: int, first: bool, last: bool) -> None:
    """Enqueue one balance step (``mesh_plan``, and with D > 1 ``mesh_move``
    and ``mesh_shed``) on the current stream; never synchronises."""
    if not (st.is_cuda and pool_vals.is_cuda and pool_aux.is_cuda):
        raise ValueError("mesh_balance_cuda takes CUDA tensors")
    D, C = pool_aux.shape
    if (st.shape != (D, ST_LEN) or st.dtype != torch.int32
            or pool_vals.dim() != 3 or pool_vals.shape[:2] != (D, C)):
        raise ValueError("st must be (D, ST_LEN) int32, the pools (D, C, n) "
                         "and (D, C)")
    if not all(t.is_contiguous() for t in (st, pool_vals, pool_aux)):
        raise ValueError("the states and pools must be contiguous")
    if not 1 <= D <= 1024:
        raise ValueError(f"1 <= D <= 1024 shards, got {D}")
    if (scratch.stage_vals.shape != (D // 2,) + pool_vals.shape[1:]
            or scratch.stage_vals.dtype != pool_vals.dtype
            or scratch.stage_aux.shape != (D // 2, C)
            or scratch.stage_aux.dtype != pool_aux.dtype
            or scratch.plan.shape != (D, 4)):
        raise ValueError("scratch must be MeshScratch.make of these pools")
    rowb = pool_vals.shape[2] * pool_vals.element_size()
    lib, fn = _build.entry("mesh_balance", "mesh_balance_enqueue", _ARGTYPES)
    stream = torch.cuda.current_stream(st.device).cuda_stream
    err = fn(st.data_ptr(), D, pool_vals.data_ptr(), pool_aux.data_ptr(),
             scratch.stage_vals.data_ptr(), scratch.stage_aux.data_ptr(),
             scratch.plan.data_ptr(), rowb, pool_aux.element_size(), C, m, T,
             Mn, int(first), int(last), stream)
    _build.check(lib, err, "mesh_balance")
    count_launch(mesh_balance_cuda)


mesh_balance_cuda.launches = 0  # type: ignore[attr-defined]
mesh_balance_cuda.captures = 0  # type: ignore[attr-defined]


def mesh_balance(st: torch.Tensor, pool_vals: torch.Tensor,
                 pool_aux: torch.Tensor, scratch: MeshScratch | None, m: int,
                 T: int, Mn: int, first: bool, last: bool) -> None:
    """One balance step routed by device: the kernel for CUDA tensors
    (which launches or raises), the plain version for CPU ones."""
    if st.is_cuda:
        if scratch is None:
            raise ValueError("the CUDA balance step needs its MeshScratch")
        mesh_balance_cuda(st, pool_vals, pool_aux, scratch, m, T, Mn, first,
                          last)
    else:
        mesh_balance_plain(st, pool_vals, pool_aux, m, T, Mn, first, last)


_MESH_ARGS = {
    "mesh_graph_create": (ctypes.POINTER(_VP),),
    "mesh_graph_add_round": (_VP, _VP, _VP, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, _VP, ctypes.POINTER(_VP),
                             ctypes.POINTER(ctypes.c_ulonglong),
                             ctypes.POINTER(_VP)),
    "mesh_graph_begin_child": (_VP,),
    "mesh_graph_end_child": (_VP, ctypes.c_int, _VP, _VP,
                             ctypes.POINTER(_VP)),
}


def _mesh_fn(name: str):
    return _build.entry("dispatch_graph", name, _MESH_ARGS[name])


class MeshGraph(DispatchGraph):
    """One mesh dispatch as a CUDA graph over the (D, ST_LEN) states ``st``:
    ``rounds`` times ``batch_init``, a ``while`` node over ``cycles`` (one
    callable a shard, each enqueueing one cycle of its shard) and
    ``batch_cond`` (``batch_cond_obs`` with ``obs``, the child slots a
    parent), and the child graph of ``balance(round)``, which enqueues the
    round's balance step. With a phase clock ``clk`` a seed mark opens the
    dispatch and ``loop``/``balance`` marks bracket each balance step; the
    cycles mark the same clock through their own entries."""

    def __init__(self, cycles: list, balance, st: torch.Tensor, m: int,
                 Mn: int, C: int, K: int, rounds: int, obs: int = 0,
                 clk: torch.Tensor | None = None):
        if not st.is_cuda or st.dim() != 2 or len(cycles) != st.shape[0]:
            raise ValueError("MeshGraph takes a CUDA (D, ST_LEN) state "
                             "tensor and one cycle a row")
        t0 = time.perf_counter()
        self.K = K
        self.st = st
        self.clk = clk
        self.rounds = rounds
        # The wrappers each shard's cycle records (round 0's capture; every
        # round runs the same ones) and the condition node.
        self.slot_wrappers: list[list] = [[] for _ in cycles]
        self.cond = batch_cond_obs if obs else batch_cond
        self.wrappers = []
        self._graph = _VP()
        self._exec = _VP()
        self._body = _VP()
        lib, create = _mesh_fn("mesh_graph_create")
        _build.check(lib, create(ctypes.byref(self._graph)),
                     "mesh_graph_create")
        try:
            self._build_rounds(lib, cycles, balance, m, Mn, C, K, obs)
            _, inst = _fn("dispatch_graph_instantiate")
            _build.check(lib, inst(self._graph, ctypes.byref(self._exec)),
                         "dispatch_graph_instantiate")
        except BaseException:
            self.close()
            raise
        self.build_s = time.perf_counter() - t0
        _build.count_build("graphs")

    def _build_rounds(self, lib, cycles, balance, m, Mn, C, K, obs) -> None:
        _, add_round = _mesh_fn("mesh_graph_add_round")
        _, begin = _fn("dispatch_graph_begin_body")
        _, end = _fn("batch_graph_end_body")
        _, begin_child = _mesh_fn("mesh_graph_begin_child")
        _, end_child = _mesh_fn("mesh_graph_end_child")
        side = torch.cuda.Stream(self.st.device)
        B = self.st.shape[0]
        dep = _VP()
        for r in range(self.rounds):
            body, loop = _VP(), _VP()
            handle = ctypes.c_ulonglong()
            seed = clock_pointer(self.clk) if r == 0 else None
            _build.check(lib, add_round(
                self._graph, dep, self.st.data_ptr(), B, m, Mn, C, K,
                int(bool(obs) and r == 0), seed, ctypes.byref(body),
                ctypes.byref(handle), ctypes.byref(loop)),
                "mesh_graph_add_round")
            if r == 0:
                self._body = body
            _build.check(lib, begin(body, side.cuda_stream),
                         "dispatch_graph_begin_body")
            ok = 0
            try:
                with torch.cuda.stream(side):
                    for cycle, wrappers in zip(cycles, self.slot_wrappers):
                        with recording(wrappers if r == 0 else []):
                            cycle()
                ok = 1
            finally:
                err = end(side.cuda_stream, ok, self.st.data_ptr(), B,
                          handle.value, m, Mn, C, K, obs)
            _build.check(lib, err, "batch_graph_end_body")
            _build.check(lib, begin_child(side.cuda_stream),
                         "mesh_graph_begin_child")
            ok = 0
            node = _VP()
            try:
                with torch.cuda.stream(side), recording([]):
                    if self.clk is not None:
                        phase_mark_cuda(self.clk, obs_phases.IDX["loop"])
                    balance(r)
                    if self.clk is not None:
                        phase_mark_cuda(self.clk, obs_phases.IDX["balance"])
                ok = 1
            finally:
                err = end_child(side.cuda_stream, ok, self._graph, loop,
                                ctypes.byref(node))
            _build.check(lib, err, "mesh_graph_end_child")
            dep = node

    def launch(self) -> None:
        """Enqueue one mesh dispatch on the current stream."""
        lib, fn = _fn("dispatch_graph_launch")
        stream = torch.cuda.current_stream(self.st.device).cuda_stream
        _build.check(lib, fn(self._exec, stream), "dispatch_graph_launch")
        _build.add_launches(MeshGraph)
        _build.add_launches(batch_init, self.rounds)
        _build.add_launches(mesh_balance_cuda, self.rounds)
        if self.clk is not None:
            _build.add_launches(phase_mark_cuda, 1 + 2 * self.rounds)

    def count(self, rows: list[list[int]]) -> None:
        """Count a dispatch from its states read after it: each shard's
        body runs (``st[ST_RUNS]``, the sum over the rounds) as launches of
        the wrappers its capture recorded, and row 0's ``ST_MESH_COND`` as
        the condition node's."""
        for wrappers, row in zip(self.slot_wrappers, rows):
            for w in wrappers:
                _build.add_launches(w, row[ST_RUNS])
        _build.add_launches(self.cond, rows[0][ST_MESH_COND])


#: Mesh graph launches in this process (all mesh programs).
MeshGraph.launches = 0
