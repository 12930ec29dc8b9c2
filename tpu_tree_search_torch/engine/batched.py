"""Instance-axis batched resident engine — the port of
`tpu_tree_search/engine/batched.py`.

The resident engine (`engine/resident.py`) runs one search a program. For a
fleet of small same-shape jobs each job would pay the dispatch latency
alone, so this module makes the instance one more axis of a program: B
slots, each with its own pool, incumbent and counts, and one dispatch that
advances every live slot by up to K cycles.

Two rules keep every slot bit-identical to a solo run:

  * **Each slot runs its own solo cycles, masked by its own condition.**
    The B slots' scalar blocks are the rows of one (B, ST_LEN) int32
    tensor; each slot owns a pool of the program's capacity. On the card
    a dispatch is one CUDA graph (`ops/dispatch.py` ``BatchGraph``):
    ``batch_init``, then a ``while`` node whose body is each slot's cycle
    in slot order (the resident program's own cycle on that slot's state:
    the fused one, kernels 2, 4, 8 or 9a-c, or the unfused one of fixed
    shapes, under an ``if`` node of the slot's own) and one
    ``batch_cond``; a slot whose condition is false runs an exact no-op
    (the unfused cycle: nothing), the counterpart of the JAX
    ``jnp.where(live, new, old)``. On the CPU a dispatch runs rounds on the host
    (``host_rounds``): in each, every live slot runs one cycle and a
    frozen slot nothing. The
    B slots share one cycle scratch: their cycles run one after another on
    one stream.
  * **Admission is a copy, never an allocation.** ``make_slot`` copies a
    host frontier into the slot's existing tensors (``load_state``), so the
    graph that baked in their addresses stays valid: a splice builds no
    graph (the counterpart of the JAX contract
    ``batch-splice-no-recompile``). An empty slot holds size 0.

The dispatch's read is one non-blocking copy of the B rows into a pinned
buffer. Phase profiling (``TTS_PHASEPROF``) is a solo diagnostic and is
refused, as in JAX; the counter block (``TTS_OBS=1``) is kept a slot, in
each slot's row. B = 1 is the solo path: the serve scheduler never builds a
batched program for one slot.
"""

from __future__ import annotations

import os
import time

import torch

from ..obs import counters as obs_counters
from ..obs import phases as obs_phases
from ..ops.backend import resolve_device
from ..ops.compact_policy import auto_chosen
from ..ops.cycle import (
    ST_CTR,
    ST_CYCLES,
    ST_LEN,
    ST_RUNS,
    new_state,
)
from ..ops.dispatch import BatchGraph
from ..pool.pool import SoAPool
from ..problems.base import INF_BOUND, Problem, index_batch
from . import resident as R
from .device import drain, warmup
from .pipeline import resolve_k
from .results import SearchResult


class BatchedProgram(R.CachedProgram):
    """B slots of one resident program (`batched.py` ``_BatchedProgram``).

    ``inner`` is an uncached resident program of the same configuration:
    its cycle, scratch, field layout and residual download serve every
    slot. B is fixed at construction; the occupancy varies at run time,
    never the tensors."""

    cache_attr = "_batched_programs"

    def __init__(self, problem: Problem, B: int, m: int, M: int, K: int,
                 capacity: int, device, fused: bool = True,
                 staged: bool = True, mt: int | None = None):
        if B < 1:
            raise ValueError(f"batch slots must be >= 1, got {B}")
        if obs_phases.phase_profiling_enabled():
            # The phase clock is one block a program, with no slot to
            # charge: refusing beats misattributing.
            raise RuntimeError(
                "TTS_PHASEPROF is not supported in batched builds; "
                "profile with a solo run instead")
        self.problem = problem
        self.B = int(B)
        self.inner = R.new_program(problem, m, M, K, capacity, device,
                                   fused=fused, staged=staged, mt=mt)
        inner = self.inner
        self.m = m
        self.M = inner.M
        self.K = inner.K
        self.capacity = capacity
        self.device = inner.device
        self.obs = inner.obs
        self.graphed = inner.graphed
        width = problem.child_slots  # PFSP jobs, N-Queens N
        self.st = torch.zeros((self.B, ST_LEN), dtype=torch.int32,
                              device=self.device)
        self.states = [R.ResidentState(
            torch.zeros((capacity, width), dtype=inner.vals_dtype,
                        device=self.device),
            torch.zeros(capacity, dtype=inner.aux_dtype, device=self.device),
            self.st[i]) for i in range(self.B)]
        self._graphs: dict[tuple, BatchGraph] = {}
        self.graph_build_s = 0.0
        self.dispatch_device_s = 0.0 if self.graphed else None
        if self.graphed:
            self._buf = torch.empty((self.B, ST_LEN), dtype=torch.int32,
                                    pin_memory=True)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event())

    # -- slots (copies into the existing tensors only) -----------------------

    def make_slot(self, i: int, frontier: dict | None, best: int) -> None:
        """Load slot ``i`` with a host frontier and incumbent (``None``:
        an empty slot, size 0): a copy into its tensors, never an
        allocation, so the batch's graph stays valid."""
        if frontier is None:
            self.st[i].copy_(new_state(0, best, self.device))
        else:
            self.inner.load_state(self.states[i], frontier, best)

    def empty_slot(self, i: int) -> None:
        """Freeze slot ``i``: size 0 fails its condition."""
        self.make_slot(i, None, 0)

    def residual_slot(self, i: int):
        """Download slot ``i``'s live frontier (the host drain's input, and
        a checkpoint cut's): ``(batch, size, best)``."""
        return self.inner.residual(self.states[i])

    # -- dispatch ------------------------------------------------------------

    def step(self) -> list[tuple]:
        """One K-cycle dispatch over all B slots (``enqueue`` and its
        read); returns each slot's ``(tree_inc, sol_inc, cycles, size,
        best, ctr)`` (``ctr`` the counter block, or None when not
        armed)."""
        return self.enqueue()()

    def enqueue(self):
        """Start one dispatch and return a function ``read()`` that waits
        for it and returns ``step``'s rows. On the card the batch's graph
        is launched between two timing events and the B rows are copied
        without blocking into the pinned buffer behind a third (the part
        the steady-state guard wraps); ``read`` waits for that event, adds
        the device time and counts the slots' runs as their wrappers'
        launches. One buffer: read a dispatch before the next enqueue.
        Elsewhere the host rounds run here and ``read`` returns them."""
        if not self.graphed:
            rows = self._host_step()
            return lambda: self._slot_reads(rows)
        g = self.graph()
        start, end, done = self._events
        start.record()
        g.launch()
        end.record()
        self._buf.copy_(self.st, non_blocking=True)
        done.record()

        def read() -> list[tuple]:
            done.synchronize()
            self.dispatch_device_s += start.elapsed_time(end) / 1e3
            rows = self._buf.tolist()
            g.count([v[ST_RUNS] for v in rows])
            return self._slot_reads(rows)
        return read

    def _slot_reads(self, rows: list) -> list[tuple]:
        out = []
        for v in rows:
            size, best, tree, sol, cycles = v[:ST_CYCLES + 1]
            ctr = v[ST_CTR:ST_CTR + obs_counters.NSLOTS] if self.obs else None
            out.append((tree, sol, cycles, size, best, ctr))
        return out

    def graph(self) -> BatchGraph:
        """The batch's dispatch graph at the current K, over the slots'
        tensors, built at first use."""
        key = (self.K, self.st.data_ptr(),
               *(s.pool_vals.data_ptr() for s in self.states),
               *(s.pool_aux.data_ptr() for s in self.states))
        g = self._graphs.get(key)
        if g is None:
            n = self.problem.child_slots
            inner = self.inner
            g = BatchGraph([inner.slot_cycle(s) for s in self.states],
                           self.st, self.m, self.M * n, self.capacity, self.K,
                           obs=n if self.obs else 0, fold=inner.fused)
            self.graph_build_s += g.build_s
            self._graphs[key] = g
        return g

    def _host_step(self) -> list:
        """Up to K rounds on the host: in each, every live slot runs one
        cycle (the plain or unfused one) and a frozen slot runs nothing."""
        self.inner.host_rounds(self.states, self.st, True)
        return self.st.tolist()

    def _free(self) -> None:
        """The graphs, the inner program and the slots' tensors."""
        for g in self._graphs.values():
            g.close()
        self._graphs.clear()
        self.inner.close()
        self.states = []


def make_batched_program(problem: Problem, B: int, m: int, M: int, K: int,
                         capacity: int, device=None, fused: bool = True,
                         staged: bool = True,
                         mt: int | None = None) -> BatchedProgram:
    """The B-slot program of ``problem``, held by the caller until
    ``release()``: cached on ``problem._batched_programs`` under B and the
    resident program's key, as ``make_program`` caches the solo one (an
    uncached one when another session holds it)."""
    return R.take_cached(
        problem, "_batched_programs",
        (B,) + R.program_key(m, M, K, capacity, device, fused, staged, mt,
                             compact=R.program_compact(problem, M, fused)),
        lambda: BatchedProgram(problem, B, m, M, K, capacity, device,
                               fused=fused, staged=staged, mt=mt))


def batched_search(
    problem: Problem,
    n_jobs: int,
    B: int,
    m: int = 25,
    M: int = 65536,
    K: int | str = 4096,
    capacity: int | None = None,
    device=None,
    initial_best: int | None = None,
    fused: bool = True,
    staged: bool = True,
    mt: int | None = None,
) -> list[SearchResult]:
    """Run ``n_jobs`` identical searches through a B-slot batched program
    (`batched.py:246-370`): fill the slots, dispatch until a slot's pool
    falls below m, retire it (its residual to the host drain, the solo
    phase 3) and refill it from the pending jobs. Every job's counts equal
    a solo ``resident_search`` of the same spec.

    A slot that stalls (zero cycles: its frontier outgrew the fan-out
    headroom) is cut to a checkpoint and finished by a solo
    ``resident_search(resume_from=...)``, whose pool can grow. ``device``
    defaults to ``cuda``; pass ``"cpu"`` for the plain path."""
    if n_jobs <= 0:
        return []
    dev = resolve_device(device)
    capacity, M = R.resolve_capacity(problem, M, capacity)
    _auto, k_value = resolve_k(K, default_max=4096)
    prog = make_batched_program(problem, B, m, M, k_value, capacity, dev,
                                fused=fused, staged=staged, mt=mt)
    best0 = (int(initial_best) if initial_best is not None
             else getattr(problem, "initial_ub", INF_BOUND))
    results: list[SearchResult | None] = [None] * n_jobs
    pending = list(range(n_jobs))
    slots: list[dict | None] = [None] * B

    def admit(i: int, j: int) -> None:
        pool = SoAPool(problem.node_fields())
        pool.push_back(index_batch(problem.root(), 0))
        tree1, sol1, best = warmup(problem, pool, best0, m)
        prog.make_slot(i, pool.as_batch(), best)
        slots[i] = {"job": j, "tree": tree1, "sol": sol1,
                    "t0": time.perf_counter()}

    def finish_solo(i: int, sl: dict) -> None:
        # Stall: checkpoint the slot and let the solo engine (which may
        # grow its pool on resume) finish the job.
        import tempfile

        from . import checkpoint as ckpt

        batch, _size, best = prog.residual_slot(i)
        fd, path = tempfile.mkstemp(suffix=".ckpt.npz")
        os.close(fd)
        try:
            ckpt.save(path, problem, batch, best, sl["tree"], sl["sol"])
            results[sl["job"]] = R.resident_search(
                problem, m=m, M=M, K=k_value, capacity=None, device=dev,
                fused=fused, staged=staged, mt=mt, resume_from=path)
        finally:
            if os.path.exists(path):
                os.remove(path)

    try:
        for i in range(B):
            if pending:
                admit(i, pending.pop(0))
            else:
                prog.empty_slot(i)
        while any(sl is not None for sl in slots):
            reads = prog.step()
            for i in range(B):
                sl = slots[i]
                if sl is None:
                    continue
                tree_inc, sol_inc, cycles, size, best, ctr = reads[i]
                sl["tree"] += tree_inc
                sl["sol"] += sol_inc
                if ctr is not None:
                    sl["ctr"] = obs_counters.merge_host(sl.get("ctr"), ctr)
                if size < m:
                    batch, rsize, best = prog.residual_slot(i)
                    pool = SoAPool(problem.node_fields())
                    if rsize:
                        pool.reset_from(batch)
                    tree3, sol3, best = drain(problem, pool, best)
                    results[sl["job"]] = SearchResult(
                        explored_tree=sl["tree"] + tree3,
                        explored_sol=sl["sol"] + sol3,
                        best=best,
                        elapsed=time.perf_counter() - sl["t0"],
                        complete=True,
                        engine="batched",
                        compact=prog.inner.compact,
                        compact_auto=auto_chosen(prog.inner.compact),
                        fused=prog.inner.fused,
                        staged=prog.inner.staged,
                        megakernel_mt=prog.inner.mt,
                        M=prog.M,
                        k_resolved=prog.K,
                        obs=({"device_counters": sl["ctr"]}
                             if sl.get("ctr") is not None else None),
                    )
                    slots[i] = None
                    if pending:
                        admit(i, pending.pop(0))
                    # else: the retired slot stays frozen (size < m).
                elif cycles == 0:
                    finish_solo(i, sl)
                    slots[i] = None
                    if pending:
                        admit(i, pending.pop(0))
                    else:
                        prog.empty_slot(i)
    finally:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        prog.release()
    return [r for r in results if r is not None]


# -- program contracts (`check`, analysis/contracts.py) ------------------------

from ..analysis.contracts import contract  # noqa: E402


@contract(
    "batch-b1-identity",
    claim="a B=1 batch runs the solo cycle's entries in the same order "
          "(the slot axis adds only the graph's own batch_init, slot_gate "
          "and batch_cond nodes), and a B=2 batch runs them once a slot, in "
          "slot order — --batch-slots 1 is the solo path with no drift",
    artifact="batched",
)
def _contract_b1_identity(art, cell):
    solo = [e.text for e in art["solo"].cycle_entries()]
    got = [e.text for e in art["record"].cycle_entries()]
    if got == solo * art["B"]:
        return []
    return [f"B={art['B']} batch records {len(got)} cycle entries, the solo "
            f"cycle {len(solo)} a slot (or in another order)"]


@contract(
    "batch-splice-no-recompile",
    claim="admitting a slot is a copy into the slot's existing tensors, "
          "never a new program: make_slot and empty_slot on a built batch "
          "build no graph, library or program (ops/_build.py build_counts) "
          "and move no tensor the batch's graph bakes in",
    artifact="batched",
)
def _contract_splice_no_recompile(art, cell):
    (b0, st0, p0), (b1, st1, p1) = art["before"], art["after"]
    out = []
    if b0 != b1:
        out.append(f"slot admission built something: {b0} -> {b1}")
    if st0 != st1 or p0 != p1:
        out.append("slot admission moved the batch's tensors")
    return out
