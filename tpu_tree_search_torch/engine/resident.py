"""Device-resident search engine — the port of `tpu_tree_search/engine/resident.py`
for PFSP (lb1, lb1_d, lb2) and N-Queens.

The pool lives in device memory as fixed-capacity SoA tensors — the rows
(PFSP ``prmu``, N-Queens ``board``) and one scalar column (PFSP ``limit1``,
N-Queens ``depth``) — and one dispatch advances the search by up to K chunk
cycles; the host reads back a few scalars per dispatch. Semantics per cycle
are exactly the reference's chunk cycle:

  * pop the back ``cnt = min(size, M)`` nodes, only while ``size >= m``;
  * evaluate all ``cnt * width`` children in one batch;
  * PFSP: a child with depth == jobs is a leaf -> exploredSol++, folds the
    incumbent with a min; a non-leaf child is pushed iff ``bound < best``
    strictly, counting exploredTree (`pfsp_chpl.chpl:100-111`);
  * N-Queens: a popped node at depth == N is a solution; every safe slot
    k >= depth of a node below N is pushed (`nqueens_chpl.chpl:70-89`);
  * survivors are pushed in (parent, slot) order.

Two cycles compute this and leave identical live pools:

  * fused (the default): the CUDA cycle of `ops/cycle.py` (PFSP lb1 and
    lb2) or `ops/cycle_nqueens.py` — the counterpart of the JAX engine's
    one-kernel cycle. The loop condition is evaluated on the device: one
    dispatch is one CUDA graph whose ``while`` node runs the cycle until
    the condition is false (`ops/dispatch.py`, the ``lax.while_loop``
    counterpart), so no cycle is launched past termination and the host
    reads the state once a dispatch. With a tile width ``mt`` below M (the
    JAX ``TTS_MEGAKERNEL_MT``) the fused cycle is the streamed one of
    `ops/tiled.py`: the chunk in M // mt tiles, the survivors placed by a
    carry across tiles, the same pool after the cycle. PFSP lb1_d has no
    fused cycle — the JAX megakernel refuses it too — and always runs
    unfused;
  * unfused (``fused=False``): pop, the problem's device evaluator (the
    lb1, lb1_d, lb2 or labels kernel), torch `compact_ids` and the
    one-gather push of `resident.py:311-352`, with the overflow branch.
    Its shapes are fixed and its scalars stay on the device, so on the
    card its K cycles are one graph too (the while body: the kernel, the
    torch compaction and push). Under lb2 the
    evaluator is staged by default (``staged=True``, `resident.py:598-614`):
    the lb1 kernel, the leaf fold, the candidates ``open & ~leaf & lb1 <
    best``, lb2 of the compacted candidates only (the self kernel), and
    ``keep = cand & lb2 < best`` — exact, since lb2 >= lb1. With
    ``staged=False`` it is the single-pass lb2 child kernel.

Capacity safety: a cycle runs only while ``size + M*width <= capacity``. If
the pool outgrows that headroom the dispatch stalls (zero cycles) and the
host runs offload cycles (host pop, the device evaluator, host branch) until
the frontier fits again — correctness never depends on the capacity
heuristic.

Dispatch is pipelined (`engine/pipeline.py`, ``TTS_PIPELINE``): up to
``depth`` dispatches are in flight while the host reads the lagged scalars
of the oldest, each copied into its queue slot's own pinned host buffer
behind a CUDA event. It is exact, because a dispatch on a terminated or
stalled pool runs zero cycles. ``K="auto"`` (or ``TTS_K=auto``) moves K
along the geometric ladder of ``AdaptiveK``, one graph a rung.

Checkpoints (`engine/checkpoint.py`, absent from the reference): with
``checkpoint_path`` the live frontier and counters are saved every
``checkpoint_interval_s`` and at a ``max_steps`` (or ``yield_fn``) cut,
which drains the in-flight dispatches, saves and returns ``complete=False``
without phase 3; ``resume_from`` replaces phase 1 by the saved frontier and
keeps counting. The file format is the JAX package's, so a cut taken by
either package resumes in the other.

Telemetry (`obs/`, the JAX engine's): with ``TTS_OBS=1`` the counter block
(`obs/counters.py`) is folded after every cycle on the device — on the
graph by its last body node, ``dispatch_cond_obs`` — and read with the
dispatch's scalars; with ``TTS_PHASEPROF=1`` (which arms the counters too)
the phase clock (`obs/phases.py`) is marked between the cycle's launches
on ``%globaltimer``. Each armed combination builds its own graphs (keyed
on the two flags); off, the graphs are the untelemetered ones. The host
side emits the JAX engine's events: ``dispatch`` spans, per-phase
``explored`` samples (phase 2's from the counter block when it ran),
``incumbent``, ``pipeline``, ``roofline_meta``, ``k_resize``,
``overflow_fallback``, ``checkpoint``, and feeds the flight recorder and
the quality tracker at every consumed dispatch.

Programs are cached on the problem (``problem._resident_programs``, keyed
as the JAX engine keys its compiled programs, `resident.py:682-702`): each
owns one ``ResidentState`` of its capacity, into which a search copies its
frontier (``load_state``), so the dispatch graphs that bake in the state's
addresses are built once a program and K rung, not once a search. A search
takes the cached program for its whole length; a second search that finds
it taken builds a program of its own, uncached, freed when it ends.
``release_programs(problem)`` frees the cached ones.

The steady-state guard (``guard=True`` or ``TTS_GUARD=1``, `analysis/
guard.py`, the JAX engine's): one guard a program and K rung wraps each
dispatch's enqueue (the graph launch and the non-blocking copies, not the
read): the rung's first dispatch is its warm one, and every later one must
build nothing and, on the card, make no synchronising call. The stall
fallback's re-upload re-arms it. Both cycles' dispatches are one graph
launch on the card, so a guarded search of either runs through. The
result's ``guard`` records the dispatches it checked.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..analysis.guard import RungGuards
from ..obs import counters as obs_counters
from ..obs import events as ev
from ..obs import flightrec as fr
from ..obs import phases as obs_phases
from ..obs import quality as obs_quality
from ..obs import roofline as obs_roofline
from ..ops._build import count_build
from ..ops.backend import resolve_device
from ..ops.compact_policy import auto_chosen, resolve_compact_mode
from ..ops.compaction import children_of, compact_ids
from ..ops.cycle import (
    ST_ACTIVE,
    ST_BEST,
    ST_CTR,
    ST_CTR_SOL,
    ST_CYCLES,
    ST_RUNS,
    ST_SIZE,
    ST_TREE,
    cycle_lb1,
    cycle_lb2,
    cycle_scratch,
    new_state,
)
from ..ops.cycle_nqueens import cycle_nqueens, nqueens_scratch
from ..ops.pfsp_device import lb1_bounds, lb2_bounds_mp, lb2_bounds_staged
from ..ops.tiled import (
    check_tile,
    tiled_lb1,
    tiled_lb1_scratch,
    tiled_lb2,
    tiled_lb2_scratch,
    tiled_nqueens,
    tiled_nqueens_scratch,
)
from ..pool.pool import SoAPool
from ..problems.base import INF_BOUND, Problem, index_batch
from ..problems.nqueens import NQueensProblem
from ..problems.pfsp.problem import PFSPProblem
from ..ops.dispatch import (
    DispatchGraph,
    batch_cond_plain,
    batch_init_plain,
    cycle_cond_plain,
    dispatch_cond_obs_plain,
    loop_active,
    new_clock,
    phase_mark,
    phase_mark_if,
)
from . import checkpoint as ckpt
from .device import DeviceOffloader, drain, pool_dtype, pool_dtypes, warmup
from .pipeline import (
    RESIDENT_TARGET,
    AdaptiveK,
    DispatchQueue,
    resolve_k,
    resolve_pipeline_depth,
    resolve_target_band,
)
from .results import Diagnostics, PhaseStats, SearchResult


@dataclass
class ResidentState:
    """The device state of one search: the pool and the scalar block
    (`ops/cycle.py` layout: size, best, tree, sol, cycles, ...)."""

    pool_vals: torch.Tensor  # (C, width)
    pool_aux: torch.Tensor  # (C,) PFSP limit1 / N-Queens depth
    st: torch.Tensor  # (ST_LEN,) int32


class DispatchRead(NamedTuple):
    """One dispatch's read: the scalars, the counter block and the phase
    block (lists of ints, or None when not armed) and the dispatch's
    device ms (CUDA events around the graph launch; None off the graph)."""

    tree: int
    sol: int
    cycles: int
    size: int
    best: int
    ctr: list | None
    ph: list | None
    device_ms: float | None


def pool_from_numpy(vals, aux, size: int, best: int, capacity: int,
                    device=None, vals_dtype: torch.dtype | None = None,
                    aux_dtype: torch.dtype | None = None) -> ResidentState:
    """A resident state holding ``vals[:size]`` (the rows) and
    ``aux[:size]`` (the scalar column) at the front of a zeroed pool of
    ``capacity`` rows, with incumbent ``best`` and zeroed counters. The
    storage types default to the PFSP pool's (``pool_dtype``)."""
    dev = resolve_device(device)
    vals = np.asarray(vals)
    n = vals.shape[1]
    if size > capacity:
        raise ValueError(f"frontier of {size} nodes exceeds capacity {capacity}")
    vals_dtype = vals_dtype or pool_dtype(n)
    aux_dtype = aux_dtype or pool_dtype(n)
    pool_vals = torch.zeros((capacity, n), dtype=vals_dtype, device=dev)
    pool_aux = torch.zeros(capacity, dtype=aux_dtype, device=dev)
    if size:
        pool_vals[:size] = torch.from_numpy(
            np.ascontiguousarray(vals[:size], dtype=np.int32)).to(dev).to(vals_dtype)
        pool_aux[:size] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(aux)[:size], dtype=np.int32)
        ).to(dev).to(aux_dtype)
    return ResidentState(pool_vals, pool_aux, new_state(size, best, dev))


#: The JAX mesh tier's refusal of the mp axis off lb2
#: (`tpu_tree_search/parallel/resident_mesh.py:96-100`).
MP_LB2_ONLY = ("mp-axis sharding splits the lb2 Johnson pair loop; use a "
               "single-axis mesh for other problems/bounds")


#: Guards the program caches on problems and the programs' ``busy`` flags
#: (two serve workers may start searches of one problem at once).
_CACHE_LOCK = threading.Lock()


class CachedProgram:
    """A program cached on its problem (``take_cached``): the attribute of
    the problem's cache, the key it is cached under (None: uncached) and
    whether a search holds it. ``close`` frees a program; subclasses free
    their graphs and tensors in ``_free``."""

    cache_attr = "_resident_programs"
    cache_key: tuple | None = None
    busy = False

    def release(self) -> None:
        """End a search's hold (after its work has finished): a cached
        program goes back to its cache, an uncached one is closed."""
        with _CACHE_LOCK:
            self.busy = False
            cached = self.cache_key is not None
        if not cached:
            self.close()

    def close(self) -> None:
        """Free the program (after its work has finished) and take it out
        of its problem's cache."""
        with _CACHE_LOCK:
            cache = getattr(self.problem, self.cache_attr, None)
            if cache is not None and cache.get(self.cache_key) is self:
                del cache[self.cache_key]
            self.cache_key = None
        self._free()

    def _free(self) -> None:
        raise NotImplementedError


def take_cached(problem: Problem, attr: str, key: tuple, build):
    """The program cached on ``problem.<attr>`` under ``key`` when no search
    holds it; else ``build()``, cached when the key has none yet and
    uncached (closed at ``release``) when another search holds the cached
    one. The caller holds it until ``release()``: two searches never share
    a program or a state."""
    with _CACHE_LOCK:
        cache = problem.__dict__.setdefault(attr, {})
        prog = cache.get(key)
        if prog is not None and not prog.busy:
            prog.busy = True
            return prog
    prog = build()
    with _CACHE_LOCK:
        prog.busy = True
        if key not in cache:
            prog.cache_key = key
            cache[key] = prog
    return prog


class _ResidentProgram(CachedProgram):
    """The resident program for one (problem, m, M, K, capacity, device).

    Pool layout (both problems): ``vals`` (C, width) rows of
    ``vals_dtype`` plus one scalar ``aux`` column (C,) of ``aux_dtype``.
    Subclasses provide the storage types, the evaluator, the swap position
    and the fused cycle. The telemetry flags are read when the program is
    made: ``obs`` (the counter block, `obs/counters.py`) and ``phaseprof``
    (the phase clock ``clk``, `obs/phases.py`).
    """

    survivor_budget_div: int
    vals_dtype: torch.dtype
    aux_dtype: torch.dtype
    # Whether the unfused cycle runs a staged evaluator (PFSP lb2 only).
    staged = False
    #: The K cap a search sets for its length (``--profile``'s window).
    k_cap: int | None = None
    # The lb2 pair blocks an evaluation splits into (PFSP lb2 only).
    mp = 1
    # Why a program asked for the fused cycle runs the unfused one (None:
    # it was not asked, or it runs it).
    unfused_reason: str | None = None

    def __init__(self, problem: Problem, m: int, M: int, K: int,
                 capacity: int, device, fused: bool = True,
                 mt: int | None = None):
        n = problem.child_slots
        self.problem = problem
        self.m = m
        self.M = M
        self.capacity = capacity
        self.device = resolve_device(device)
        self.fused = fused
        # The fused cycle's tile width: mt < M streams the chunk in M // mt
        # tiles (`ops/tiled.py`), None or M keeps the single-tile cycle. Inert
        # on the unfused cycle, as TTS_MEGAKERNEL_MT is with the kernel off.
        if fused and mt is not None:
            check_tile(M, mt)
        self.mt = (mt or M) if fused else None
        self.tiled = fused and self.mt < M
        self.use_k(K)
        self.S = min(max(64 * n, M * n // self.survivor_budget_div), M * n)
        self.compact = None if fused else resolve_compact_mode(problem, M, n)
        cuda = self.device.type == "cuda"
        self._scratch = self._make_scratch() if fused and cuda else None
        # On the card both cycles dispatch through CUDA graphs, one a K
        # rung, keyed on the state tensors' addresses that they bake in.
        self.graphed = cuda
        self._graphs: dict[tuple, DispatchGraph] = {}
        self.graph_build_s = 0.0
        # The graph dispatches' device time: CUDA events around each graph
        # launch, summed when the dispatch is read (None off the graph).
        self.dispatch_device_s = 0.0 if self.graphed else None
        # Pinned host buffers and events (start, end of the graph, the copy
        # done) of the in-flight dispatches' scalars (``host_slots``).
        self._slots: list[tuple] = []
        self._next_slot = 0
        # Telemetry, baked into the graphs (keys of their cache).
        self.obs = obs_counters.device_counters_enabled()
        self.phaseprof = obs_phases.phase_profiling_enabled()
        self.clk = new_clock(self.device) if self.phaseprof else None
        # The state words a dispatch's read copies: through the body's runs,
        # or through the counter block.
        self._nread = ST_CTR_SOL + 1 if self.obs else ST_RUNS + 1
        # The state the program owns, which every search of it reuses
        # (``own_state``).
        self.state: ResidentState | None = None

    def use_k(self, K: int) -> None:
        """Cycles a dispatch: K, clamped so that one dispatch accumulates at
        most 2**31 - 1 (K*M*n) into the int32 tree and sol counters, and to
        ``k_cap`` when a search sets one (``--profile``'s window)."""
        n = self.problem.child_slots
        cap = self.k_cap or K
        self.K = max(1, min(K, cap, (2**31 - 1) // max(1, self.M * n)))

    def body_launches(self, state: ResidentState) -> int:
        """The launches one run of a dispatch's body makes: on the card the
        nodes of the body graph at the current K; on the CPU the entries of
        one plain cycle recorded as `check` records it (its kernel routes
        and torch operations, on a copy of ``state``) and the condition's
        node where the cycle does not set the condition itself."""
        if self.graphed:
            return len(self._graph(state).nodes())
        from ..analysis.contracts import Recorder

        copy = ResidentState(state.pool_vals.clone(), state.pool_aux.clone(),
                             state.st.clone())
        rec = Recorder()
        with rec:
            self.slot_cycle(copy)()
        return len(rec.entries) + (0 if self.fused and not self.obs else 1)

    def init_state(self, frontier: dict, best: int) -> ResidentState:
        p = self.problem
        k = frontier[p.vals_field].shape[0]
        return pool_from_numpy(frontier[p.vals_field], frontier[p.aux_field],
                               k, best, self.capacity, self.device,
                               self.vals_dtype, self.aux_dtype)

    def own_state(self, frontier: dict, best: int) -> ResidentState:
        """The program's own state, holding ``frontier`` and ``best``:
        allocated at the first search, copied into at every later one (the
        graphs built on it stay valid)."""
        if self.state is None:
            self.state = self.init_state(frontier, best)
        else:
            self.load_state(self.state, frontier, best)
        return self.state

    def load_state(self, state: ResidentState, frontier: dict,
                   best: int) -> None:
        """Copy ``frontier`` and ``best`` into ``state``'s existing tensors
        (the stall fallback's re-upload): the graphs keep the addresses
        they were built on."""
        p = self.problem
        k = frontier[p.vals_field].shape[0]
        if k > self.capacity:
            raise ValueError(f"frontier of {k} nodes exceeds capacity "
                             f"{self.capacity}")
        for dst, field in ((state.pool_vals, p.vals_field),
                           (state.pool_aux, p.aux_field)):
            src = np.ascontiguousarray(frontier[field], dtype=np.int32)
            dst[:k].copy_(torch.from_numpy(src).to(dst.dtype))
        state.st.copy_(new_state(k, best, self.device))

    def host_slots(self, depth: int) -> None:
        """One pinned scalar buffer and its events for each of ``depth``
        dispatches in flight (the graph dispatch's lagged reads); kept
        across the searches of a cached program while the depth holds."""
        if self.graphed and len(self._slots) != max(1, depth):
            self._slots = [
                (torch.empty(self._nread, dtype=torch.int32, pin_memory=True),
                 torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True), torch.cuda.Event(),
                 None if self.clk is None else torch.empty(
                     self.clk.numel(), dtype=torch.int64, pin_memory=True))
                for _ in range(max(1, depth))]
            self._next_slot = 0

    def step(self, state: ResidentState) -> None:
        """One dispatch: up to K cycles, in place on ``state``. On the card
        a dispatch is one graph launch; on the CPU the plain cycles run
        until the loop condition is false."""
        if self.graphed:
            self._graph(state).launch()
            return
        # The graph's init node: tree, sol, cycles and the body's runs.
        state.st[ST_TREE:ST_CYCLES + 1] = 0
        state.st[ST_RUNS] = 0
        if self.obs:
            state.st[ST_CTR:ST_CTR_SOL + 1] = 0
        if self.clk is not None:
            phase_mark(self.clk, 0, obs_phases.SEED)
        n = self.problem.child_slots
        cond = (self.m, self.M * n, self.capacity, self.K)
        # The while node: a cycle, then what the body's end does to the
        # state and the condition (the counter node's fold after a fused
        # cycle under TTS_OBS=1, else the run counted).
        live = loop_active(state.st.tolist(), *cond)
        while live:
            if self.fused:
                self._fused_cycle(state)
            else:
                self._unfused_cycle(state)
            if self.fused and self.obs:
                live = dispatch_cond_obs_plain(state.st, n, *cond)
            else:
                live = cycle_cond_plain(state.st, *cond)

    def enqueue(self, state: ResidentState):
        """``step``, and a function ``read(full=False)`` that returns its
        scalars ``(tree, sol, cycles, size, best)``, or with ``full`` a
        ``DispatchRead`` (the scalars, the counter block, the phase block,
        the dispatch's device ms). On the card the graph
        launch sits between two timing events, the state (and the clock)
        are copied without blocking into the next pinned slot behind a
        third, and the function waits for that event, adds the dispatch's
        device time and counts the body's runs as the cycle's launches
        (``DispatchGraph.count``); elsewhere the step has run on the host's
        clock and the function returns what it read."""
        if not self.graphed:
            self.step(state)
            scalars = self.read_scalars(state)
            blocks = self.read_blocks(state)

            def read_host(full: bool = False):
                return DispatchRead(*scalars, *blocks, None) if full else scalars
            return read_host
        buf, start, end, done, clkbuf = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        g = self._graph(state)
        start.record()
        g.launch()
        end.record()
        buf.copy_(state.st[:self._nread], non_blocking=True)
        if clkbuf is not None:
            clkbuf.copy_(self.clk, non_blocking=True)
        done.record()

        def read(full: bool = False):
            done.synchronize()
            ms = start.elapsed_time(end)
            self.dispatch_device_s += ms / 1e3
            v = buf.tolist()
            size, best, tree, sol, cycles = v[:ST_CYCLES + 1]
            g.count(v[ST_RUNS])
            if not full:
                return tree, sol, cycles, size, best
            ctr = v[ST_CTR:ST_CTR + obs_counters.NSLOTS] if self.obs else None
            ph = clkbuf.tolist() if clkbuf is not None else None
            return DispatchRead(tree, sol, cycles, size, best, ctr, ph, ms)
        return read

    def read_scalars(self, state: ResidentState):
        """The dispatch's one readback: ``(tree, sol, cycles, size, best)``."""
        size, best, tree, sol, cycles = state.st[:ST_CYCLES + 1].tolist()
        return tree, sol, cycles, size, best

    def read_blocks(self, state: ResidentState):
        """The dispatch's telemetry: ``(counter block, phase block)``, each
        a list of ints, or None when not armed."""
        ctr = (state.st[ST_CTR:ST_CTR + obs_counters.NSLOTS].tolist()
               if self.obs else None)
        ph = self.clk.tolist() if self.clk is not None else None
        return ctr, ph

    def _graph(self, state: ResidentState) -> DispatchGraph:
        """The dispatch graph of the current K over ``state``'s tensors and
        the telemetry flags, built at first use."""
        key = (self.K, state.st.data_ptr(), state.pool_vals.data_ptr(),
               state.pool_aux.data_ptr(), self.obs, self.phaseprof)
        g = self._graphs.get(key)
        if g is None:
            n = self.problem.child_slots
            cycle = self._fused_cycle if self.fused else self._unfused_cycle
            g = DispatchGraph(lambda: cycle(state), state.st, self.m,
                              self.M * n, self.capacity, self.K,
                              obs=n if self.obs else 0, clk=self.clk,
                              fold=self.fused)
            self.graph_build_s += g.build_s
            self._graphs[key] = g
        return g

    def _free(self) -> None:
        """The dispatch graphs and the state."""
        for g in self._graphs.values():
            g.close()
        self._graphs.clear()
        self.state = None

    def residual(self, state: ResidentState) -> tuple[dict, int, int]:
        """Downloads the live pool -> (host NodeBatch, size, best). The
        reads are ordered on the current stream after every dispatch
        enqueued there, graph launches included, so they see the state
        those dispatches leave (the checkpoint snapshot and the stall
        fallback read it after draining the queue)."""
        size = int(state.st[ST_SIZE])
        best = int(state.st[ST_BEST])
        p = self.problem
        fields = p.node_fields()
        batch = {
            p.vals_field: state.pool_vals[:size].cpu().numpy().astype(
                fields[p.vals_field][1]),
            p.aux_field: state.pool_aux[:size].cpu().numpy().astype(
                fields[p.aux_field][1]),
        }
        return self.derive_fields(batch), size, best

    def derive_fields(self, batch: dict) -> dict:
        """The node fields the pool does not store, derived from those it
        does (none by default)."""
        return batch

    # -- per problem ---------------------------------------------------------

    def _make_scratch(self):
        raise NotImplementedError

    # tts-lint: traced (the cycle a dispatch, batch or mesh graph captures, picked at run time)
    def _fused_cycle(self, state: ResidentState) -> None:
        raise NotImplementedError

    def _swap_pos(self, aux: torch.Tensor) -> torch.Tensor:
        """The branching swap position of each parent, from its aux."""
        raise NotImplementedError

    def _evaluate(self, vals_c, aux_c, valid, best: torch.Tensor):
        """``(keep (M, width) bool, sol_inc, best)`` of a popped chunk
        (0-d tensors; ``best`` a 0-d int32 tensor on the chunk's device):
        the `_make_eval` fold of the JAX programs."""
        raise NotImplementedError

    # -- the unfused cycle ---------------------------------------------------

    # tts-lint: traced (its lambda is the cycle a batch or mesh graph captures for a slot)
    def slot_cycle(self, state: ResidentState):
        """The cycle a batch or mesh graph captures for one slot's state: a
        callable of no arguments. Where the slot's condition fails, a fused
        cycle runs an exact no-op that clears ``st[ST_ACTIVE]``; an unfused
        one sits under the slot's ``if`` node and runs nothing."""
        cycle = self._fused_cycle if self.fused else self._unfused_cycle
        return lambda: cycle(state)

    def host_rounds(self, states: list, st: torch.Tensor,
                    zero_block: bool, cycles: list | None = None) -> None:
        """Up to K rounds of the batch of ``states`` (rows of ``st``) on the
        host, the plain counterpart of a batch or mesh graph's ``while``
        node: ``batch_init`` (``zero_block``: the counter block zeroed
        too), then each round every live slot's cycle and ``batch_cond``
        (the fused cycle's counter fold: the unfused cycle folds its own).
        A frozen slot runs nothing. ``cycles`` (one a state, default this
        program's ``slot_cycle``) runs each slot's own program's cycle:
        the mesh's copies each have one."""
        n = self.problem.child_slots
        Mn = self.M * n
        if cycles is None:
            cycles = [self.slot_cycle(s) for s in states]
        live = batch_init_plain(st, self.m, Mn, self.capacity, self.K,
                                self.obs and zero_block)
        for _ in range(self.K):
            if not live:
                break
            for s, cycle in zip(states, cycles):
                if self.fused or loop_active(s.st.tolist(), self.m, Mn,
                                             self.capacity, self.K):
                    cycle()
                else:
                    s.st[ST_ACTIVE] = 0
            live = batch_cond_plain(st, n if self.obs and self.fused else 0,
                                    self.m, Mn, self.capacity, self.K)

    # tts-lint: traced (the cycle a dispatch, batch or mesh graph captures, picked at run time)
    def _unfused_cycle(self, state: ResidentState) -> None:
        """One unfused cycle on ``state``, in place, of fixed shapes with
        its scalars on the device, so that it reads nothing back and a
        graph captures it (`ops/dispatch.py`). It runs only where the loop
        condition holds: the dispatch graph's ``while`` node, a batch or
        mesh slot's ``if`` node (``slot_gate``) and the host loops test it
        first.

        The pop gathers the window ``[start, start + M)``, ``start = size -
        cnt`` with ``cnt = min(size, M)`` (rows past ``size`` masked); the
        evaluator keeps the children; ``compact_ids`` ranks every survivor
        in (parent, slot) order; the push makes the child of each of the
        M*n ranked slots from its parent's row (``children_of``) and
        writes all M*n rows at ``[start, start + M*n)`` with one
        ``index_copy_``: the survivors land at ``[start, start +
        tree_inc)``, the rest past the new size, dead rows (the JAX fitting
        branch writes its S rows so too); the condition's ``size + M*n <=
        C`` keeps the window in the pool. The overflow branch of the JAX
        cycle (more than the budget S of survivors) places the same rows;
        it is chosen on the device and kept for the counter block and the
        phase clock. Armed, the cycle folds into the counter block
        (`obs_counters.update`: an overflow cycle counts one ``overflow``
        and M*n ``push_rows``, a fitting one S) and marks the phase clock
        after the pop, the evaluation, the compaction and the push or
        overflow (``phase_mark_if``)."""
        n, M, S = self.problem.child_slots, self.M, self.S
        Mn = M * n
        st, pool_vals, pool_aux = state.st, state.pool_vals, state.pool_aux
        i32 = torch.int32
        clk = self.clk
        P = obs_phases.IDX
        if clk is not None:
            phase_mark(clk, P["loop"], obs_phases.OPEN)
        size, best, tree, sol, cycles = st[:ST_CYCLES + 1].clone().unbind()
        cnt = torch.clamp(size, max=M)
        start = (size - cnt).long()
        ar = torch.arange(Mn, device=pool_vals.device)
        vals_c = pool_vals.index_select(0, start + ar[:M])
        aux_c = pool_aux.index_select(0, start + ar[:M]).to(i32)
        if clk is not None:
            phase_mark(clk, P["pop"])
        keep, sol_inc, best_t = self._evaluate(vals_c, aux_c, ar[:M] < cnt,
                                               best)
        if clk is not None:
            phase_mark(clk, P["eval"])
        ids, tree_inc = compact_ids(keep, Mn, self.compact)
        if clk is not None:
            phase_mark(clk, P["compact"])
        ids = ids.long()
        # Each parent's swap position, clamped only for a parent whose
        # children are all pruned (an N-Queens parent at depth N): the
        # garbage slots past tree_inc take its children.
        d = self._swap_pos(aux_c).long().clamp(0, n - 1)[:, None]
        pool_vals.index_copy_(0, start + ar, children_of(vals_c, d)[ids])
        pool_aux.index_copy_(0, start + ar,
                             (aux_c[ids // n] + 1).to(pool_aux.dtype))
        over = tree_inc > S
        if clk is not None:
            phase_mark_if(clk, P["push"], P["overflow"], over.to(i32),
                          obs_phases.CLOSE)
        new_size = start.to(i32) + tree_inc
        st[:ST_CYCLES + 1] = torch.stack([
            new_size, best_t.to(i32), tree + tree_inc, sol + sol_inc,
            cycles + 1])
        st[ST_ACTIVE:ST_ACTIVE + 1].fill_(1)
        if self.obs:
            zero = torch.zeros((), dtype=i32, device=st.device)
            ctr = st[ST_CTR:ST_CTR + obs_counters.NSLOTS]
            inc = torch.stack([cnt, tree_inc, sol_inc,
                               cnt * n - tree_inc - sol_inc, over.to(i32),
                               zero, zero,
                               torch.where(over, Mn, S).to(i32)])
            hwm = torch.stack([zero] * 5 + [new_size, tree_inc, zero])
            st[ST_CTR:ST_CTR + obs_counters.NSLOTS] = torch.maximum(
                ctr + inc, hwm)


class PFSPResident(_ResidentProgram):
    """PFSP: rows ``prmu`` and aux ``limit1``, both int8 through 127 jobs.

    ``staged`` (lb2, unfused cycle only; the counterpart of the JAX
    ``allow_staged``) picks the staged evaluator over the single-pass lb2
    kernel. The fused lb2 cycle always folds the unstaged keep, as the JAX
    megakernel does (`megakernel.py:1007-1012`). ``mp`` > 1 (lb2 only, the
    mesh tier's pair axis) splits the lb2 Johnson pair loop in mp pair
    blocks (`ops/pfsp_device.py` ``lb2_bounds_mp``, ``lb2_self_bounds_mp``)
    and runs the unfused cycle: the JAX megakernel refuses "mp pair-axis
    sharding (the fused cycle is single-shard)" (`megakernel.py:355-358`).
    A mesh copy (`parallel/resident_mesh.py`) bounds only its ``blocks``
    of the mp (indices, on its own device's tables) and joins its peers'
    planes through its ``exchange`` endpoint (`ops/pair_exchange.py`);
    None for both is every block on this device, no exchange."""

    # Deep PFSP chunks prune heavily; the unfused push's gather budget is
    # a quarter of the slot grid (the JAX engine's choice).
    survivor_budget_div = 4

    def __init__(self, problem: PFSPProblem, m: int, M: int, K: int,
                 capacity: int, device, fused: bool = True,
                 staged: bool = True, mt: int | None = None, mp: int = 1,
                 blocks=None, exchange=None):
        if mp > 1 and problem.lb != "lb2":
            raise ValueError(MP_LB2_ONLY)
        self.vals_dtype, self.aux_dtype = pool_dtypes(problem)
        self.mp = int(mp)
        self.blocks = None if blocks is None else tuple(blocks)
        self.exchange = exchange
        # lb1_d has no fused cycle (the JAX megakernel refuses it,
        # `megakernel.py:351-354`), nor has the mp pair axis (`:355-358`):
        # they run the unfused cycle with their kernels.
        super().__init__(problem, m, M, K, capacity, device,
                         fused=fused and problem.lb != "lb1_d" and mp == 1,
                         mt=mt)
        if fused and not self.fused:
            self.unfused_reason = (
                "lb1_d has no fused cycle (the JAX megakernel refuses it, "
                "megakernel.py:351-354)" if problem.lb == "lb1_d" else
                "mp pair-axis sharding (the fused cycle is single-shard, "
                "megakernel.py:355-358)")
        self.tables = problem.device_tables(self.device)
        self.staged = staged and problem.lb == "lb2" and not self.fused
        if self.mp > 1:
            self.tables.pair_blocks(self.mp)  # built before any capture

    def derive_fields(self, batch: dict) -> dict:
        # depth == limit1 + 1 for every node the engine pushes.
        batch["depth"] = (batch["limit1"].astype(np.int32) + 1).astype(
            self.problem.node_fields()["depth"][1])
        return batch

    def _make_scratch(self):
        if self.tiled:
            make = (tiled_lb2_scratch if self.problem.lb == "lb2"
                    else tiled_lb1_scratch)
            return make(self.M, self.problem.jobs, self.mt, self.vals_dtype,
                        self.device)
        return cycle_scratch(self.M, self.problem.jobs, self.vals_dtype,
                             self.device)

    # tts-lint: traced (the cycle a dispatch, batch or mesh graph captures, picked at run time)
    def _fused_cycle(self, state: ResidentState) -> None:
        lb2 = self.problem.lb == "lb2"
        if self.tiled:
            (tiled_lb2 if lb2 else tiled_lb1)(
                state.pool_vals, state.pool_aux, state.st, self._scratch,
                self.tables, self.M, self.mt, self.m, self.K, self.clk)
            return
        (cycle_lb2 if lb2 else cycle_lb1)(
            state.pool_vals, state.pool_aux, state.st, self._scratch,
            self.tables, self.M, self.m, self.K, self.clk)

    def _swap_pos(self, aux):
        return aux + 1  # parent depth = limit1 + 1

    def _evaluate(self, vals_c, aux_c, valid, best):
        n = self.problem.jobs
        # Staged lb2: the lb1 kernel decides the leaves (at a leaf lb1 and
        # lb2 are both the makespan) and the candidates.
        if self.staged:
            bounds = lb1_bounds(vals_c, aux_c, self.tables)
        elif self.mp > 1:
            bounds = lb2_bounds_mp(vals_c, aux_c, self.tables, self.mp,
                                   blocks=self.blocks,
                                   exchange=self.exchange)
        else:
            bounds = self.problem.device_bounds(vals_c, aux_c)
        pdepth = aux_c + 1
        kk = torch.arange(n, dtype=torch.int32, device=vals_c.device)
        open_ = (kk[None, :] >= pdepth[:, None]) & valid[:, None]
        leaf = open_ & ((pdepth + 1) == n)[:, None]
        # Leaf makespans fold into the incumbent before the prune test
        # (`pfsp_chpl.chpl:100-111`).
        best_t = torch.clamp(
            torch.where(leaf, bounds, torch.full_like(bounds, INF_BOUND))
            .min(), max=best)
        keep = open_ & ~leaf & (bounds < best_t)
        if self.staged:
            keep &= lb2_bounds_staged(vals_c, aux_c, keep, self.tables,
                                      self.mp, self.blocks,
                                      self.exchange) < best_t
        return keep, torch.sum(leaf, dtype=torch.int32), best_t


class NQueensResident(_ResidentProgram):
    """N-Queens: rows ``board`` uint8 and aux ``depth`` (int8 through
    N = 127, int32 beyond; the JAX ``_NQueensResident`` pool)."""

    # No pruning: every safe slot survives, so give the compactor half the
    # slot grid before it falls back to the overflow branch.
    survivor_budget_div = 2

    def __init__(self, problem: NQueensProblem, m: int, M: int, K: int,
                 capacity: int, device, fused: bool = True,
                 mt: int | None = None):
        self.vals_dtype, self.aux_dtype = pool_dtypes(problem)
        super().__init__(problem, m, M, K, capacity, device, fused=fused,
                         mt=mt)

    def _make_scratch(self):
        if self.tiled:
            return tiled_nqueens_scratch(self.M, self.problem.N, self.mt,
                                         self.device)
        return nqueens_scratch(self.M, self.problem.N, self.device)

    # tts-lint: traced (the cycle a dispatch, batch or mesh graph captures, picked at run time)
    def _fused_cycle(self, state: ResidentState) -> None:
        if self.tiled:
            tiled_nqueens(state.pool_vals, state.pool_aux, state.st,
                          self._scratch, self.problem, self.M, self.mt,
                          self.m, self.K, self.clk)
            return
        cycle_nqueens(state.pool_vals, state.pool_aux, state.st,
                      self._scratch, self.problem.N, self.problem.g, self.M,
                      self.m, self.K, self.clk)

    def _swap_pos(self, aux):
        return aux  # swap position is the parent depth itself

    def _evaluate(self, vals_c, aux_c, valid, best):
        N = self.problem.N
        # A popped node at depth == N is a solution (`nqueens_chpl.chpl:74`).
        sol_inc = torch.sum(valid & (aux_c == N), dtype=torch.int32)
        labels = self.problem.device_bounds(vals_c, aux_c).bool()
        keep = labels & valid[:, None] & (aux_c < N)[:, None]
        return keep, sol_inc, best


def program_compact(problem: Problem, M: int, fused: bool,
                    mp: int = 1) -> str | None:
    """The compaction mode a resident program of these arguments bakes in
    (``resolve_compact_mode``, ``TTS_COMPACT`` first), or None where it runs
    the fused cycle, which compacts inside its kernel (PFSP lb1_d and the
    mp pair axis always run the unfused one)."""
    unfused = (not fused or mp > 1
               or getattr(problem, "lb", None) == "lb1_d")
    return (resolve_compact_mode(problem, M, problem.child_slots)
            if unfused else None)


def program_key(m: int, M: int, K: int, capacity: int, device, fused: bool,
                staged: bool, mt: int | None, mp: int = 1,
                compact: str | None = None, blocks=None,
                exchange=None) -> tuple:
    """The cache key of a resident program (`resident.py:682-702`, with the
    port's routing inputs): what selects its cycle, its graphs and its
    state, the telemetry flags its graphs bake in and the unfused cycle's
    resolved compaction mode (``program_compact``: a cached ``scatter``
    program never serves a ``sort`` search). A mesh copy's pair
    ``blocks`` and ``exchange`` (its ``key``: its exchange group, the
    copies' positions and this copy's index) close it, so a copy program
    never serves another placement; a program without them keeps the key
    it had. K is the K
    asked for: the program's K moves along AdaptiveK's ladder and is set
    back when a search takes it."""
    return (m, M, K, capacity, str(resolve_device(device)), fused, staged, mt,
            obs_counters.device_counters_enabled(),
            obs_phases.phase_profiling_enabled(), compact) + (
                (mp,) if mp > 1 else ()) + (
                (tuple(blocks or ()), exchange.key)
                if exchange is not None else ())


def new_program(problem: Problem, m: int, M: int, K: int, capacity: int,
                device, fused: bool = True, staged: bool = True,
                mt: int | None = None, mp: int = 1, blocks=None,
                exchange=None) -> _ResidentProgram:
    """A new, uncached resident program of ``problem``; ``staged``,
    ``mp`` and a mesh copy's ``blocks`` and ``exchange`` reach the PFSP
    program only (``mp`` > 1: PFSP lb2), ``mt`` the fused cycle."""
    count_build("programs")
    if isinstance(problem, PFSPProblem):
        return PFSPResident(problem, m, M, K, capacity, device, fused=fused,
                            staged=staged, mt=mt, mp=mp, blocks=blocks,
                            exchange=exchange)
    if mp > 1:
        raise ValueError(MP_LB2_ONLY)
    if isinstance(problem, NQueensProblem):
        return NQueensResident(problem, m, M, K, capacity, device, fused=fused,
                               mt=mt)
    raise TypeError(f"no resident program for {type(problem).__name__}")


def make_program(problem: Problem, m: int, M: int, K: int, capacity: int,
                 device, fused: bool = True, staged: bool = True,
                 mt: int | None = None) -> _ResidentProgram:
    """The resident program of ``problem`` for a search (`resident.py:
    674-711`), held by the caller until ``release()``: cached on the
    problem under ``program_key`` (``take_cached``), its K set back to
    ``K``."""
    if not isinstance(problem, (PFSPProblem, NQueensProblem)):
        raise TypeError(f"no resident program for {type(problem).__name__}")
    prog = take_cached(
        problem, "_resident_programs",
        program_key(m, M, K, capacity, device, fused, staged, mt,
                    compact=program_compact(problem, M, fused)),
        lambda: new_program(problem, m, M, K, capacity, device, fused=fused,
                            staged=staged, mt=mt))
    prog.use_k(K)
    return prog


def release_programs(problem: Problem) -> int:
    """Close every program cached on ``problem`` (resident, batched and
    mesh): their graphs and device memory go (after their work has
    finished). Returns how many were closed."""
    progs = [p for attr in ("_resident_programs", "_batched_programs",
                            "_mesh_programs")
             for p in list((getattr(problem, attr, None) or {}).values())]
    for prog in progs:
        prog.close()
    return len(progs)


def default_capacity(M: int, child_slots: int, node_bytes: int) -> int:
    """Pool capacity heuristic: at least two full chunk fan-outs of headroom,
    capped by a ~1 GiB memory budget. Correctness never depends on it
    (overflow falls back to host offload cycles)."""
    want = max(2 * M * child_slots, 1 << 21)
    budget = (1 << 30) // max(1, node_bytes)
    return max(4 * M, min(want, budget))


def resolve_capacity(problem: Problem, M: int, capacity: int | None) -> tuple[int, int]:
    """Shared (capacity, M) resolution (`resident.py:723-742`): apply the
    default_capacity heuristic when unset, then clamp M so one chunk
    fan-out always fits in half the pool."""
    n = problem.child_slots
    if capacity is None:
        fields = problem.node_fields()
        node_bytes = sum(
            int(np.prod(shape, dtype=np.int64)) * dt.itemsize + 4
            for shape, dt in fields.values()
        )
        capacity = default_capacity(M, n, node_bytes)
    M = min(M, max(64, (capacity // 2) // n))
    # If the 64-chunk floor binds, grow the pool instead of leaving
    # M*n > capacity/2 — that would make the headroom check unsatisfiable
    # and run the whole search through the host-offload fallback.
    if 2 * M * n > capacity:
        capacity = 2 * M * n
    return capacity, M


def _emit_device_explored(ctr_total: dict | None, tree2: int, sol2: int,
                          fb_tree: int, fb_sol: int, host: int = 0) -> None:
    """Phase 2's ``explored`` samples. When the counter block ran, the
    device part comes from its totals (so the obs totals exercise the
    counter path, not the engine's own sums — tests pin exact parity) and
    the stall fallback's host part is a sample of its own; otherwise one
    sample carries the engine's counts (`tpu_tree_search/engine/resident.py`
    ``_emit_device_explored``)."""
    if not ev.enabled():
        return
    if ctr_total is not None:
        ev.counter("explored", host=host, tree=ctr_total["pushed"],
                   sol=ctr_total["leaves"], phase=2)
        if fb_tree or fb_sol:
            ev.counter("explored", host=host, tree=fb_tree, sol=fb_sol,
                       phase=2)
    else:
        ev.counter("explored", host=host, tree=tree2, sol=sol2, phase=2)


def resident_search(
    problem: Problem,
    m: int = 25,
    M: int = 65536,
    K: int | str = 4096,
    capacity: int | None = None,
    device=None,
    initial_best: int | None = None,
    warmup_target: int | None = None,
    fused: bool = True,
    staged: bool = True,
    mt: int | None = None,
    max_steps: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_interval_s: float = 60.0,
    resume_from: str | None = None,
    yield_fn=None,
    guard: bool | None = None,
) -> SearchResult:
    """3-phase search with a device-resident hot loop: host warm-up to
    ``warmup_target`` (default m) nodes, then dispatches of up to K device
    cycles of up to M parents until fewer than m nodes remain, then a host
    drain. ``problem`` is a `PFSPProblem` (lb1, lb1_d or lb2) or an
    `NQueensProblem`. ``device`` defaults to ``cuda`` (raises when absent);
    pass ``"cpu"`` for the plain PyTorch path. ``fused=False`` runs the
    unfused cycle, and under lb2 ``staged=False`` makes its evaluator the
    single-pass lb2 kernel. ``mt`` (the JAX ``TTS_MEGAKERNEL_MT``) below M
    streams the fused cycle in M // mt tiles; it must be a multiple of 8
    that divides M (``ValueError`` otherwise) and is inert on the unfused
    cycle.

    Dispatch is pipelined (``TTS_PIPELINE``, `engine/pipeline.py`): up to
    depth dispatches ride the stream while the host reads the lagged
    scalars of the oldest; exact, because a dispatch on a terminated or
    stalled pool runs zero cycles. ``K="auto"`` (or ``TTS_K=auto``)
    enables the adaptive geometric-ladder K controller; an integer pins K
    (clamped to the int32 counters' headroom).

    Checkpoints (`engine/checkpoint.py`, the JAX engine's semantics): with
    ``checkpoint_path`` the frontier and counters are saved every
    ``checkpoint_interval_s`` seconds and at a cut; ``max_steps`` cuts
    after that many consumed dispatches, and ``yield_fn`` (checked at every
    dispatch boundary) cuts when it returns True. A cut drains the
    in-flight dispatches (their counts join the totals and the saved
    counters), saves, and returns ``complete=False`` with the counts so far
    and no phase 3. ``resume_from`` loads a saved file in place of phase 1:
    its counters are phase 1's, the incumbent is the lower of ``best`` and
    the saved one, and the pool grows to hold the frontier and one
    fan-out.

    Telemetry (`obs/`): under ``TTS_OBS=1`` the result's ``obs`` holds the
    counter totals, under ``TTS_PHASEPROF=1`` also the per-phase ns
    (``phase_profile``) and the memory-roofline audit (``roofline``);
    ``TTS_QUALITY=1`` records the incumbent trajectory (``quality``);
    with event tracing on (``TTS_OBS`` 1 or host) the run emits the JAX
    engine's events.

    Guard mode (``guard=True``, else ``TTS_GUARD=1``; `analysis/guard.py`):
    after each program and K rung's first (warm) dispatch, every dispatch's
    enqueue must build no graph, library or program and, on the card, make
    no synchronising call, else ``GuardViolation``; the result's ``guard``
    counts the dispatches checked."""
    dev = resolve_device(device)
    best = (initial_best if initial_best is not None
            else getattr(problem, "initial_ub", INF_BOUND))
    n = problem.child_slots
    capacity, M = resolve_capacity(problem, M, capacity)
    k_auto, k_value = resolve_k(K, default_max=4096)
    # TTS_COSTMODEL: a measured-profile band replaces the fixed target.
    band, band_src = resolve_target_band("resident", RESIDENT_TARGET, problem,
                                         topology="device-D1", device=dev)
    depth = resolve_pipeline_depth()
    ctl = AdaptiveK(k_value, target=band) if k_auto else None
    pool = SoAPool(problem.node_fields())
    diagnostics = Diagnostics()
    problem._native()  # a first call builds it: outside the timed phases
    phases: list[PhaseStats] = []
    t0 = time.perf_counter()

    # -- phase 1: host warm-up (or checkpoint restore) -------------------------
    if resume_from is not None:
        saved = ckpt.load(resume_from, problem)
        pool.push_back_bulk(saved.batch)
        tree1, sol1 = saved.tree, saved.sol
        # Keep the tighter incumbent (a ub=1 run may resume a ub=0 cut).
        best = min(best, saved.best)
        capacity = max(capacity, pool.size + 2 * M * n)
    else:
        pool.push_back(index_batch(problem.root(), 0))
        target = m if warmup_target is None else warmup_target
        tree1, sol1, best = warmup(problem, pool, best, target)
    t1 = time.perf_counter()
    phases.append(PhaseStats(t1 - t0, tree1, sol1))
    ev.counter("explored", tree=tree1, sol=sol1, phase=1)

    # -- phase 2: device-resident loop ----------------------------------------
    program = make_program(problem, m, M, ctl.K if ctl else k_value,
                           capacity, dev, fused=fused, staged=staged, mt=mt)
    # The program's counters run across its searches: this one's are the
    # differences.
    build0 = program.graph_build_s
    device0 = program.dispatch_device_s
    program.host_slots(depth)
    state = program.own_state(pool.as_batch(), best)
    pool.clear()
    # --profile's window (`obs/phases.py` SessionTrace): K capped so that
    # the dispatches in flight before the first read stay in its budget;
    # each read reports the body's launches (`twin.on_dispatch`).
    session = obs_phases.SessionTrace.active()
    body = 0
    if session is not None:
        body = program.body_launches(state)
        program.k_cap = session.k_cap(body, depth)
        program.use_k(program.K)
    diagnostics.host_to_device += 1
    tree2 = sol2 = 0
    dispatches = stalls = 0
    size = m
    offloader = None
    queue = DispatchQueue(depth)
    ctr_total: dict | None = None  # counter totals (TTS_OBS=1)
    ph_total: dict | None = None  # per-phase ns totals (TTS_PHASEPROF=1)
    cycles_total = 0  # device cycles consumed (the roofline's cycles)
    fb_tree = fb_sol = 0  # the stall fallback's host increments
    prev_best = best
    # Anytime quality: None off; else the incumbent trajectory from the
    # scalars consume() already reads.
    qt = obs_quality.tracker(problem)
    # The steady-state torch.profiler window (--torch-trace): opens after
    # the first consumed dispatch (the graph build excluded).
    twin = obs_phases.TorchTraceWindow("resident")
    guards = RungGuards(program, "resident step", guard)

    def obs_result() -> dict | None:
        parts = {}
        if ctr_total is not None:
            parts["device_counters"] = ctr_total
        if ph_total is not None:
            parts["device_phases"] = ph_total
        return parts or None

    def enqueue() -> None:
        # Speculative dispatch: the state chains on the device from one
        # dispatch into the next, so up to `depth` K-cycle blocks ride the
        # stream while the host reads lagged scalars. The guard wraps the
        # enqueue only; the read waits outside it.
        with guards.of().step():
            read = program.enqueue(state)
        queue.push(read, ev.now_us())

    def consume(read, t_enq: float) -> int:
        nonlocal tree2, sol2, size, best, dispatches, ctr_total, ph_total
        nonlocal cycles_total, prev_best
        t_wait = ev.now_us()
        r = read(full=True)
        tree_inc, sol_inc, cycles, size, best = r[:5]
        tree2 += tree_inc
        sol2 += sol_inc
        dispatches += 1
        cycles_total += cycles
        diagnostics.kernel_launches += cycles
        if r.ctr is not None:
            ctr_total = obs_counters.merge_host(ctr_total, r.ctr)
        if r.ph is not None:
            ph_total = obs_phases.merge_host(ph_total, r.ph)
        twin.on_dispatch(dispatches, cycles * body,
                         (len(queue) + 1) * program.K * body)
        fr.heartbeat("resident", seq=dispatches, cycles=cycles, size=size,
                     best=best, tree=tree2, sol=sol2, depth=depth,
                     K=program.K, inflight=len(queue), phases=ph_total)
        if qt is not None:
            qt.observe(best, dispatches, tree1 + tree2)
        if ev.enabled():
            now = ev.now_us()
            # The span covers enqueue -> scalars read (spans overlap at
            # depth > 1; `report` merges overlaps for the busy fraction);
            # read_wait_us is the blocked part, device_ms the graph's
            # device time (CUDA events; None off the graph).
            ev.emit("dispatch", ph="X", ts=t_enq,
                    dur=max(0.0, now - t_enq), args={
                        "cycles": cycles, "tree": tree_inc, "sol": sol_inc,
                        "size": size, "best": best,
                        "enqueue_us": t_enq, "read_wait_us": now - t_wait,
                        "pipeline_depth": depth, "device_ms": r.device_ms,
                    })
            if r.ctr is not None:
                ev.counter("device_counters", **obs_counters.as_args(r.ctr))
            if r.ph is not None:
                ev.counter("device_phases", **obs_phases.as_args(r.ph))
            if best < prev_best:
                ev.emit("incumbent", args={"best": best})
        prev_best = best
        return cycles

    def drain_queue() -> tuple[int, int]:
        # Read every in-flight dispatch before any action that needs
        # coherent totals or the final state (termination, checkpoint cuts,
        # K resizes, the capacity-stall fallback): zeros for speculative
        # no-ops. Returns the (tree, sol) the drained dispatches added.
        tree0, sol0 = tree2, sol2
        for read, t_enq in queue.drain():
            consume(read, t_enq)
        return tree2 - tree0, sol2 - sol0

    def snapshot_fn():
        batch, _, bst = program.residual(state)
        diagnostics.device_to_host += 1
        return batch, bst

    controller = ckpt.RunController(
        problem, checkpoint_path, checkpoint_interval_s, max_steps,
        snapshot_fn, drain_fn=drain_queue, yield_fn=yield_fn)
    complete = True

    fr.arm("resident")
    ev.emit("pipeline", args={
        "depth": depth, "K": program.K, "k_auto": k_auto, "tier": "resident",
    })
    if ev.enabled():
        # The static shape facts `report --roofline` rebuilds the floors
        # from, with the device_counters and device_phases samples.
        ev.emit("roofline_meta", args=obs_roofline.meta_args(program))
    if band_src is not None:
        ev.emit("costmodel", args={
            "source": band_src, "lo_ms": round(1e3 * band[0], 1),
            "hi_ms": round(1e3 * band[1], 1), "tier": "resident",
        })
    try:
        last_ready = time.monotonic()
        while True:
            while not queue.full:
                enqueue()
            read, t_enq = queue.pop()
            cycles = consume(read, t_enq)
            now = time.monotonic()
            period, last_ready = now - last_ready, now
            if size < m:
                drain_queue()  # speculative no-ops: zero counts, state intact
                break
            if controller.after_step(tree1 + tree2, sol1 + sol2):
                drain_queue()  # a no-op when the cut's save drained it
                complete = False
                ev.emit("checkpoint", args={"cutoff": True})
                break
            if ctl is not None and cycles > 0 and ctl.observe(period, cycles):
                # Geometric-ladder K resize: drain, then switch to the
                # rung's graph (built once a rung, on the same state).
                drain_queue()
                program.use_k(ctl.K)
                ev.emit("k_resize", args={"K": program.K})
                last_ready = time.monotonic()
                if size < m:
                    break  # the drained dispatches finished the search
                continue
            if cycles == 0:
                # Capacity stall: pool too full for another device fan-out.
                # Run offload cycles through a host pool until there is
                # headroom again (rare; guarantees progress at any
                # capacity).
                drain_queue()  # stalled speculative dispatches are no-ops
                t_fb = ev.now_us()
                fb_tree0, fb_sol0 = tree2, sol2
                stalls += 1
                batch, size, best = program.residual(state)
                diagnostics.device_to_host += 1
                pool.reset_from(batch)
                if offloader is None:
                    offloader = DeviceOffloader(problem, dev)
                chunk_buf = problem.empty_batch(M)
                while pool.size >= m and pool.size + M * n > capacity:
                    count = pool.pop_back_bulk(m, M, chunk_buf)
                    parents, bounds = offloader.evaluate(chunk_buf, count,
                                                         best)
                    res = problem.generate_children(parents, count, bounds,
                                                    best)
                    tree2 += res.tree_inc
                    sol2 += res.sol_inc
                    best = res.best
                    pool.push_back_bulk(res.children)
                program.load_state(state, pool.as_batch(), best)
                pool.clear()
                diagnostics.host_to_device += 1
                # The re-upload is a sanctioned host round trip: the next
                # dispatch is a warm one for the guard.
                guards.of().rearm()
                last_ready = time.monotonic()
                fb_tree += tree2 - fb_tree0
                fb_sol += sol2 - fb_sol0
                ev.complete("overflow_fallback", t_fb, args={
                    "tree": tree2 - fb_tree0, "sol": sol2 - fb_sol0,
                })
        twin.close()
        if complete:
            batch, size, best = program.residual(state)
            diagnostics.device_to_host += 1
    finally:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        twin.close()
        program.k_cap = None
        program.release()
    if offloader is not None:
        diagnostics.kernel_launches += offloader.diagnostics.kernel_launches
        diagnostics.host_to_device += offloader.diagnostics.host_to_device
        diagnostics.device_to_host += offloader.diagnostics.device_to_host
    t2 = time.perf_counter()
    phases.append(PhaseStats(t2 - t1, tree2, sol2))
    _emit_device_explored(ctr_total, tree2, sol2, fb_tree, fb_sol)

    # -- phase 3: host drain (none after a cut) --------------------------------
    tree3 = sol3 = 0
    if complete:
        pool.reset_from(batch)
        tree3, sol3, best = drain(problem, pool, best)
        phases.append(PhaseStats(time.perf_counter() - t2, tree3, sol3))
        ev.counter("explored", tree=tree3, sol=sol3, phase=3)
        if qt is not None:
            # The host drain can improve the incumbent one last time.
            qt.observe(best, dispatches, tree1 + tree2 + tree3)

    return SearchResult(
        explored_tree=tree1 + tree2 + tree3,
        explored_sol=sol1 + sol2 + sol3,
        best=best,
        elapsed=time.perf_counter() - t0,
        phases=phases,
        diagnostics=diagnostics,
        complete=complete,
        steps=controller.steps,
        engine="resident",
        compact=program.compact,
        compact_auto=auto_chosen(program.compact),
        fused=program.fused,
        staged=program.staged,
        megakernel_mt=program.mt,
        M=M,
        k_resolved=program.K,
        dispatches=dispatches,
        stall_fallbacks=stalls,
        pipeline_depth=depth,
        k_auto=k_auto,
        graph_build_s=program.graph_build_s - build0,
        dispatch_device_s=(None if device0 is None
                           else program.dispatch_device_s - device0),
        obs=obs_result(),
        phase_profile=ph_total,
        roofline=obs_roofline.result_audit(program, ph_total, ctr_total,
                                           cycles_total),
        quality=qt.result() if qt is not None else None,
        guard=guards.record(),
    )


# -- program contracts (`check`, analysis/contracts.py) ------------------------
# The push, pool and steady-state claims of this engine, declared here and
# checked for every knob-matrix cell by analysis/program_audit.py.

from ..analysis.contracts import (  # noqa: E402
    child_value_gathers,
    contract,
    host_reads,
)

#: Graph node kinds a steady-state dispatch may not hold: a host function
#: and a copy with a host end.
HOST_NODES = ("host", "memcpy_host")


@contract(
    "fused-push-single-gather",
    claim="in every survivor-path mode the cycle holds at most ONE gather "
          "big enough to move child values (>= S rows of n lanes in the "
          "pool's value dtype) beyond the bare evaluator's own (the staged "
          "lb2 evaluator materialises its candidates): the push's gather of "
          "the parents' rows; the children are then built by selects, and "
          "mask and index gathers move no node data",
    artifact="cycle",
)
def _contract_single_gather(art, cell):
    prog = art.prog
    n = prog.problem.child_slots
    dt = str(prog.vals_dtype).replace("torch.", "")
    big = child_value_gathers(art.record.body, prog.S, n, dt)
    budget = 1 + len(child_value_gathers(art.eval_entries, prog.S, n, dt))
    if len(big) <= budget:
        return []
    return [f"{len(big)} child-value-sized gathers in the cycle (budget "
            f"{budget}, the evaluator's included): "
            + "; ".join(e.text[:100] for e in big)]


@contract(
    "pool-in-place",
    claim="the dispatch works on the pool in place: the pool and state "
          "tensors keep their addresses across a cycle (the dispatch graph "
          "bakes them in, ops/dispatch.py:30-32), and the cycle allocates "
          "no tensor of pool-capacity rows — the counterpart of the JAX "
          "step's donated pool buffers",
    artifact="cycle",
)
def _contract_pool_in_place(art, cell):
    out = []
    if not art.in_place:
        out.append("the pool or the state moved during the dispatch (the "
                   "graph's baked addresses would go stale)")
    big = [e for e in art.record.entries
           if e.get("alloc_rows", 0) >= art.capacity]
    if big:
        out.append(f"{len(big)} allocation(s) of pool-capacity rows in the "
                   "dispatch: " + "; ".join(e.text[:80] for e in big))
    return out


@contract(
    "step-callback-armed-only",
    claim="the steady-state dispatch reads nothing back: no "
          "_local_scalar_dense (.item(), int(), bool()), no tolist or "
          "numpy, no copy from the card to the host and no operation whose "
          "shape depends on the data (nonzero, masked_select) in any cycle "
          "(the solo cells, the batched programs' slots); on the card no "
          "host node and no memcpy with a host end in any graph: the "
          "dispatch graph, its while body and the graphs nested in them "
          "(a batch slot's or mesh shard's gated body, a mesh round's body "
          "and balance step; program_audit.audit_mesh records the mesh "
          "graphs on the card). The phase clock (phase_mark, on "
          "%globaltimer) is the armed instrument: present where "
          "TTS_PHASEPROF=1 (the seed mark, and the unfused cycle's marks) "
          "and only there",
    artifact="cycle",
)
def _contract_callbacks(art, cell):
    rec = art.record
    out = []
    reads = host_reads(rec.entries)
    if reads:
        out.append("host reads in the steady-state dispatch: "
                   + ", ".join(sorted({e.name for e in reads})))
    marks = [e for e in rec.entries if e.name == "phase_mark_cuda"]
    armed = cell is not None and cell.phaseprof == "1"
    if armed and not marks:
        out.append("armed cell without its phase_mark entries (the "
                   "instrument is silently gone)")
    if not armed and marks:
        out.append(f"{len(marks)} phase_mark (clock) entries in an unarmed "
                   "dispatch")
    if rec.nodes is not None:
        for part, nodes in rec.nodes.items():
            bad = [k for _, k in nodes if k in HOST_NODES]
            if bad:
                out.append(f"{part} graph holds {bad} nodes")
        clock = [nm for nodes in rec.nodes.values() for nm, _ in nodes
                 if "phase_mark" in nm]
        if armed != bool(clock):
            out.append(f"graph clock nodes {len(clock)} where the cell is "
                       f"{'armed' if armed else 'unarmed'}")
    return out


@contract(
    "program-cache-key-sound",
    claim="what a program bakes in keys the program cache: a flip of "
          "TTS_COMPACT (the unfused cycle's resolved mode), TTS_OBS, "
          "TTS_PHASEPROF, the cycle (fused=, the JAX TTS_MEGAKERNEL) or "
          "its tile width (mt=, TTS_MEGAKERNEL_MT) takes a new program; "
          "TTS_PIPELINE, TTS_GUARD, TTS_STEAL, TTS_NARROW (the port's host "
          "layout does not read it), TTS_MEGAKERNEL as an env knob and a "
          "plain rebuild take the same cached one",
    artifact="cache-key",
)
def _contract_cache_key(art, cell):
    out = []
    for knob, (a, b) in art.distinct.items():
        if a is b:
            out.append(f"{knob} flip reused the same cached program (stale "
                       "structure would run)")
    for knob, (a, b) in art.shared.items():
        if a is not b:
            out.append(f"{knob} flip rebuilt the program (a knob the "
                       "program does not see leaks into the cache key)")
    return out


@contract(
    "narrow-knob-inert",
    claim="TTS_NARROW never changes a program: the port's device pools "
          "are narrow by their dtypes (engine/device.py pool_dtypes) and "
          "it has no host-layout knob, so the =0 build records the same "
          "program as the unset build",
    artifact="variants",
)
def _contract_narrow_inert(art, cell):
    if not art.has("off", "narrow0"):
        return []
    if art.text("off") != art.text("narrow0"):
        return ["TTS_NARROW=0 build differs from the unset build"]
    return []
