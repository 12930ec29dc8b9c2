"""Mesh-resident search: the device-resident engine over D pool shards — the
port of `tpu_tree_search/parallel/resident_mesh.py`.

The JAX tier runs one SPMD program over a mesh of D devices: each device
holds a pool shard and runs the resident chunk loop on it, and after each
of a dispatch's rounds the shards' incumbents fold with ``lax.pmin`` and
one round of ring diffusion moves the front of a shard that can spare
nodes (>= 2m) to a starving right neighbour (< m), from an ``all_gather``
of the sizes. The host stops when every shard holds fewer than m nodes
and drains the residual, as the single-device tier's phase 3.

Here the D shards sit on a list of device positions, by default one card
(the port's counterpart of the JAX tests' eight virtual CPU devices;
`ROADMAP.md` C), as one program (``MeshProgram``). On one position: one
(D, ST_LEN) state tensor, a (D, C, n) pool and a (D, C) column, and one
CUDA graph a dispatch (`ops/mesh.py` ``MeshGraph``): for each of
``rounds`` rounds, ``batch_init``, a ``while`` node over the shards'
cycles (a shard whose condition fails is frozen) and the balance step
(``mesh_balance``, `csrc/mesh_balance.cu`). Inside a JAX round the shards
do not interact, so each shard runs the cycles of its own
``lax.while_loop``, and the counts, the incumbent and every shard's live
rows are the JAX program's. The cycles are the fused ones (kernels 2, 4 or
8), or under lb1_d, ``fused=False`` or the lb2 pair axis ``mp`` > 1 the
unfused ones of fixed shapes, graphed alike. Several positions (cards, or
one card repeated) hold a group of shards each, with a graph a group and
round and a balance across the groups (``MeshProgram``); under ``mp`` a
shard has a copy at each position of its (dp, mp) grid row, the copies
joined by the pair exchange (`ops/pair_exchange.py`). Off the card
(``device="cpu"``) the same program runs the plain cycles shard by shard
and ``mesh_balance_plain``: the oracle of the tests.

With a fixed incumbent (N-Queens; PFSP ub=1) the tree and solutions equal
the sequential tier's: balancing moves nodes between shards and never
makes or drops one. The three phases, the pipelined dispatch
(``TTS_PIPELINE``), ``K="auto"`` on the mesh's tighter band
(``MESH_TARGET``), the checkpoints (``checkpoint_path``, ``max_steps``,
``yield_fn``; a resumed frontier re-partitions stride-D, so D may change)
and the saturation fallback (no shard ran a cycle and nothing moved: host
offload cycles through ``DeviceOffloader`` until the frontier fits) are
the JAX function's. Programs are cached on ``problem._mesh_programs`` and
held for a search, as the resident engine's (`engine/resident.py`), and
the steady-state guard (``guard``, ``TTS_GUARD=1``) wraps each dispatch's
enqueue as there.
"""

from __future__ import annotations

import threading
import time
from contextlib import ExitStack, contextmanager

import numpy as np
import torch

from ..analysis.guard import RungGuards
from ..engine import checkpoint as ckpt
from ..engine import resident as R
from ..engine.device import DeviceOffloader, drain, warmup
from ..engine.pipeline import (
    MESH_TARGET,
    AdaptiveK,
    DispatchQueue,
    resolve_k,
    resolve_pipeline_depth,
    resolve_target_band,
)
from ..engine.results import Diagnostics, PhaseStats, SearchResult
from ..obs import counters as obs_counters
from ..obs import events as ev
from ..obs import flightrec as fr
from ..obs import phases as obs_phases
from ..obs import quality as obs_quality
from ..ops.backend import resolve_device, resolve_devices
from ..ops.compact_policy import auto_chosen
from ..ops.cycle import ST_ACTIVE, ST_BEST, ST_CTR, ST_CYCLES, ST_LEN
from ..ops.dispatch import phase_mark
from ..ops.mesh import (
    MeshGraph,
    MeshScratch,
    mesh_balance,
    mesh_plan,
    shard_moves,
)
from ..ops.pair_exchange import ST_XERR, PairExchange, raise_on_error
from ..pool.pool import SoAPool
from ..problems.base import INF_BOUND, Problem, index_batch


class _Copy:
    """One copy of a shard (``MeshProgram``): its shard, its place among
    the shard's copies (0: the primary, which the host reads), the pair
    blocks it bounds (None: all of the mp, the shard's only copy) and its
    exchange end (None without peers)."""

    def __init__(self, shard: int, index: int, blocks, endpoint=None):
        self.shard = shard
        self.index = index
        self.blocks = blocks
        self.endpoint = endpoint


class _Group:
    """The copies of one device position (``MeshProgram``): their (Dg,
    ST_LEN) states, (Dg, C, n) pool and (Dg, C) column on the position's
    device, uncached resident programs of the mesh's configuration on that
    device (one a copy's blocks and exchange, keyed by ``program_key``:
    copies without peers share one, whose cycle serves them all), run one
    after another on the group's stream, the balance scratch (one group)
    and, with more than one group, a stream of its own and the balance's
    buffers (the left neighbours' first T rows, the plan)."""

    def __init__(self, prog: "MeshProgram", device, copies: list[_Copy],
                 T: int, grouped: bool):
        problem, C = prog.problem, prog.capacity
        self.device = device
        self.copies = copies
        self.shards = [c.shard for c in copies]
        Dg, width = len(copies), problem.child_slots
        self.st = torch.zeros((Dg, ST_LEN), dtype=torch.int32, device=device)
        for j, c in enumerate(copies):
            x = prog.exchanges[c.shard]
            if x is not None:  # its error word: a word of its state row
                c.endpoint = x.endpoint(c.index,
                                        self.st[j, ST_XERR:ST_XERR + 1])
        programs: dict = {}
        self.programs = []
        for c in copies:
            args = (prog.m, prog.M, prog.K, C, device)
            key = R.program_key(*args, prog.fused, prog.staged, None, prog.mp,
                                blocks=c.blocks, exchange=c.endpoint)
            if key not in programs:
                programs[key] = R.new_program(
                    problem, *args, fused=prog.fused, staged=prog.staged,
                    mp=prog.mp, blocks=c.blocks, exchange=c.endpoint)
            self.programs.append(programs[key])
        self.inner = inner = self.programs[0]
        self.pool_vals = torch.zeros((Dg, C, width), dtype=inner.vals_dtype,
                                     device=device)
        self.pool_aux = torch.zeros((Dg, C), dtype=inner.aux_dtype,
                                    device=device)
        self.states = [R.ResidentState(self.pool_vals[j], self.pool_aux[j],
                                       self.st[j]) for j in range(Dg)]
        self.cycles = [p.slot_cycle(s)
                       for p, s in zip(self.programs, self.states)]
        cuda = device.type == "cuda"
        self.scratch = (MeshScratch.make(self.pool_vals, self.pool_aux)
                        if cuda and not grouped else None)
        self.stream = torch.cuda.Stream(device) if cuda and grouped else None
        if grouped:
            self.left_vals = self.pool_vals.new_zeros((Dg, T, width))
            self.left_aux = self.pool_aux.new_zeros((Dg, T))
            self.plan = torch.zeros((Dg, 4), dtype=torch.int32, device=device)

    def host_rounds(self, first: bool) -> None:
        """One round of the group's copies on the host (the CPU)."""
        self.inner.host_rounds(self.states, self.st, first, self.cycles)

    def context(self):
        """The group's device and stream as the current ones (the card)."""
        stack = ExitStack()
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack


class MeshProgram(R.CachedProgram):
    """D shards of one resident program (`resident_mesh.py`
    ``_MeshResidentProgram``), placed on a list of device positions
    (``devices``; default one, ``device``) by the (dp, mp) grid
    ``mp_grid``. K is capped so that a dispatch's ``rounds * K`` cycles
    keep the int32 counters in range (`resident_mesh.py:110`). ``mp`` > 1
    (PFSP lb2) splits each shard's lb2 pair loop in mp pair blocks and runs
    the unfused cycle.

    Shard d has one copy at each distinct position of its grid row (the
    JAX replicas (d, i), which redundantly own the same pool block,
    `resident_mesh.py:118-121`; ``copy_layout``): the copy at a position
    bounds the pair blocks placed there, in turn, and joins its peers'
    planes through the shard's ``PairExchange`` (`ops/pair_exchange.py`,
    the JAX ``lax.pmax``) once each evaluation, so every copy keeps the
    same rows and meets the same loop condition on the same cycle, with
    no other collective. A position repeating a card is a position of its
    own (its own group, stream and graph). A shard whose row names one
    position has one copy, which bounds every block: with mp = 1, or every
    row on one position, the program is the one-copy tier as before. The
    copies of one position form a group (``_Group``).

    Every write from outside the cycles goes to every copy (``upload``,
    the balance, ``clamp_best``); ``full_batch`` and the checkpoint read
    the primaries (copy 0); each dispatch's read holds every copy's state
    rows, round by round, to its primary's and raises on a difference or
    on an exchange's error word (``ST_XERR``).

    One group is the tier as before: one CUDA graph a dispatch (``graph``)
    whose rounds run the shards' cycles and the balance kernel. Several
    groups dispatch one graph a group and round (a graph does not span
    cards): each round's graphs are all launched, each on its group's
    stream after the main stream, before the main stream waits for any of
    them (copies that exchange inside their graphs would deadlock if one
    waited for another's launch), then the cross-group balance
    (``_balance_groups``): the primaries' state rows and first T rows
    gathered onto the first group's card by device-to-device copies, the
    plan of all D rows there (``mesh_plan``: the balance kernel's plan
    launch), the rows and plans copied back to every copy, and each
    group's gifts and sheds made on its own card (``shard_moves``). CUDA
    events (``wait_stream``) order the streams; nothing is read on the
    host. The plan depends only on the shards' sizes and incumbents, so
    every shard holds the live rows of the one-group run with the same D.
    Off the card the copies of several groups run their rounds in host
    threads, one a group (the plain exchange waits at a barrier)."""

    cache_attr = "_mesh_programs"

    def __init__(self, problem: Problem, D: int, m: int, M: int, K: int,
                 rounds: int, T: int, capacity: int, device=None,
                 fused: bool = True, staged: bool = True, mp: int = 1,
                 devices=None):
        if D < 1:
            raise ValueError(f"D must be >= 1, got {D}")
        if mp < 1:
            raise ValueError(f"mp must be >= 1, got {mp}")
        self.problem = problem
        self.D = int(D)
        self.mp = int(mp)
        self.m = m
        self.M = M
        self.K = K
        self.rounds = max(1, int(rounds))
        self.T = int(T)
        self.capacity = capacity
        self.fused, self.staged = fused, staged
        positions = mesh_devices(devices, device)
        self.devices = positions
        self.grid = mp_grid(self.D, self.mp, len(positions))
        self.layout = copy_layout(self.grid)
        order = sorted({p for row in self.layout for p, _ in row})
        grouped = len(order) > 1
        # One exchange a shard with several copies, over M*n words (the
        # child plane; the staged self plane has as many rows).
        self.exchanges = [
            PairExchange([positions[p] for p, _ in row],
                         M * problem.child_slots) if len(row) > 1 else None
            for row in self.layout]
        self.copied = any(x is not None for x in self.exchanges)
        # Copies of one shard on one card (not traceable: COPIES_TRACED).
        self.shared_cards = shared_card_copies(positions, self.D, self.mp)
        copies = {p: [] for p in order}
        for d, row in enumerate(self.layout):
            for i, (p, blocks) in enumerate(row):
                copies[p].append(_Copy(d, i, blocks if len(row) > 1 else None))
        self.groups = [_Group(self, positions[p], copies[p], self.T, grouped)
                       for p in order]
        g0 = self.groups[0]
        self.inner = g0.inner
        inner = self.inner
        self.device = g0.device
        self.obs = inner.obs
        self.clk = inner.clk
        if grouped and self.clk is not None:
            raise ValueError("the phase clock (TTS_PHASEPROF=1) times one "
                             "device group: give the mesh one device")
        self.graphed = inner.graphed
        self.use_k(K)
        # One group: its tensors are the program's (a row a shard).
        # Several: ``st`` gathers every shard's row on the first group's
        # card at each balance (the dispatch's read), with the shards'
        # first T rows and the plan; with copies ``copy_st`` gathers every
        # copy's row of each round before its balance.
        if grouped:
            width = problem.child_slots
            dev = self.device
            self.st = torch.zeros((self.D, ST_LEN), dtype=torch.int32,
                                  device=dev)
            self.fronts_vals = g0.pool_vals.new_zeros((self.D, self.T, width))
            self.fronts_aux = g0.pool_aux.new_zeros((self.D, self.T))
            self.plan = torch.zeros((self.D, 4), dtype=torch.int32,
                                    device=dev)
            self.pool_vals = self.pool_aux = None
            self.scratch = None
            ids = iter(range(sum(len(g.copies) for g in self.groups)))
            self._gather = []
            for g in self.groups:
                prim = [j for j, c in enumerate(g.copies) if c.index == 0]
                self._gather.append((
                    None if len(prim) == len(g.copies)
                    else torch.tensor(prim, device=g.device),
                    torch.tensor([g.shards[j] for j in prim], device=dev),
                    torch.tensor(g.shards, device=dev),
                    torch.tensor([(d - 1) % self.D for d in g.shards],
                                 device=dev),
                    torch.tensor([next(ids) for _ in g.copies], device=dev)))
            self._copy_ids = [(g, j) for g in self.groups
                              for j in range(len(g.copies))]
            self.copy_st = (torch.zeros((self.rounds, len(self._copy_ids),
                                         ST_LEN), dtype=torch.int32,
                                        device=dev)
                            if self.copied else None)
        else:
            self.st, self.pool_vals, self.pool_aux = g0.st, g0.pool_vals, \
                g0.pool_aux
            self.scratch = g0.scratch
            self.copy_st = None
        self.states = [None] * self.D
        for g in self.groups:
            for j, c in enumerate(g.copies):
                if c.index == 0:
                    self.states[c.shard] = g.states[j]
        self._graphs: dict[tuple, MeshGraph] = {}
        self.graph_build_s = 0.0
        self.dispatch_device_s = 0.0 if self.graphed else None
        self._slots: list[tuple] = []
        self._next_slot = 0
        # Set when a read found the copies apart: their exchanges' numbers
        # may be too, so ``release`` closes the program.
        self.failed = False

    def release(self) -> None:
        """``CachedProgram.release``, but a program whose copies failed is
        closed, never served again."""
        if self.failed:
            self.close()
        else:
            super().release()

    @property
    def grouped(self) -> bool:
        return len(self.groups) > 1

    @property
    def Mn(self) -> int:
        return self.M * self.problem.child_slots

    def use_k(self, K: int) -> None:
        """K clamped so that rounds * K cycles of M*n children fit int32;
        the groups' programs take the same K."""
        self.K = max(1, min(K, (2**31 - 1) // max(1, self.Mn * self.rounds)))
        for g in self.groups:
            for p in g.programs:
                p.K = self.K

    def copy_states(self):
        """``(shard, copy index, state)`` of every copy."""
        for g in self.groups:
            for c, s in zip(g.copies, g.states):
                yield c.shard, c.index, s

    # -- the shards' frontiers ----------------------------------------------

    def upload(self, frontier: dict, best: int) -> None:
        """The static stride-D partition of ``frontier``
        (`nqueens_multigpu_chpl.chpl:221-225`): shard d gets nodes d::D,
        copied into every copy's existing tensors (the graphs stay valid),
        with incumbent ``best`` and zeroed counts."""
        for d, _, state in self.copy_states():
            self.inner.load_state(
                state, {k: v[d::self.D] for k, v in frontier.items()}, best)

    def clamp_best(self, best: int) -> None:
        """Every copy's incumbent clamped to ``best`` (a global incumbent
        from outside the mesh), behind the dispatches enqueued on each
        group's stream."""
        for g in self.groups:
            with g.context():
                g.st[:, ST_BEST].clamp_(max=int(best))

    def full_batch(self) -> dict:
        """Every live node of every shard, shard by shard, from the
        primaries (the residual, the checkpoint snapshot and the saturation
        fallback's download), ordered after the dispatches enqueued on the
        current stream."""
        p = self.problem
        fields = p.node_fields()
        if self.grouped and self.graphed:
            for g in self.groups:
                torch.cuda.current_stream(g.device).wait_stream(g.stream)
        sizes = [0] * self.D
        for g in self.groups:
            for c, size in zip(g.copies, g.st[:, 0].tolist()):
                if c.index == 0:
                    sizes[c.shard] = size
        parts = [(s.pool_vals[:z], s.pool_aux[:z])
                 for s, z in zip(self.states, sizes)]
        batch = {
            p.vals_field: torch.cat([v.cpu() for v, _ in parts]).numpy()
            .astype(fields[p.vals_field][1]),
            p.aux_field: torch.cat([a.cpu() for _, a in parts]).numpy()
            .astype(fields[p.aux_field][1]),
        }
        return self.inner.derive_fields(batch)

    # -- dispatch -----------------------------------------------------------

    def host_slots(self, depth: int) -> None:
        """One pinned (D, ST_LEN) buffer (and with copies one for the
        copies' rows) and its events for each of ``depth`` dispatches in
        flight (the graph's lagged reads)."""
        if self.graphed and len(self._slots) != max(1, depth):
            self._slots = [
                (torch.empty((self.D, ST_LEN), dtype=torch.int32,
                             pin_memory=True),
                 torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True), torch.cuda.Event(),
                 None if self.clk is None else torch.empty(
                     self.clk.numel(), dtype=torch.int64, pin_memory=True),
                 None if self.copy_st is None else torch.empty(
                     self.copy_st.shape, dtype=torch.int32, pin_memory=True))
                for _ in range(max(1, depth))]
            self._next_slot = 0

    # tts-lint: traced (the balance step a mesh graph captures after each round)
    def balance(self, r: int) -> None:
        """Round r's balance step (one group: the kernel on the card)."""
        mesh_balance(self.st, self.pool_vals, self.pool_aux, self.scratch,
                     self.m, self.T, self.Mn, r == 0, r == self.rounds - 1)

    def graph(self, group: int = 0, r: int | None = None) -> MeshGraph:
        """A mesh dispatch graph at the current K over the program's
        tensors (which it keeps for its life), built at first use: one
        group's whole dispatch (``r`` None), or with several groups group
        ``group``'s round ``r`` (its cycles; round 0 zeroes the counter
        block)."""
        g = self.groups[group]
        key = (self.K, group, None if r is None else r == 0,
               g.st.data_ptr(), g.pool_vals.data_ptr(),
               g.pool_aux.data_ptr())
        graph = self._graphs.get(key)
        if graph is None:
            n = self.problem.child_slots
            inner = g.inner
            with g.context():
                graph = MeshGraph(
                    g.cycles, self.balance if r is None else None, g.st,
                    self.m, self.Mn, self.capacity, self.K,
                    self.rounds if r is None else 1,
                    obs=n if self.obs else 0, clk=self.clk,
                    fold=inner.fused, zero_block=r is None or r == 0)
            self.graph_build_s += graph.build_s
            self._graphs[key] = graph
        return graph

    def step(self) -> None:
        """One dispatch on the host's loop (the CPU): ``rounds`` times, the
        shards' cycles until every shard's condition fails
        (``host_rounds``; the groups in threads where copies exchange),
        then the balance step."""
        P = obs_phases.IDX
        if self.clk is not None:
            phase_mark(self.clk, 0, obs_phases.SEED)
        for r in range(self.rounds):
            if self.copied:
                _in_threads([lambda g=g: g.host_rounds(r == 0)
                             for g in self.groups])
            else:
                for g in self.groups:
                    g.host_rounds(r == 0)
            if self.clk is not None:
                phase_mark(self.clk, P["loop"])
            if self.grouped:
                self._balance_groups(r)
            else:
                self.balance(r)
            if self.clk is not None:
                phase_mark(self.clk, P["balance"])

    def _balance_groups(self, r: int) -> None:
        """Round r's balance across the groups (see the class note): on
        the card each step on its stream, ordered by ``wait_stream``."""
        main = (torch.cuda.current_stream(self.device) if self.graphed
                else None)
        T = self.T
        for g, (prim, shards, _, _, ids) in zip(self.groups, self._gather):
            with _streams(main, g):
                if self.copy_st is not None:
                    self.copy_st[r].index_copy_(0, ids, g.st.to(self.device))
                if not len(shards):
                    continue
                st, vals, aux = g.st, g.pool_vals[:, :T], g.pool_aux[:, :T]
                if prim is not None:
                    st, vals, aux = (t.index_select(0, prim)
                                     for t in (st, vals, aux))
                self.st.index_copy_(0, shards, st.to(self.device))
                self.fronts_vals.index_copy_(0, shards, vals.to(self.device))
                self.fronts_aux.index_copy_(0, shards, aux.to(self.device))
        mesh_plan(self.st, self.plan, self.m, T, self.Mn, self.capacity,
                  r == 0, r == self.rounds - 1)
        for g, (_, _, rows, lefts, _) in zip(self.groups, self._gather):
            with _streams(main, g):
                g.st.copy_(self.st.index_select(0, rows))
                g.plan.copy_(self.plan.index_select(0, rows))
                g.left_vals.copy_(self.fronts_vals.index_select(0, lefts))
                g.left_aux.copy_(self.fronts_aux.index_select(0, lefts))
                shard_moves(g.pool_vals, g.pool_aux, g.plan, g.left_vals,
                            g.left_aux)

    def check_copies(self, copy_rows: list | None) -> None:
        """Raise where a copy's exchange gave up (its error word) or a
        copy's state row differs from its primary's in any round of the
        dispatch (``copy_rows``: ``copy_st`` read after it; None without
        copies), the loop's ``ST_ACTIVE`` aside (``loop_rows``)."""
        if copy_rows is None:
            return
        for r, rows in enumerate(copy_rows):
            primary = {}
            for (g, j), row in zip(self._copy_ids, rows):
                c = g.copies[j]
                if row[ST_XERR]:
                    self.failed = True
                    raise_on_error(row[ST_XERR], c.index)
                if c.index == 0:
                    primary[c.shard] = row
            for (g, j), row in zip(self._copy_ids, rows):
                c = g.copies[j]
                if loop_rows([row]) != loop_rows([primary[c.shard]]):
                    self.failed = True
                    raise RuntimeError(
                        f"mesh copies diverged: shard {c.shard}'s copy "
                        f"{c.index} on {g.device} left round {r} with state "
                        f"{row}, its primary {primary[c.shard]}")

    def enqueue(self):
        """``step``, and a function ``read()`` that returns the dispatch's
        (D, ST_LEN) rows (lists), its phase block (or None) and its device
        ms (None off the graph), after it checks the copies
        (``check_copies``). On the graph: the launch between two timing
        events (several groups: each group's graph a round, on its stream,
        launched together, and the cross-group balance), the rows copied
        without blocking into the next pinned slot behind a third; ``read``
        waits for it and counts the shards' runs as their cycles'
        launches."""
        if not self.graphed:
            self.step()
            rows = self.st.tolist()
            copy_rows = (None if self.copy_st is None
                         else self.copy_st.tolist())
            ph = self.clk.tolist() if self.clk is not None else None

            def read_host():
                self.check_copies(copy_rows)
                return rows, ph, None
            return read_host
        if self.shared_cards and torch.autograd._profiler_enabled():
            raise RuntimeError(f"copies of shards {self.shared_cards} (shard, "
                               f"card): {COPIES_TRACED}")
        buf, start, end, done, clkbuf, copybuf = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        # The graphs (built at first use) before the timed launches. Each
        # group's graphs run the same cycles: its round-0 graph counts the
        # runs of all rounds (the rows' sums).
        if self.grouped:
            rounds = [[self.graph(i, r) for i in range(len(self.groups))]
                      for r in range(self.rounds)]
            graphs = list(zip(rounds[0], self.groups))
        else:
            graphs = [(self.graph(), self.groups[0])]
        start.record()
        if self.grouped:
            main = torch.cuda.current_stream(self.device)
            for r, launches in enumerate(rounds):
                for g in self.groups:
                    g.stream.wait_stream(main)
                for graph, g in zip(launches, self.groups):
                    with torch.cuda.stream(main), g.context():
                        graph.launch()
                for g in self.groups:
                    main.wait_stream(g.stream)
                self._balance_groups(r)
        else:
            graphs[0][0].launch()
        end.record()
        buf.copy_(self.st, non_blocking=True)
        if clkbuf is not None:
            clkbuf.copy_(self.clk, non_blocking=True)
        if copybuf is not None:
            copybuf.copy_(self.copy_st, non_blocking=True)
        done.record()

        def read():
            done.synchronize()
            ms = start.elapsed_time(end)
            self.dispatch_device_s += ms / 1e3
            rows = buf.tolist()
            self.check_copies(copybuf.tolist() if copybuf is not None
                              else None)
            for graph, g in graphs:
                graph.count([rows[d] for d in g.shards])
            return rows, (clkbuf.tolist() if clkbuf is not None else None), ms
        return read

    def _free(self) -> None:
        """The graphs, the groups' programs and the shards' tensors."""
        for g in self._graphs.values():
            g.close()
        self._graphs.clear()
        for g in self.groups:
            for p in {id(p): p for p in g.programs}.values():
                p.close()
        self.states = []


def loop_rows(rows: list) -> list:
    """State rows (lists) without the word ``ST_ACTIVE``: whether a
    shard's cycle ran in the last iteration of its group's ``while`` loop,
    which ends when the group's last shard stops, so two groups holding
    other shards beside a shard's copies may leave it apart (a gate sets
    it again before any cycle reads it). Every other word of a copy's row
    is its primary's and, at one copy a shard, the one-position
    program's."""
    return [row[:ST_ACTIVE] + row[ST_ACTIVE + 1:] for row in rows]


def _in_threads(fns: list) -> None:
    """Run each of ``fns`` in a host thread of its own and wait for all;
    raise the first error any of them raised (the copies of several groups
    on the CPU, whose plain exchanges wait for each other)."""
    errors: list = []  # list.append is atomic: the threads' only shared state

    def run(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,), daemon=True,
                                name=f"mesh-copies-{i}")
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


@contextmanager
def _streams(main, g: _Group):
    """On the card, group ``g``'s stream current on its device after it
    waits for ``main`` (a cross-group step's stream), and ``main`` waiting
    for it at the end (none off the card)."""
    if main is None:
        yield
        return
    g.stream.wait_stream(main)
    with torch.cuda.stream(main), g.context():
        yield
    main.wait_stream(g.stream)


def mp_grid(D: int, mp: int, G: int) -> list[list[int]]:
    """The (dp, mp) grid of a mesh over G device positions: replica (d, i)
    (shard d's pair block i) at position ``(d * mp + i) % G``, the JAX
    ``make_dp_mp_mesh`` layout (`resident_mesh.py:57-72`: ``devices[:D *
    mp].reshape(D, mp)``) where G >= D * mp, wrapped round a shorter list
    (the JAX tier refuses one)."""
    return [[(d * mp + i) % G for i in range(mp)] for d in range(D)]


def copy_layout(grid: list[list[int]]) -> list[list[tuple[int, list[int]]]]:
    """Each shard's copies from its ``mp_grid`` row: one ``(position,
    pair blocks)`` a distinct position of the row, in the order of their
    first block (copy 0, the primary, at replica (d, 0)'s position), each
    with the blocks i whose replica (d, i) sits there."""
    out = []
    for row in grid:
        where: dict[int, list[int]] = {}
        for i, p in enumerate(row):
            where.setdefault(p, []).append(i)
        out.append(list(where.items()))
    return out


#: Why copies of one shard on one card are refused under a trace.
COPIES_TRACED = (
    "two copies of a shard on one card exchange planes inside their "
    "groups' graphs, which needs the card to run those graphs at once: "
    "CUDA does not promise it, and under a torch.profiler trace their "
    "waits time out (ST_XERR); trace such a mesh with each shard's copies "
    "on distinct cards, or run it untraced")


def _card(position) -> str | None:
    """The card a device position names ("cuda" is card 0, the current one
    of a fresh process), None for the CPU; resolves nothing."""
    dev = torch.device(position)
    if dev.type != "cuda":
        return None
    return f"cuda:{dev.index or 0}"


def shared_card_copies(positions, D: int, mp: int) -> list[tuple[int, str]]:
    """The shards (and the card) two of whose copies land on one card, from
    the ``mp_grid`` and ``copy_layout`` of ``D`` shards over the device
    positions ``positions`` (strings or devices), resolving no device: the
    layout ``COPIES_TRACED`` refuses under a trace."""
    out = []
    for d, row in enumerate(copy_layout(mp_grid(D, mp, len(positions)))):
        cards = [_card(positions[p]) for p, _ in row]
        for card in sorted({c for c in cards if c is not None}):
            if cards.count(card) > 1:
                out.append((d, card))
    return out


def mesh_devices(devices, device) -> list[torch.device]:
    """The device positions of a mesh: ``devices`` (a list, whose entries
    may repeat a card: one group of shards each), else ``[device]``. A
    position naming a card that is not there raises."""
    if devices is None:
        return [resolve_device(device)]
    return resolve_devices(devices)


def offload_until_fits(program: MeshProgram, pool: SoAPool, offloader,
                       best: int, diagnostics: Diagnostics):
    """The saturation fallback (no shard ran a cycle and balancing moved
    nothing): download the shards' frontier into ``pool``, run host offload
    cycles (``offloader``, made at first use) until it fits the shards'
    headroom, and upload it again. Returns ``(tree, sol, best,
    offloader)``."""
    problem, D, m, M = program.problem, program.D, program.m, program.M
    pool.reset_from(program.full_batch())
    diagnostics.device_to_host += 1
    if offloader is None:
        offloader = DeviceOffloader(problem, program.device)
    chunk_buf = problem.empty_batch(M)
    fits = D * max(0, program.capacity - 2 * M * problem.child_slots)
    tree = sol = 0
    while pool.size >= m and pool.size > fits:
        count = pool.pop_back_bulk(m, M, chunk_buf)
        if count == 0:
            break
        parents, bounds = offloader.evaluate(chunk_buf, count, best)
        res = problem.generate_children(parents, count, bounds, best)
        tree += res.tree_inc
        sol += res.sol_inc
        best = res.best
        pool.push_back_bulk(res.children)
    program.upload(pool.as_batch(), best)
    pool.clear()
    diagnostics.host_to_device += 1
    return tree, sol, best, offloader


def mesh_key(D: int, m: int, M: int, K: int, rounds: int, T: int,
             capacity: int, device, fused: bool, staged: bool, mp: int = 1,
             devices=None, compact: str | None = None) -> tuple:
    """The cache key of a mesh program (`resident_mesh.py:479-485`, with the
    port's routing inputs): D, mp and the device positions in place of the
    mesh's device ids, then the resident program's key (``compact``: its
    shards' compaction mode, ``R.program_compact``)."""
    positions = tuple(str(d) for d in mesh_devices(devices, device))
    return (D, rounds, T, mp, positions) + R.program_key(
        m, M, K, capacity, positions[0], fused, staged, None,
        compact=compact)


def get_mesh_program(problem: Problem, D: int, m: int, M: int, K: int,
                     rounds: int, T: int, capacity: int, device=None,
                     fused: bool = True, staged: bool = True, mp: int = 1,
                     devices=None) -> MeshProgram:
    """The mesh program of ``problem`` for a search, held by the caller
    until ``release()``: cached on ``problem._mesh_programs`` under
    ``mesh_key`` (an uncached one when another search holds it), its K set
    back to ``K``."""
    prog = R.take_cached(
        problem, "_mesh_programs",
        mesh_key(D, m, M, K, rounds, T, capacity, device, fused, staged, mp,
                 devices, compact=R.program_compact(problem, M, fused, mp)),
        lambda: MeshProgram(problem, D, m, M, K, rounds, T, capacity, device,
                            fused=fused, staged=staged, mp=mp,
                            devices=devices))
    prog.use_k(K)
    return prog


def mesh_resident_search(
    problem: Problem,
    m: int = 25,
    M: int = 16384,
    K: int | str = 16,
    rounds: int = 2,
    T: int | None = None,
    capacity: int | None = None,
    devices=None,
    device=None,
    D: int | None = None,
    mp: int = 1,
    initial_best: int | None = None,
    warmup_target: int | None = None,
    fused: bool = True,
    staged: bool = True,
    max_steps: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_interval_s: float = 60.0,
    resume_from: str | None = None,
    yield_fn=None,
    guard: bool | None = None,
) -> SearchResult:
    """The mesh-resident tier (``--tier mesh``; the JAX signature less the
    mesh object, which the port has not): D
    shards (default: the number of ``devices`` over mp, else 1) of a pool
    of ``capacity`` rows each, placed on the positions of ``devices`` (a
    list whose entries may repeat a card; default ``[device]``, ``cuda``
    by default, ``"cpu"`` for the plain path) as ``MeshProgram`` says,
    chunks of up to M parents a shard cycle, up to K cycles a shard and
    round, ``rounds`` balance rounds a dispatch with gifts of up to T nodes
    (default ``max(2m, min(M, 8192))``). ``mp`` > 1 (PFSP lb2 only) splits
    the lb2 Johnson pair loop in mp pair blocks and runs the unfused cycle
    (`resident_mesh.py:90-131`). ``fused=False`` (and lb1_d, and mp > 1) runs the unfused cycles,
    staged under lb2 unless ``staged=False``. ``guard`` (else
    ``TTS_GUARD=1``) arms the steady-state guard (`analysis/guard.py`) on
    each K rung's dispatches after its first."""
    if mp < 1:
        raise ValueError(f"mp must be >= 1, got {mp}")
    if mp > 1 and getattr(problem, "lb", None) != "lb2":
        raise ValueError(R.MP_LB2_ONLY)
    positions = mesh_devices(devices, device)
    dev = positions[0]
    if D is None:
        D = max(1, len(devices) // mp) if devices is not None else 1
    if D < 1:
        raise ValueError(f"D must be >= 1, got {D}")
    n = problem.child_slots
    capacity, M = R.resolve_capacity(problem, M, capacity)
    if T is None:
        T = max(2 * m, min(M, 8192))
    best = (initial_best if initial_best is not None
            else getattr(problem, "initial_ub", INF_BOUND))
    pool = SoAPool(problem.node_fields())
    diagnostics = Diagnostics()
    problem._native()  # a first call builds it: outside the timed phases
    phases: list[PhaseStats] = []
    t0 = time.perf_counter()

    # -- phase 1: host warm-up to D*m, or the checkpoint ------------------------
    if resume_from is not None:
        saved = ckpt.load(resume_from, problem)
        pool.push_back_bulk(saved.batch)
        tree1, sol1 = saved.tree, saved.sol
        best = min(best, saved.best)
        # The frontier re-partitions stride-D: room for the largest share
        # and one fan-out, whatever D the cut ran with.
        capacity = max(capacity, -(-pool.size // D) + 2 * M * n)
    else:
        pool.push_back(index_batch(problem.root(), 0))
        target = D * m if warmup_target is None else warmup_target
        tree1, sol1, best = warmup(problem, pool, best, target)
    t1 = time.perf_counter()
    phases.append(PhaseStats(t1 - t0, tree1, sol1))
    ev.counter("explored", tree=tree1, sol=sol1, phase=1)

    # -- phase 2: the shards' resident loop -------------------------------------
    k_auto, k_value = resolve_k(K, default_max=16)
    # The balance rounds ride each dispatch, so the ladder aims at a
    # shorter host period than the single-device tier's.
    band, band_src = resolve_target_band("mesh", MESH_TARGET, problem,
                                         topology=f"mesh-D{D}", device=dev)
    ctl = AdaptiveK(k_value, target=band) if k_auto else None
    depth = resolve_pipeline_depth()
    program = get_mesh_program(problem, D, m, M, ctl.K if ctl else k_value,
                               rounds, T, capacity, dev, fused=fused,
                               staged=staged, mp=mp, devices=positions)
    build0 = program.graph_build_s
    device0 = program.dispatch_device_s
    program.host_slots(depth)
    program.upload(pool.as_batch(), best)
    pool.clear()
    diagnostics.host_to_device += 1

    tree2 = sol2 = 0
    per_worker = np.zeros(D, dtype=np.int64)
    sizes = [0] * D
    prev_sizes = None
    offloader = None
    ctr_total: dict | None = None
    ph_total: dict | None = None
    fb_tree = fb_sol = 0
    dispatches = stalls = 0
    prev_best = best
    qt = obs_quality.tracker(problem)
    queue = DispatchQueue(depth)
    complete = True

    def obs_result() -> dict | None:
        parts = {}
        if ctr_total is not None:
            parts["device_counters"] = ctr_total
        if ph_total is not None:
            parts["device_phases"] = ph_total
        return parts or None

    guards = RungGuards(program, "mesh step", guard)

    def enqueue() -> None:
        with guards.of().step():
            read = program.enqueue()
        queue.push(read, ev.now_us())

    def consume(read, t_enq: float) -> int:
        nonlocal tree2, sol2, sizes, best, ctr_total, ph_total, prev_best
        nonlocal dispatches
        t_wait = ev.now_us()
        rows, ph, ms = read()
        tree_vec = [r[2] for r in rows]
        ti, si = sum(tree_vec), sum(r[3] for r in rows)
        cy = sum(r[ST_CYCLES] for r in rows)
        sizes = [r[0] for r in rows]
        best = min(r[1] for r in rows)
        tree2 += ti
        sol2 += si
        dispatches += 1
        per_worker[:] += np.asarray(tree_vec, dtype=np.int64)
        diagnostics.kernel_launches += cy
        if program.obs:
            ctr = [r[ST_CTR:ST_CTR + obs_counters.NSLOTS] for r in rows]
            ctr_total = obs_counters.merge_host(ctr_total, ctr)
        if ph is not None:
            ph_total = obs_phases.merge_host(ph_total, ph)
        fr.heartbeat("mesh", seq=dispatches, cycles=cy, size=sum(sizes),
                     best=best, tree=tree2, sol=sol2, depth=depth,
                     K=program.K, inflight=len(queue), phases=ph_total)
        if qt is not None:
            qt.observe(best, dispatches, tree1 + tree2)
        if ev.enabled():
            now = ev.now_us()
            ev.emit("dispatch", ph="X", ts=t_enq,
                    dur=max(0.0, now - t_enq), args={
                        "cycles": cy, "tree": ti, "sol": si,
                        "size": sum(sizes), "best": best,
                        "shard_sizes": list(sizes),
                        "enqueue_us": t_enq, "read_wait_us": now - t_wait,
                        "pipeline_depth": depth, "device_ms": ms,
                    })
            if program.obs:
                ev.counter("device_counters", **obs_counters.as_args(ctr))
            if ph is not None:
                ev.counter("device_phases", **obs_phases.as_args(ph))
            if best < prev_best:
                ev.emit("incumbent", args={"best": best})
        prev_best = best
        return cy

    def drain_queue() -> tuple[int, int]:
        tree0, sol0 = tree2, sol2
        for read, t_enq in queue.drain():
            consume(read, t_enq)
        return tree2 - tree0, sol2 - sol0

    def snapshot_fn():
        batch = program.full_batch()
        diagnostics.device_to_host += 1
        return batch, best

    controller = ckpt.RunController(
        problem, checkpoint_path, checkpoint_interval_s, max_steps,
        snapshot_fn, drain_fn=drain_queue, yield_fn=yield_fn)

    fr.arm("mesh")
    ev.emit("pipeline", args={"depth": depth, "K": program.K,
                              "k_auto": k_auto, "tier": "mesh"})
    if band_src is not None:
        ev.emit("costmodel", args={
            "source": band_src, "lo_ms": round(1e3 * band[0], 1),
            "hi_ms": round(1e3 * band[1], 1), "tier": "mesh"})
    try:
        last_ready = time.monotonic()
        while True:
            while not queue.full:
                enqueue()
            read, t_enq = queue.pop()
            cy = consume(read, t_enq)
            now = time.monotonic()
            period, last_ready = now - last_ready, now
            if max(sizes) < m:
                drain_queue()  # speculative no-ops; the state passes through
                break
            if controller.after_step(tree1 + tree2, sol1 + sol2):
                drain_queue()
                complete = False
                ev.emit("checkpoint", args={"cutoff": True})
                break
            if ctl is not None and cy > 0 and ctl.observe(period, cy):
                drain_queue()
                program.use_k(ctl.K)
                ev.emit("k_resize", args={"K": program.K})
                last_ready = time.monotonic()
                prev_sizes = None
                if max(sizes) < m:
                    break
                continue
            if cy == 0 and prev_sizes == sizes:
                # Saturation: no shard ran a cycle and balancing moved
                # nothing. Host offload cycles until the frontier fits.
                drain_queue()  # saturated speculative dispatches: no-ops
                t_fb = ev.now_us()
                stalls += 1
                ti, si, best, offloader = offload_until_fits(
                    program, pool, offloader, best, diagnostics)
                guards.of().rearm()  # the re-upload: a warm dispatch next
                tree2 += ti
                sol2 += si
                last_ready = time.monotonic()
                fb_tree += ti
                fb_sol += si
                ev.complete("overflow_fallback", t_fb,
                            args={"tree": ti, "sol": si})
                prev_sizes = None
                continue
            prev_sizes = sizes
        if complete:
            batch = program.full_batch()
            diagnostics.device_to_host += 1
    finally:
        if dev.type == "cuda":
            for g in program.groups:
                if g.stream is not None:
                    g.stream.synchronize()
            torch.cuda.current_stream(dev).synchronize()
        program.release()
    if offloader is not None:
        diagnostics.kernel_launches += offloader.diagnostics.kernel_launches
        diagnostics.host_to_device += offloader.diagnostics.host_to_device
        diagnostics.device_to_host += offloader.diagnostics.device_to_host
    t2 = time.perf_counter()
    phases.append(PhaseStats(t2 - t1, tree2, sol2))
    R._emit_device_explored(ctr_total, tree2, sol2, fb_tree, fb_sol)

    # -- phase 3: host drain (none after a cut) -----------------------------------
    tree3 = sol3 = 0
    if complete:
        pool.reset_from(batch)
        tree3, sol3, best = drain(problem, pool, best)
        phases.append(PhaseStats(time.perf_counter() - t2, tree3, sol3))
        ev.counter("explored", tree=tree3, sol=sol3, phase=3)
        if qt is not None:
            qt.observe(best, dispatches, tree1 + tree2 + tree3)

    inner = program.inner
    return SearchResult(
        explored_tree=tree1 + tree2 + tree3,
        explored_sol=sol1 + sol2 + sol3,
        best=best,
        elapsed=time.perf_counter() - t0,
        phases=phases,
        diagnostics=diagnostics,
        complete=complete,
        steps=controller.steps,
        engine="mesh",
        compact=inner.compact,
        compact_auto=auto_chosen(inner.compact),
        fused=inner.fused,
        staged=inner.staged,
        megakernel_mt=inner.mt,
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
        quality=qt.result() if qt is not None else None,
        per_worker_tree=per_worker.tolist(),
        guard=guards.record(),
        mp=program.mp,
    )


# -- program contracts (`check`, analysis/contracts.py) ------------------------

from ..analysis.contracts import contract  # noqa: E402

#: The exchange's kernels, once each in a copy's gated body.
_XCHG_KERNELS = ("xchg_post", "xchg_wait", "xchg_max")


@contract(
    "mesh-copies-device-only",
    claim="under --mp over several positions the copies' dispatch graphs "
          "hold no host node and no memcpy with a host end, in any body "
          "they nest (a copy waits for its peers on the device only), and "
          "each copy's gated cycle body runs the pair exchange's post, wait "
          "and max once each",
    artifact="mesh-copies",
)
def _contract_mesh_copies(art, cell):
    out = []
    for label, nodes in art["nodes"].items():
        host = [name for name, kind in nodes
                if kind in ("host", "memcpy_host")]
        if host:
            out.append(f"{label}: host nodes {host}")
        if ".gate" in label:
            got = [sum(k in name for name, _ in nodes) for k in _XCHG_KERNELS]
            if got != [1, 1, 1]:
                out.append(f"{label}: exchange kernels {dict(zip(_XCHG_KERNELS, got))}"
                           ", want one each")
    return out
