"""Mesh-resident search: the device-resident engine over D pool shards — the
port of `tpu_tree_search/parallel/resident_mesh.py`.

The JAX tier runs one SPMD program over a mesh of D devices: each device
holds a pool shard and runs the resident chunk loop on it, and after each
of a dispatch's rounds the shards' incumbents fold with ``lax.pmin`` and
one round of ring diffusion moves the front of a shard that can spare
nodes (>= 2m) to a starving right neighbour (< m), from an ``all_gather``
of the sizes. The host stops when every shard holds fewer than m nodes
and drains the residual, as the single-device tier's phase 3.

Here the D shards sit on one card (the port's counterpart of the JAX
tests' eight virtual CPU devices; `ROADMAP.md` C), as one program
(``MeshProgram``): one (D, ST_LEN) state tensor, a (D, C, n) pool and a
(D, C) column, and one CUDA graph a dispatch (`ops/mesh.py` ``MeshGraph``):
for each of ``rounds`` rounds, ``batch_init``, a ``while`` node over the
shards' fused cycles (kernels 2, 4 or 8; a shard whose condition fails is
frozen) and the balance step (``mesh_balance``, `csrc/mesh_balance.cu`).
Inside a JAX round the shards do not interact, so each shard runs the
cycles of its own ``lax.while_loop``, and the counts, the incumbent and
every shard's live rows are the JAX program's. Under lb1_d or
``fused=False`` the cycles are the unfused ones, driven from the host,
then the same balance kernel. Off the card (``device="cpu"``) the same
program runs the plain cycles shard by shard and ``mesh_balance_plain``:
the oracle of the tests.

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

import time

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
from ..ops.backend import resolve_device
from ..ops.cycle import ST_CTR, ST_CYCLES, ST_LEN, ST_RUNS
from ..ops.dispatch import (
    batch_cond_plain,
    batch_init_plain,
    loop_active,
    phase_mark,
)
from ..ops.mesh import MeshGraph, MeshScratch, mesh_balance
from ..pool.pool import SoAPool
from ..problems.base import INF_BOUND, Problem, index_batch


class MeshProgram(R.CachedProgram):
    """D shards of one resident program (`resident_mesh.py`
    ``_MeshResidentProgram``): ``inner`` is an uncached resident program of
    the same configuration, whose cycle, scratch and field layout serve
    every shard (their cycles run one after another on one stream). K is
    capped so that a dispatch's ``rounds * K`` cycles keep the int32
    counters in range (`resident_mesh.py:110`)."""

    cache_attr = "_mesh_programs"

    def __init__(self, problem: Problem, D: int, m: int, M: int, K: int,
                 rounds: int, T: int, capacity: int, device,
                 fused: bool = True, staged: bool = True):
        if D < 1:
            raise ValueError(f"D must be >= 1, got {D}")
        self.problem = problem
        self.D = int(D)
        self.m = m
        self.M = M
        self.rounds = max(1, int(rounds))
        self.T = int(T)
        self.capacity = capacity
        self.inner = R.new_program(problem, m, M, K, capacity, device,
                                   fused=fused, staged=staged)
        inner = self.inner
        self.device = inner.device
        self.obs = inner.obs
        self.clk = inner.clk
        self.graphed = inner.graphed
        self.use_k(K)
        width = problem.child_slots
        self.st = torch.zeros((self.D, ST_LEN), dtype=torch.int32,
                              device=self.device)
        self.pool_vals = torch.zeros((self.D, capacity, width),
                                     dtype=inner.vals_dtype,
                                     device=self.device)
        self.pool_aux = torch.zeros((self.D, capacity), dtype=inner.aux_dtype,
                                    device=self.device)
        self.states = [R.ResidentState(self.pool_vals[d], self.pool_aux[d],
                                       self.st[d]) for d in range(self.D)]
        cuda = self.device.type == "cuda"
        self.scratch = (MeshScratch.make(self.pool_vals, self.pool_aux)
                        if cuda else None)
        self._graphs: dict[tuple, MeshGraph] = {}
        self.graph_build_s = 0.0
        self.dispatch_device_s = 0.0 if self.graphed else None
        self._slots: list[tuple] = []
        self._next_slot = 0

    @property
    def Mn(self) -> int:
        return self.M * self.problem.child_slots

    def use_k(self, K: int) -> None:
        """K clamped so that rounds * K cycles of M*n children fit int32;
        the inner program's cycles take the same K."""
        self.K = max(1, min(K, (2**31 - 1) // max(1, self.Mn * self.rounds)))
        self.inner.K = self.K

    # -- the shards' frontiers ----------------------------------------------

    def upload(self, frontier: dict, best: int) -> None:
        """The static stride-D partition of ``frontier``
        (`nqueens_multigpu_chpl.chpl:221-225`): shard d gets nodes d::D,
        copied into its existing tensors (the graphs stay valid), with
        incumbent ``best`` and zeroed counts."""
        for d, state in enumerate(self.states):
            self.inner.load_state(
                state, {k: v[d::self.D] for k, v in frontier.items()}, best)

    def full_batch(self) -> dict:
        """Every live node of every shard, shard by shard (the residual,
        the checkpoint snapshot and the saturation fallback's download),
        ordered after the dispatches enqueued on the current stream."""
        p = self.problem
        fields = p.node_fields()
        sizes = self.st[:, 0].tolist()
        parts_v = [self.pool_vals[d, :sizes[d]] for d in range(self.D)]
        parts_a = [self.pool_aux[d, :sizes[d]] for d in range(self.D)]
        batch = {
            p.vals_field: torch.cat(parts_v).cpu().numpy().astype(
                fields[p.vals_field][1]),
            p.aux_field: torch.cat(parts_a).cpu().numpy().astype(
                fields[p.aux_field][1]),
        }
        return self.inner.derive_fields(batch)

    # -- dispatch -----------------------------------------------------------

    def host_slots(self, depth: int) -> None:
        """One pinned (D, ST_LEN) buffer and its events for each of
        ``depth`` dispatches in flight (the graph's lagged reads)."""
        if self.graphed and len(self._slots) != max(1, depth):
            self._slots = [
                (torch.empty((self.D, ST_LEN), dtype=torch.int32,
                             pin_memory=True),
                 torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True), torch.cuda.Event(),
                 None if self.clk is None else torch.empty(
                     self.clk.numel(), dtype=torch.int64, pin_memory=True))
                for _ in range(max(1, depth))]
            self._next_slot = 0

    def balance(self, r: int) -> None:
        """Round r's balance step (the kernel on the card)."""
        mesh_balance(self.st, self.pool_vals, self.pool_aux, self.scratch,
                     self.m, self.T, self.Mn, r == 0, r == self.rounds - 1)

    def graph(self) -> MeshGraph:
        """The mesh dispatch graph at the current K over the program's
        tensors (which it keeps for its life), built at first use."""
        key = (self.K, self.st.data_ptr(), self.pool_vals.data_ptr(),
               self.pool_aux.data_ptr())
        g = self._graphs.get(key)
        if g is None:
            n = self.problem.child_slots
            inner = self.inner
            g = MeshGraph([lambda s=s: inner._fused_cycle(s)
                           for s in self.states], self.balance, self.st,
                          self.m, self.Mn, self.capacity, self.K,
                          self.rounds, obs=n if self.obs else 0,
                          clk=self.clk)
            self.graph_build_s += g.build_s
            self._graphs[key] = g
        return g

    def step(self) -> None:
        """One dispatch on the host's loop: ``rounds`` times, the shards'
        cycles until every shard's condition fails, then the balance step.
        The fused cycles are the plain ones (CPU); the unfused ones run on
        either device, the balance then on the kernel on the card."""
        inner = self.inner
        n = self.problem.child_slots
        Mn, C, K, m = self.Mn, self.capacity, self.K, self.m
        P = obs_phases.IDX
        if self.clk is not None:
            phase_mark(self.clk, 0, obs_phases.SEED)
        for r in range(self.rounds):
            live = batch_init_plain(self.st, m, Mn, C, K, self.obs and r == 0)
            if inner.fused:
                for _ in range(K):
                    if not live:
                        break
                    for s in self.states:
                        inner._fused_cycle(s)
                    live = batch_cond_plain(self.st, n if self.obs else 0, m,
                                            Mn, C, K)
            else:
                self._unfused_round()
            if self.clk is not None:
                phase_mark(self.clk, P["loop"])
            self.balance(r)
            if self.clk is not None:
                phase_mark(self.clk, P["balance"])

    def _unfused_round(self) -> None:
        """One round of unfused cycles (the batched engine's host rounds):
        each live shard one cycle at a time until none is live; the
        condition node's runs counted in row 0's cond word by the balance
        step from the shards' runs."""
        Mn, C, K, m = self.Mn, self.capacity, self.K, self.m
        rows = self.st.tolist()
        while True:
            live = [i for i, v in enumerate(rows)
                    if loop_active(v, m, Mn, C, K)]
            if not live:
                return
            for i in live:
                self.inner._unfused_cycles(self.states[i], 1)
                self.st[i, ST_RUNS] += 1
            rows = self.st.tolist()

    def enqueue(self):
        """``step``, and a function ``read()`` that returns the dispatch's
        (D, ST_LEN) rows (lists), its phase block (or None) and its device
        ms (None off the graph). On the graph: the launch between two
        timing events, the rows copied without blocking into the next
        pinned slot behind a third; ``read`` waits for it and counts the
        shards' runs as their cycles' launches."""
        if not self.graphed:
            self.step()
            rows = self.st.tolist()
            ph = self.clk.tolist() if self.clk is not None else None
            return lambda: (rows, ph, None)
        buf, start, end, done, clkbuf = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        g = self.graph()
        start.record()
        g.launch()
        end.record()
        buf.copy_(self.st, non_blocking=True)
        if clkbuf is not None:
            clkbuf.copy_(self.clk, non_blocking=True)
        done.record()

        def read():
            done.synchronize()
            ms = start.elapsed_time(end)
            self.dispatch_device_s += ms / 1e3
            rows = buf.tolist()
            g.count(rows)
            return rows, (clkbuf.tolist() if clkbuf is not None else None), ms
        return read

    def _free(self) -> None:
        """The graphs, the inner program and the shards' tensors."""
        for g in self._graphs.values():
            g.close()
        self._graphs.clear()
        self.inner.close()
        self.states = []


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
             capacity: int, device, fused: bool, staged: bool) -> tuple:
    """The cache key of a mesh program (`resident_mesh.py:479-485`, with the
    port's routing inputs): D and the device in place of the mesh's device
    ids, then the resident program's key."""
    return (D, rounds, T) + R.program_key(m, M, K, capacity, device, fused,
                                          staged, None)


def get_mesh_program(problem: Problem, D: int, m: int, M: int, K: int,
                     rounds: int, T: int, capacity: int, device=None,
                     fused: bool = True, staged: bool = True) -> MeshProgram:
    """The mesh program of ``problem`` for a search, held by the caller
    until ``release()``: cached on ``problem._mesh_programs`` under
    ``mesh_key`` (an uncached one when another search holds it), its K set
    back to ``K``."""
    dev = resolve_device(device)
    prog = R.take_cached(
        problem, "_mesh_programs",
        mesh_key(D, m, M, K, rounds, T, capacity, dev, fused, staged),
        lambda: MeshProgram(problem, D, m, M, K, rounds, T, capacity, dev,
                            fused=fused, staged=staged))
    prog.use_k(K)
    return prog


def _shard_device(devices, device) -> torch.device:
    """The one device the D shards sit on. Shards across cards (``devices``
    naming more than one) are ROADMAP.md A.9's second half."""
    if devices is not None:
        devs = {resolve_device(d) for d in devices}
        if len(devs) > 1:
            raise NotImplementedError(
                "mesh shards on more than one card are not ported yet "
                "(ROADMAP.md queue A, A.9's second half); the port places "
                "every shard on one device")
        return devs.pop()
    return resolve_device(device)


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
    mesh object and ``mp``): D shards (default: the number of
    ``devices``, else 1) of a pool of ``capacity`` rows each on ``device``
    (``cuda`` by default; ``"cpu"`` for the plain path), chunks of up to M
    parents a shard cycle, up to K cycles a shard and round, ``rounds``
    balance rounds a dispatch with gifts of up to T nodes (default
    ``max(2m, min(M, 8192))``). ``fused=False`` (and lb1_d) runs the
    unfused cycles, staged under lb2 unless ``staged=False``. ``guard``
    (else ``TTS_GUARD=1``) arms the steady-state guard (`analysis/
    guard.py`) on each K rung's dispatches after its first."""
    dev = _shard_device(devices, device)
    if D is None:
        D = len(devices) if devices is not None else 1
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
                               staged=staged)
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
    )
