"""Batch executor: instance-axis batched execution for the serve daemon
(`tpu_tree_search/serve/batch.py`).

One `BatchExecutor` exists per (shape class, pins) pair, owned by the
scheduler and run on whatever worker thread pops a batchable job.  It
drives a B-slot `engine/batched.py` program (one CUDA graph a dispatch on
the card, built once): every queued same-class job
becomes a slot, one K-cycle dispatch advances all live slots, and the
per-job slice semantics of `Scheduler._run_slice` are reproduced at the
slot level —

  * admission (fresh warm-up, or checkpoint restore into the slot) and
    retirement (residual drain on finish, snapshot-to-``.ckpt.npz`` on
    any cut) happen only at dispatch boundaries;
  * each slot keeps its own quantum clock (started at admission, the
    lease is already held), cumulative ``max_steps`` budget, cancel
    flag, flight recorder, quality recorder and event job-context, so a
    tenant observes exactly the artifacts a solo run would produce;
  * a quantum/cancel/drain cut removes ONE slot — the batch keeps
    running for the others — and free slots are refilled from the
    front-contiguous same-class run of the queue (a different-class
    waiter progressively empties the batch instead of starving).

Bit-identity with solo execution holds per slot because the batched
program masks frozen slots (engine/batched.py): a slot executes exactly
the cycle sequence its solo program would.  Two deliberate divergences:
a capacity-stalled slot is requeued with a solo-only flag (the solo
engine's host-offload fallback needs a growable pool), and a resumed
job whose saved frontier no longer fits a fixed slot falls back to solo
the same way.

Under ``TTS_GUARD=1`` each dispatch's enqueue runs under the batched
program's steady-state guard (`analysis/guard.py`), one a program, kept
across sessions: a warm class's second session builds nothing, so its
first dispatch is checked too.

Threading: the executor runs entirely on one worker thread and takes NO
locks of its own — `occupied` is a plain int published for metrics, and
all queue/registry access goes through the scheduler's existing methods.
The batched program is cached on the class's problem and held for a
session (``make_batched_program`` / ``release``), so a second session
builds nothing.
"""

from __future__ import annotations

import os
import time
import weakref

from ..analysis.guard import SteadyStateGuard, guard_enabled, guard_record
from ..engine import checkpoint as ckpt_mod
from ..engine.results import Diagnostics, SearchResult
from ..obs import counters as obs_counters
from ..obs import events as ev
from ..obs import flightrec
from ..obs import quality as obs_quality
from ..pool import SoAPool
from ..problems.base import INF_BOUND, index_batch
from . import pool as pool_mod
from .jobs import result_record


class _Slot:
    """Host-side bookkeeping for one occupied batch slot."""

    __slots__ = ("job", "budget", "tree", "sol", "slice_steps", "n_disp",
                 "ctr", "prev_best", "t_start", "t0", "cycles")

    def __init__(self, job):
        self.job = job
        self.budget = job.spec.get("max_steps")
        self.tree = 0
        self.sol = 0
        self.slice_steps = 0  # counted dispatches this batch session
        self.n_disp = 0  # dispatch seq (heartbeat/quality x-axis)
        self.ctr = None  # harvested device-counter totals
        self.cycles = 0  # the slot's device cycles this session
        self.prev_best = INF_BOUND
        self.t_start = time.monotonic()  # run_seconds clock
        self.t0 = time.monotonic()  # quantum clock


class BatchExecutor:
    """B-slot batched runner for one (class_key, pins) shape class."""

    def __init__(self, scheduler, class_key: str, pins: dict, B: int):
        self.sched = scheduler
        self.class_key = class_key
        self.pins = dict(pins)
        self.B = int(B)
        self.occupied = 0  # published for batch_stats; GIL-atomic int
        # The steady-state guard of each batched program (warm once).
        self._guards: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._guard: SteadyStateGuard | None = None  # the session's

    # -- metrics shorthands -------------------------------------------

    def _inc(self, name, labels=None, v=1):
        self.sched._inc(name, labels, v)

    def _observe(self, name, value, labels=None):
        self.sched._observe(name, value, labels)

    # -- session ------------------------------------------------------

    def run(self, job0, wid: int) -> None:
        """Run one batch session starting from `job0` (already popped off
        the queue by the worker). Returns when every slot has retired."""
        sched = self.sched
        if job0.cancel_requested:
            sched.registry.transition_if(job0, ("queued", "requeued"),
                                         "cancelled")
            return
        entry = sched.pool.admit(job0.spec)
        problem = entry.problem
        self._mark = pool_mod.compile_stats(problem)
        spec = job0.spec

        from ..engine.pipeline import resolve_k
        from ..engine.resident import resolve_capacity

        _auto, k_value = resolve_k(spec.get("K") or 4096, default_max=4096)
        sched.lease.acquire(self.pins)
        try:
            self._session(job0, entry, problem, spec, k_value,
                          resolve_capacity)
        finally:
            self.occupied = 0
            sched.lease.release()

    def _fail_slots(self, slots, e) -> None:
        """An unexpected executor error must not leak spliced jobs in
        'running' — the worker's own wrap only knows the popped job."""
        for sl in slots:
            if sl is not None:
                self.sched.registry.transition_if(
                    sl.job, ("running",), "failed",
                    error=f"{type(e).__name__}: {e}")

    def _session(self, job0, entry, problem, spec, k_value,
                 resolve_capacity) -> None:
        import torch

        from ..engine.batched import make_batched_program

        B = self.B
        dev = self.sched.device
        capacity, M = resolve_capacity(problem, spec["M"], None)
        prog = make_batched_program(problem, B, spec["m"], M, k_value,
                                    capacity, dev)
        guard = self._guards.get(prog)
        if guard is None:
            guard = self._guards[prog] = SteadyStateGuard(
                prog, f"batched[{self.class_key}]", enabled=guard_enabled())
        self._guard = guard
        try:
            slots: list[_Slot | None] = [None] * B
            for i in range(B):
                prog.empty_slot(i)
            ctx = dict(entry=entry, problem=problem, prog=prog, slots=slots,
                       capacity=capacity, M=M)

            # job0 may fall back (cancel race / solo-only resume) — the
            # session still picks up any already-queued peers below.
            self._admit(0, job0, ctx)
            first_job = slots[0].job if slots[0] is not None else None
            try:
                self._drive(ctx, first_job)
            except Exception as e:  # noqa: BLE001 — see _fail_slots
                self._fail_slots(slots, e)
                raise
        finally:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            prog.release()

    def _drive(self, ctx, first_job) -> None:
        sched = self.sched
        B = self.B
        prog, slots = ctx["prog"], ctx["slots"]
        problem = ctx["problem"]
        first = True
        while True:
            if not sched._stop_requested():
                free = [i for i in range(B) if slots[i] is None]
                if free:
                    for job in sched.take_same_class_front(
                            self.class_key, self.pins, len(free)):
                        i = free.pop(0)
                        if not self._admit(i, job, ctx):
                            free.insert(0, i)
                        elif first_job is None:
                            first_job = job
            occupied = [i for i in range(B) if slots[i] is not None]
            self.occupied = len(occupied)
            if not occupied:
                return
            self._observe("tts_serve_batch_efficiency",
                          len(occupied) / B, {"cls": self.class_key})
            t_enq = ev.now_us()
            with self._guard.step():
                read = prog.enqueue()
            out = read()
            if first:
                # The first dispatch builds the batched program's graph
                # (cold pool): that cost belongs to the job that triggered
                # the session, mirroring the solo path's per-slice delta.
                first = False
                if first_job is not None:
                    self._credit_compiles(first_job, problem)
            for i in occupied:
                self._boundary(i, ctx, out, t_enq)

    # -- admission ----------------------------------------------------

    def _admit(self, i: int, job, ctx) -> bool:
        """Splice `job` into slot `i`. Returns False when a racing cancel
        won or the job must run solo (saved frontier exceeds the fixed
        slot capacity); the slot stays free either way."""
        sched = self.sched
        problem, prog = ctx["problem"], ctx["prog"]
        if job.cancel_requested:
            sched.registry.transition_if(job, ("queued", "requeued"),
                                         "cancelled")
            return False
        saved = None
        if job.checkpoint:
            try:
                saved = ckpt_mod.load(job.checkpoint, problem)
            except Exception as e:  # noqa: BLE001 — a bad ckpt fails the
                sched.registry.transition_if(  # job, not the batch
                    job, ("queued", "requeued"), "failed",
                    error=f"{type(e).__name__}: {e}")
                return False
            n = problem.child_slots
            rows = int(saved.batch[problem.vals_field].shape[0])
            if rows + 2 * prog.M * n > ctx["capacity"]:
                # Fixed slot capacity can't hold the saved frontier; the
                # solo engine grows its pool on resume — send it there.
                job._solo_only = True
                self._requeue_back(job)
                return False
        if not sched.registry.transition_if(job, ("queued", "requeued"),
                                            "running",
                                            slices=job.slices + 1):
            return False
        if job.slices == 1:
            self._observe("tts_serve_queue_wait_seconds",
                          max(0.0, (job.started or time.time())
                              - job.submitted),
                          {"cls": job.class_key})
        if job.recorder is None:
            job.recorder = flightrec.FlightRecorder(
                always_on=True, snapshot_period_us=50_000.0)
            with job.recorder._lock:
                job.recorder._meta.update(job=job.id, cls=job.class_key)
        if job.quality is None:
            job.quality = obs_quality.QualityRecorder()
        job.quality.step_offset = job.steps
        sl = _Slot(job)
        if saved is not None:
            best = min(getattr(problem, "initial_ub", INF_BOUND),
                       int(saved.best))
            sl.tree, sl.sol = int(saved.tree), int(saved.sol)
            prog.make_slot(i, saved.batch, best)
        else:
            best = getattr(problem, "initial_ub", INF_BOUND)
            pool = SoAPool(problem.node_fields())
            pool.push_back(index_batch(problem.root(), 0))
            with flightrec.bound(job.recorder), \
                    ev.job_context(job.id):
                from ..engine.device import warmup

                sl.tree, sl.sol, best = warmup(problem, pool, best,
                                               job.spec["m"])
                ev.counter("explored", tree=sl.tree, sol=sl.sol, phase=1)
            prog.make_slot(i, pool.as_batch(), best)
        sl.prev_best = best
        ctx["slots"][i] = sl
        self._inc("tts_serve_slots_spliced_total", {"cls": self.class_key})
        return True

    def _requeue_back(self, job) -> None:
        """Return a popped job to the back of the queue (state preserved);
        under drain the queue is closed, so park it as requeued."""
        try:
            self.sched.submit(job)
        except RuntimeError:
            self._inc("tts_serve_requeues_total")
            self.sched.registry.transition_if(
                job, ("queued", "requeued", "running"), "requeued")

    # -- harvest + boundary actions -----------------------------------

    def _boundary(self, i: int, ctx, out, t_enq: float) -> None:
        """Per-slot post-dispatch bookkeeping and lifecycle decision, in
        the solo slice's order: finished -> budget -> cancel -> drain ->
        quantum -> capacity stall."""
        sched = self.sched
        prog, slots = ctx["prog"], ctx["slots"]
        sl = slots[i]
        job = sl.job
        tree_inc, sol_inc, cycles, size, best, ctr = out[i]
        sl.tree += tree_inc
        sl.sol += sol_inc
        sl.cycles += cycles
        sl.n_disp += 1
        if ctr is not None:
            sl.ctr = obs_counters.merge_host(sl.ctr, ctr)
        with flightrec.bound(job.recorder), ev.job_context(job.id):
            from ..obs import flightrec as fr

            fr.heartbeat("batched", seq=sl.n_disp, cycles=cycles,
                         size=size, best=best, tree=sl.tree, sol=sl.sol,
                         K=prog.K)
            if ev.enabled():
                now = ev.now_us()
                ev.emit("dispatch", ph="X", ts=t_enq,
                        dur=max(0.0, now - t_enq), args={
                            "cycles": cycles, "tree": tree_inc,
                            "sol": sol_inc, "size": size, "best": best,
                            "slot": i, "B": self.B,
                        })
                if ctr is not None:
                    ev.counter("device_counters",
                               **obs_counters.as_args(ctr))
                if best < sl.prev_best:
                    ev.emit("incumbent", args={"best": best})
        job.quality.observe(best, sl.n_disp, sl.tree)
        sl.prev_best = best

        if size < job.spec["m"]:
            self._retire_done(i, ctx, best)
            return
        # The dispatch ran with frontier work left: it counts against the
        # cumulative budget, exactly like the solo RunController (which
        # skips after_step only on the terminal dispatch).
        sl.slice_steps += 1
        if sl.budget is not None and job.steps + sl.slice_steps >= sl.budget:
            self._retire_budget(i, ctx, best)
            return
        if job.cancel_requested:
            self._cut(i, ctx, best, "cancelled")
        elif sched._stop_requested():
            self._cut(i, ctx, best, "requeued")
        elif (sched.ckpt_every_s is not None
              and time.monotonic() - sl.t0 >= sched.ckpt_every_s):
            # Periodic recoverability cut (--ckpt-every): same preemption
            # path as a quantum cut, so the slot's checkpoint + exact step
            # count land on disk for the fleet router to pull.
            self._cut(i, ctx, best, "preempted")
        elif (time.monotonic() - sl.t0 >= sched.quantum_s
              and sched._waiters()):
            self._cut(i, ctx, best, "preempted")
        elif cycles == 0:
            # Capacity stall: the slot's pool is too full for another
            # fan-out and a fixed slot can't grow — hand the job to the
            # solo path (host-offload fallback / bigger pool on resume).
            self._cut(i, ctx, best, "stall")

    # -- retirement ---------------------------------------------------

    def _credit_compiles(self, job, problem) -> None:
        """Attribute the program and graph deltas since the watermark to
        `job` and advance the watermark (steady state: delta is zero)."""
        mark = pool_mod.compile_stats(problem)
        d_prog, d_step = mark[0] - self._mark[0], mark[1] - self._mark[1]
        self._mark = mark
        if d_prog or d_step:
            self.sched.registry.update(
                job,
                new_programs=job.new_programs + d_prog,
                new_step_compiles=job.new_step_compiles + d_step)

    def _result(self, sl, best: int, complete: bool, prog) -> SearchResult:
        job = sl.job
        return SearchResult(
            explored_tree=sl.tree,
            explored_sol=sl.sol,
            best=best,
            elapsed=time.monotonic() - sl.t_start,
            complete=complete,
            steps=sl.slice_steps,
            diagnostics=Diagnostics(kernel_launches=sl.cycles),
            compact=prog.inner.compact,
            pipeline_depth=1,
            k_resolved=prog.K,
            k_auto=False,
            obs={"device_counters": sl.ctr} if sl.ctr is not None else None,
            quality=(job.quality.result()
                     if job.quality is not None and job.quality.points()
                     else None),
            guard=guard_record([self._guard]),
        )

    def _release_slot(self, i: int, ctx, job, problem) -> None:
        sched = self.sched
        sl = ctx["slots"][i]
        sched.registry.update(job, steps=job.steps + sl.slice_steps)
        self._credit_compiles(job, problem)
        sched.pool.mark_warm(ctx["entry"])
        self._observe("tts_serve_run_seconds",
                      time.monotonic() - sl.t_start,
                      {"cls": job.class_key})
        self._inc("tts_serve_slices_total", {"cls": job.class_key})
        self._inc("tts_serve_slots_retired_total", {"cls": self.class_key})
        ctx["slots"][i] = None

    def _retire_done(self, i: int, ctx, best: int) -> None:
        """Slot finished (frontier below m): residual download + host
        drain (solo phase 3), then the solo done path."""
        sched = self.sched
        prog, problem = ctx["prog"], ctx["problem"]
        sl = ctx["slots"][i]
        job = sl.job
        batch, size, best = prog.residual_slot(i)
        pool = SoAPool(problem.node_fields())
        if size:
            pool.reset_from(batch)
        with flightrec.bound(job.recorder), ev.job_context(job.id):
            from ..engine.device import drain

            tree3, sol3, best = drain(problem, pool, best)
            ev.counter("explored", tree=tree3, sol=sol3, phase=3)
        sl.tree += tree3
        sl.sol += sol3
        if best < sl.prev_best:
            job.quality.observe(best, sl.n_disp, sl.tree)
        res = self._result(sl, best, True, prog)
        self._release_slot(i, ctx, job, problem)
        ckpt = sched._checkpoint_path(job)
        for p in (ckpt, job.checkpoint):
            if p and os.path.exists(p):
                os.remove(p)
        # One update: a reader never sees "done" beside a removed cut.
        sched.registry.transition(job, "done", result=result_record(res),
                                  checkpoint=None)
        # The retired slot stays frozen (size < m fails its condition)
        # until the next splice loads it.

    def _retire_budget(self, i: int, ctx, best: int) -> None:
        """Cumulative max_steps exhausted: the job 'completes' at its
        cutoff by design (solo done-at-budget path, checkpoints
        removed)."""
        sched = self.sched
        prog, problem = ctx["prog"], ctx["problem"]
        sl = ctx["slots"][i]
        job = sl.job
        res = self._result(sl, best, False, prog)
        self._release_slot(i, ctx, job, problem)
        ckpt = sched._checkpoint_path(job)
        for p in (ckpt, job.checkpoint):
            if p and os.path.exists(p):
                os.remove(p)
        # One update: a reader never sees "done" beside a removed cut.
        sched.registry.transition(job, "done", result=result_record(res),
                                  checkpoint=None)
        prog.empty_slot(i)  # still live: must freeze

    def _cut(self, i: int, ctx, best: int, kind: str) -> None:
        """Cut a live slot out as a checkpoint: cancel keeps it resumable,
        drain requeues it for the next daemon, quantum preemption sends it
        to the back of the queue, a capacity stall requeues it solo-only."""
        sched = self.sched
        prog, problem = ctx["prog"], ctx["problem"]
        sl = ctx["slots"][i]
        job = sl.job
        batch, _size, best = prog.residual_slot(i)
        path = sched._checkpoint_path(job)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ckpt_mod.save(path, problem, batch, best, sl.tree, sl.sol)
        with flightrec.bound(job.recorder), ev.job_context(job.id):
            ev.emit("checkpoint", args={"cut": kind, "slot": i})
        res = self._result(sl, best, False, prog)
        self._release_slot(i, ctx, job, problem)
        prog.empty_slot(i)  # cut slot is live: freeze it
        if kind == "cancelled":
            sched.registry.transition(job, "cancelled", checkpoint=path,
                                      result=result_record(res))
            return
        if kind == "requeued":
            self._inc("tts_serve_requeues_total")
            sched.registry.transition(job, "requeued", checkpoint=path)
            return
        if kind == "stall":
            job._solo_only = True
            self._inc("tts_serve_requeues_total")
            sched.registry.update(job, checkpoint=path)
            sched.registry.transition(job, "queued")
            self._requeue_back(job)
            return
        # Quantum preemption: back of the queue, resume from the cut.
        self._inc("tts_serve_preemptions_total")
        sched.registry.update(job, preemptions=job.preemptions + 1,
                              checkpoint=path)
        sched.registry.transition(job, "queued")
        self._requeue_back(job)

