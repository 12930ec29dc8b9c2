"""The serve scheduler: worker threads + checkpoint-based preemption
(`tpu_tree_search/serve/scheduler.py`, without the mesh tier).

One job runs as a sequence of **slices**. Each slice is one
``resident_search`` call whose ``yield_fn``
(checked by ``RunController`` at every dispatch boundary) cuts the run
when the job is cancelled, the daemon is draining, or the job's time
quantum expired while other work waits. A cut drains the dispatch queue,
snapshots the frontier, and writes the job's checkpoint — the next slice
resumes from it and the final counters are full-run totals, bit-identical
to an uninterrupted run (engine/checkpoint.py's contract).

Env pins: ``EnvLease`` is a refcounted knob lease — jobs with identical
pin dicts share it, a job with different pins waits for the current
holders to finish their slices. The port's jobs pin nothing (``job_pins``),
so the lease never blocks; it is kept so that a knob that becomes per-job
stays correct under ``--workers N``.

The card is touched only here, on the worker threads (each slice's
search); the HTTP threads read Python attributes.

Lock order: no scheduler method holds
two of {Scheduler._cv, Scheduler._batch_lock, EnvLease._cv,
JobRegistry._lock, JobRegistry._io_lock} at once — every cross-class call
happens outside the local ``with`` block. ``_batch_lock`` is a leaf that
guards only the ``_batch_execs`` dict (executor lookup/create). The
registry's own ``_io_lock -> _lock`` nesting (``JobRegistry._persist``)
is the graph's only two-lock hold.

Instance batching (``--batch-slots B`` / ``TTS_BATCH_SLOTS``, serve/
batch.py): when B > 1 and the popped job's immediate queue neighbour
shares its shape class, the worker runs a ``BatchExecutor`` session
instead of a solo slice — same quantum/cancel/drain/budget semantics,
one K-cycle dispatch advancing up to B same-class jobs at once.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import pool as pool_mod
from .jobs import result_record


class EnvLease:
    """Refcounted process-env pin lease. ``acquire(pins)`` blocks until
    the current pin set is empty or equal, then applies the pins (saving
    prior values); the last ``release`` restores them. Methods never hold
    any other lock while waiting."""

    def __init__(self):
        self._cv = threading.Condition()
        self._pins = None  # guarded-by: _cv
        self._count = 0  # guarded-by: _cv
        self._saved = {}  # guarded-by: _cv

    def acquire(self, pins: dict) -> None:
        pins = dict(pins)
        with self._cv:
            while self._count and self._pins != pins:
                self._cv.wait(0.2)
            if self._count == 0:
                self._pins = pins
                self._saved = {k: os.environ.get(k) for k in pins}
                os.environ.update(pins)
            self._count += 1

    def release(self) -> None:
        with self._cv:
            self._count -= 1
            if self._count == 0:
                for k, v in self._saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
                self._pins = None
                self._saved = {}
                self._cv.notify_all()


class Scheduler:
    """FIFO queue + N worker threads (default 1: one accelerator, one
    resident loop at a time — more workers only help when jobs share pins
    and the backend multiplexes)."""

    def __init__(self, registry, pool, workers: int = 1,
                 quantum_s: float = 5.0, state_dir: str = ".",
                 metrics=None, batch_slots: int | None = None,
                 ckpt_every_s: float | None = None, device=None):
        from ..ops.backend import resolve_device

        self.registry = registry
        self.pool = pool
        # The daemon's device: every slice and batch session runs there.
        self.device = resolve_device(device)
        self.workers = max(1, int(workers))
        self.quantum_s = float(quantum_s)
        if ckpt_every_s is None:
            ckpt_every_s = float(os.environ.get("TTS_CKPT_EVERY", "0") or 0)
        # Periodic recoverability cuts (``--ckpt-every`` / TTS_CKPT_EVERY,
        # 0 = off): the slice yield_fn fires every ckpt_every_s even with
        # nothing waiting, so the job's checkpoint + exact step count hit
        # disk together at each cut — the fleet router pulls those to
        # survive a SIGKILLed daemon. Host-side policy only: the engine
        # call itself is unchanged (checkpoint_interval_s stays cut-only).
        self.ckpt_every_s = float(ckpt_every_s) or None
        self.state_dir = state_dir
        if batch_slots is None:
            batch_slots = int(os.environ.get("TTS_BATCH_SLOTS", "1") or 1)
        # B=1 IS the solo path: _batchable never fires and no executor is
        # ever built.
        self.batch_slots = max(1, int(batch_slots))
        self._batch_lock = threading.Lock()  # leaf: guards _batch_execs
        self._batch_execs = {}  # guarded-by: _batch_lock
        # serve/metrics.ServeMetrics (or None when embedded without a
        # daemon). Its lock is a leaf: inc/observe never call out, so
        # recording from any point here cannot invert the lock order.
        self.metrics = metrics
        self.lease = EnvLease()
        self._cv = threading.Condition()
        self._queue = deque()  # guarded-by: _cv  (job ids)
        self._stopping = False  # guarded-by: _cv
        self._active = 0  # guarded-by: _cv  (jobs inside a slice)
        self._threads = []
        self.started = False

    # -- queue side (HTTP thread + workers) --------------------------------

    def start(self) -> None:
        self.started = True
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, args=(i,),
                                 name=f"tts-serve-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def workers_alive(self) -> int:
        """Worker threads still running (``/healthz`` ``workers_alive``).
        ``_threads`` is append-only from ``start``; no lock needed."""
        return sum(1 for t in self._threads if t.is_alive())

    def _inc(self, name: str, labels=None, v: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, labels, v)

    def _observe(self, name: str, value: float, labels=None) -> None:
        if self.metrics is not None:
            self.metrics.observe(name, value, labels)

    def submit(self, job) -> int:
        """Enqueue an admitted job; returns its queue position."""
        with self._cv:
            if self._stopping:
                raise RuntimeError("scheduler is draining")
            self._queue.append(job.id)
            pos = len(self._queue)
            self._cv.notify()
        return pos

    def cancel(self, job) -> bool:
        """Cancel: drop a queued job immediately; flag a running one (its
        yield_fn cuts at the next dispatch boundary). Returns False when
        the job already finished."""
        # The flag goes first: whatever state the job races into after our
        # checks, the slice's yield_fn sees it and the post-slice check
        # records 'cancelled' — an acknowledged cancel can never end 'done'.
        job.cancel_requested = True
        with self._cv:
            if job.id in self._queue:
                self._queue.remove(job.id)
        if self.registry.transition_if(job, ("queued", "requeued"),
                                       "cancelled"):
            return True
        # Not queued/requeued: either running (the slice will cut and mark
        # it cancelled) or already terminal.
        return job.state == "running"

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def idle(self) -> bool:
        """No job inside a slice or a batch session."""
        with self._cv:
            return self._active == 0

    def _waiters(self) -> bool:
        with self._cv:
            return self._stopping or len(self._queue) > 0

    def _stop_requested(self) -> bool:
        with self._cv:
            return self._stopping

    def drain(self, timeout_s: float = 120.0) -> None:
        """Graceful stop: reject new work, cut running slices at the next
        dispatch boundary (checkpointed), mark everything still pending as
        ``requeued`` (a restarted daemon re-admits it), wait for workers
        to go idle."""
        with self._cv:
            self._stopping = True
            pending = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        for jid in pending:
            job = self.registry.get(jid)
            if job is not None and job.state == "queued":
                self.registry.transition(job, "requeued")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cv:
                if self._active == 0:
                    return
            time.sleep(0.05)

    # -- worker side -------------------------------------------------------

    def _worker(self, wid: int) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    self._cv.wait(0.5)
                if self._stopping and not self._queue:
                    return
                jid = self._queue.popleft()
                self._active += 1
            job = None
            try:
                job = self.registry.get(jid)
                if job is not None and job.state in ("queued", "requeued"):
                    if self._batchable(job):
                        self._run_batch(job, wid)
                    else:
                        self._run_slice(job, wid)
            except Exception as e:  # noqa: BLE001 — a worker must outlive
                # ANY per-job failure (admission, knob resolution, registry
                # persistence, recorder setup — not just the search call):
                # with the default --workers 1 a dead worker leaves a
                # daemon that accepts submits but never runs another job.
                try:
                    if job is not None:
                        self.registry.transition_if(
                            job, ("queued", "requeued", "running"), "failed",
                            error=f"{type(e).__name__}: {e}",
                        )
                except Exception:  # noqa: BLE001 — even the failed
                    pass  # transition failing (disk full) must not kill us
            finally:
                with self._cv:
                    self._active -= 1
                    self._cv.notify_all()

    def _checkpoint_path(self, job) -> str:
        return os.path.join(self.state_dir, "jobs", f"{job.id}.ckpt.npz")

    # -- instance batching (serve/batch.py) --------------------------------

    def _batchable(self, job) -> bool:
        """Route a popped job to the batch executor only when batching is
        on, the job can occupy a fixed slot (device tier, fixed K, not
        flagged solo-only), and the NEXT queued job shares its class —
        batch formation follows the same front-contiguity rule as slot
        refills, so a lone job never pays the batched program's build."""
        if self.batch_slots <= 1 or job.spec["tier"] != "device":
            return False
        if job.spec.get("K") == "auto" or \
                (os.environ.get("TTS_K") or "").strip().lower() == "auto":
            # AdaptiveK moves K mid-run, a graph a rung; a fixed-B batch
            # keeps one K (its graph is built once).
            return False
        if getattr(job, "_solo_only", False):
            return False
        with self._cv:
            head = self._queue[0] if self._queue else None
        if head is None:
            return False
        peer = self.registry.get(head)
        return (peer is not None and peer.class_key == job.class_key
                and peer.pins == job.pins)

    def take_same_class_front(self, class_key: str, pins: dict,
                              limit: int) -> list:
        """Pop up to `limit` FRONT-CONTIGUOUS queued jobs of one shape
        class for slot refills. Stops at the first different-class (or
        solo-only) job: a waiter at the head must see the batch shrink,
        not watch later same-class arrivals leapfrog it.

        Lock discipline: snapshot ids under _cv, resolve via the registry
        OUTSIDE it (no _cv -> JobRegistry._lock nesting), then remove
        under _cv re-checking membership (a racing cancel may have
        removed an id in between)."""
        if limit <= 0:
            return []
        with self._cv:
            if self._stopping:
                return []
            prefix = list(self._queue)[:limit + 8]
        chosen = []
        for jid in prefix:
            job = self.registry.get(jid)
            if job is None or job.class_key != class_key \
                    or job.pins != pins or getattr(job, "_solo_only", False):
                break
            chosen.append(job)
            if len(chosen) >= limit:
                break
        taken = []
        with self._cv:
            for job in chosen:
                if job.id in self._queue:
                    self._queue.remove(job.id)
                    taken.append(job)
        return taken

    def _run_batch(self, job, wid: int) -> None:
        key = (job.class_key, tuple(sorted(job.pins.items())))
        with self._batch_lock:
            ex = self._batch_execs.get(key)
            if ex is None:
                from .batch import BatchExecutor

                ex = BatchExecutor(self, job.class_key, job.pins,
                                   self.batch_slots)
                self._batch_execs[key] = ex
        ex.run(job, wid)

    def batch_stats(self) -> list[dict]:
        """Per-class batch occupancy for /metrics and `tts top`."""
        with self._batch_lock:
            execs = list(self._batch_execs.values())
        return [{"class": ex.class_key, "slots": ex.B,
                 "occupied": ex.occupied} for ex in execs]

    def _run_slice(self, job, wid: int) -> None:
        from ..obs import events as obs_events
        from ..obs import flightrec
        from ..obs import quality as obs_quality

        if job.cancel_requested:
            # Cancel raced the job off the queue: honour it before spending
            # any admission work.
            self.registry.transition_if(job, ("queued", "requeued"),
                                        "cancelled")
            return
        entry = self.pool.admit(job.spec)
        problem = entry.problem
        prog0, step0 = pool_mod.compile_stats(problem)
        if not self.registry.transition_if(job, ("queued", "requeued"),
                                           "running", slices=job.slices + 1):
            return  # a racing cancel won; never flip a terminal state back
        if job.slices == 1:
            # First slice: submit-to-start is the job's queue wait.
            self._observe("tts_serve_queue_wait_seconds",
                          max(0.0, (job.started or time.time())
                              - job.submitted),
                          {"cls": job.class_key})
        if job.recorder is None:
            # Private ring per job: never installs process-wide handlers;
            # always_on makes it record without TTS_OBS.
            # Finer snapshot cadence than the global ring: a tenant
            # watching one short job wants more than one frame.
            job.recorder = flightrec.FlightRecorder(
                always_on=True, snapshot_period_us=50_000.0
            )
            with job.recorder._lock:
                job.recorder._meta.update(job=job.id, cls=job.class_key)
        if job.quality is None:
            # Per-job incumbent trajectory (obs/quality.py): always on for
            # serve jobs, bound per slice; spans preemptions.
            job.quality = obs_quality.QualityRecorder()
        job.quality.step_offset = job.steps
        ckpt = self._checkpoint_path(job)
        quantum = self.quantum_s
        every = self.ckpt_every_s
        t0 = time.monotonic()  # restarted below, once the env lease is held

        def yield_fn() -> bool:
            if job.cancel_requested or self._stop_requested():
                return True
            elapsed = time.monotonic() - t0
            if every is not None and elapsed >= every:
                return True  # periodic cut: a recoverable checkpoint lands
            return elapsed >= quantum and self._waiters()

        budget = job.spec.get("max_steps")
        kw = dict(
            m=job.spec["m"], M=job.spec["M"], device=self.device,
            # The spec's max_steps is a CUMULATIVE budget: each slice runs
            # with whatever the previous slices left over, so a preempted
            # or drained job resumes mid-budget instead of restarting it.
            max_steps=None if budget is None else budget - job.steps,
            checkpoint_path=ckpt,
            checkpoint_interval_s=1e9,  # cut-only: no periodic snapshots
            resume_from=job.checkpoint,
            yield_fn=yield_fn,
        )
        if job.spec.get("K") is not None:
            kw["K"] = job.spec["K"]
        t_lease = time.monotonic()
        self.lease.acquire(job.pins)
        # Quantum clock starts AFTER the lease: time blocked waiting for a
        # conflicting env pin is queueing, not run time — charging it would
        # preempt a contended pinned job at its first dispatch boundary
        # every slice.
        t0 = time.monotonic()
        self._observe("tts_serve_lease_wait_seconds", t0 - t_lease)
        try:
            with flightrec.bound(job.recorder), \
                    obs_quality.bound(job.quality), \
                    obs_events.job_context(job.id):
                if job.spec["tier"] == "mesh":
                    from ..parallel.resident_mesh import mesh_resident_search

                    res = mesh_resident_search(problem, D=job.spec.get("D"),
                                               mp=job.spec.get("mp", 1),
                                               **kw)
                else:
                    from ..engine.resident import resident_search

                    res = resident_search(problem, **kw)
        except Exception as e:  # noqa: BLE001 — a job must not kill its worker
            self.registry.transition(job, "failed", error=f"{type(e).__name__}: {e}")
            return
        finally:
            self.lease.release()
            # Counted in `finally` so failed slices land in the series too.
            self._observe("tts_serve_run_seconds", time.monotonic() - t0,
                          {"cls": job.class_key})
            self._inc("tts_serve_slices_total", {"cls": job.class_key})
        prog1, step1 = pool_mod.compile_stats(problem)
        self.registry.update(
            job,
            steps=job.steps + res.steps,
            new_programs=job.new_programs + (prog1 - prog0),
            new_step_compiles=job.new_step_compiles + (step1 - step0),
        )
        self.pool.mark_warm(entry)
        if res.complete or (budget is not None and job.steps >= budget):
            # Done: the search finished, or the cumulative max_steps budget
            # is exhausted (a max_steps job "completes" at its cutoff by
            # design). A yield cut — cancel, drain, quantum preemption —
            # always leaves the budget unexhausted (the max_steps cutoff
            # wins the same dispatch boundary), so it can never be
            # mistaken for the cutoff and silently truncate a result.
            for p in (ckpt, job.checkpoint):
                if p and os.path.exists(p):
                    os.remove(p)
            # One update: a reader never sees "done" beside a removed cut.
            self.registry.transition(job, "done", result=result_record(res),
                                     checkpoint=None)
            return
        has_ckpt = os.path.exists(ckpt)
        if job.cancel_requested:
            self.registry.transition(
                job, "cancelled",
                checkpoint=ckpt if has_ckpt else job.checkpoint,
                result=result_record(res),
            )
            return
        if self._stop_requested():
            # Daemon drain: preserve the cut for the next daemon.
            self._inc("tts_serve_requeues_total")
            self.registry.transition(
                job, "requeued",
                checkpoint=ckpt if has_ckpt else job.checkpoint,
            )
            return
        # Quantum preemption: back of the queue, resume from the cut.
        self._inc("tts_serve_preemptions_total")
        self.registry.update(
            job, preemptions=job.preemptions + 1,
            checkpoint=ckpt if has_ckpt else job.checkpoint,
        )
        self.registry.transition(job, "queued")
        try:
            self.submit(job)
        except RuntimeError:
            self._inc("tts_serve_requeues_total")
            self.registry.transition(job, "requeued")
