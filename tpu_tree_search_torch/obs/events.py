"""Host-side structured event tracing (``TTS_OBS``) — the port of
`tpu_tree_search/obs/events.py`, with the same event shape.

The reference kit's only observability is the final banner plus an appended
``stats_*.dat`` line (`pfsp_gpu_cuda.c:140-148`); the dynamics both
load-balancing papers diagnose from — steal rounds, idle windows, per-worker
imbalance (Helbecque et al., arXiv:2012.09511 §5; Melab et al.,
arXiv:0809.3285 §4) — are invisible. This module records them: a process-wide
recorder of timestamped structured events that the runtimes emit at their
natural host-side boundaries (dispatches, steals, exchange rounds, incumbent
improvements, phase transitions, checkpoint cuts).

Concurrency model: **thread-local append buffers, merged at drain**. Workers
(the multi/dist tiers run one host thread per device plus communicator
threads) append to their own bounded deque without taking any lock; the
recorder's lock guards only the buffer *registry* (taken once per thread,
at first emit) and the drain-time merge. No hot-path contention, no
cross-thread ordering requirement — events carry monotonic timestamps
(``time.perf_counter_ns``) and the merge sorts.

Cost model: every emit is gated on ``enabled()`` — one global read — so the
disabled path is a few nanoseconds per call site. Call sites are host-side
control points (per dispatch / steal / round), never per node or per cycle;
the on-device hot loop is covered by ``counters`` instead.

Event shape (Chrome-trace-event aligned, so export is a dump not a
translation): ``ph`` is the Chrome phase — ``"i"`` instant, ``"X"`` complete
(with ``dur``), ``"C"`` counter — ``ts``/``dur`` are microseconds, ``pid``
is the host id, ``tid`` the worker/communicator track.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

#: Per-thread buffer bound: a runaway run (TTS_OBS=1 with nobody draining)
#: keeps the newest events instead of growing without bound.
MAX_EVENTS_PER_THREAD = 200_000

#: tid used for communicator/coordinator tracks (clear of worker ids).
COMM_TID = 1000

# -- job correlation (serve) -----------------------------------------------
# The serve scheduler runs many jobs through the same worker thread; a
# merged trace over a daemon's state-dir is useless if every span is
# anonymous. The scheduler binds the active job id per thread
# (``with job_context(job_id):`` around each slice); ``emit`` stamps it
# onto every event as a top-level ``"job"`` field, which the Chrome-trace
# export (obs/export.py) turns into per-job lanes and ``report``
# groups into per-job sections. Chrome/Perfetto ignore unknown fields,
# so stamped traces stay loadable everywhere.

_JOB_CTX = threading.local()


def current_job() -> str | None:
    """The job id bound to this thread, if any."""
    return getattr(_JOB_CTX, "job", None)


class job_context:
    """``with job_context("job-000001"):`` — stamp every event this
    thread emits with the job id. Nests (restores the previous binding);
    ``None`` is a no-op binding."""

    def __init__(self, job: str | None):
        self._job = job
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_JOB_CTX, "job", None)
        _JOB_CTX.job = self._job
        return self

    def __exit__(self, *exc):
        _JOB_CTX.job = self._prev
        return False


def obs_mode() -> str:
    """The ``TTS_OBS`` knob: ``"0"``/unset = off, ``"1"`` = full (host
    events + on-device counters), ``"host"`` = host events only — the
    dispatch graphs stay those of obs-off, so a run can be traced without
    arming the counter block."""
    return os.environ.get("TTS_OBS", "0") or "0"


def enabled() -> bool:
    """Host event tracing on? (Any non-off mode.)"""
    return obs_mode() not in ("0",)


def now_us() -> float:
    """Monotonic microseconds — the trace time base."""
    return time.perf_counter_ns() / 1e3


class EventRecorder:
    """Thread-local buffers + locked registry; see module docstring."""

    def __init__(self, max_per_thread: int = MAX_EVENTS_PER_THREAD):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._buffers: list[deque] = []  # guarded-by: _lock
        self._max = max_per_thread

    def _buf(self) -> deque:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = deque(maxlen=self._max)
            self._local.buf = buf
            with self._lock:
                self._buffers.append(buf)
        return buf

    def emit(self, event: dict) -> None:
        self._buf().append(event)

    def drain(self, timeout: float | None = None) -> list[dict]:
        """Merged, time-sorted snapshot of every thread's buffer.

        ``timeout`` bounds the registry-lock wait (the flight recorder
        drains from signal handlers and its watchdog thread — the
        interrupted thread could hold the lock mid-registration); on a
        timeout the merge proceeds best-effort without the lock (deque
        iteration is safe against concurrent appends; at worst a buffer
        registered this instant is missed)."""
        locked = (
            self._lock.acquire() if timeout is None
            else self._lock.acquire(timeout=timeout)
        )
        try:
            # tts-lint: waive guarded-by -- lock-timeout fallback for signal-handler drains: deque iteration over a list() copy is safe vs concurrent appends; a just-registered buffer may be missed
            merged = [e for buf in list(self._buffers) for e in list(buf)]
        finally:
            if locked:
                self._lock.release()
        merged.sort(key=lambda e: e.get("ts", 0.0))
        return merged

    def clear(self) -> None:
        with self._lock:
            for buf in self._buffers:
                buf.clear()


_recorder = EventRecorder()


def recorder() -> EventRecorder:
    return _recorder


def reset() -> None:
    """Empty every buffer (run-scoped captures call this on entry so one
    process's earlier runs don't leak into a new trace)."""
    _recorder.clear()


def drain(timeout: float | None = None) -> list[dict]:
    return _recorder.drain(timeout=timeout)


def emit(name: str, cat: str = "tts", ph: str = "i", wid: int = 0,
         host: int = 0, ts: float | None = None, dur: float | None = None,
         args: dict | None = None) -> None:
    """Record one event iff tracing is enabled (cheap no-op otherwise)."""
    if not enabled():
        return
    ev: dict = {
        "name": name,
        "cat": cat,
        "ph": ph,
        "ts": now_us() if ts is None else ts,
        "pid": host,
        "tid": wid,
    }
    if dur is not None:
        ev["dur"] = dur
    if args:
        ev["args"] = args
    job = getattr(_JOB_CTX, "job", None)
    if job is not None:
        ev["job"] = job
    _recorder.emit(ev)


def complete(name: str, start_us: float, cat: str = "tts", wid: int = 0,
             host: int = 0, args: dict | None = None) -> None:
    """A Chrome ``"X"`` complete event spanning ``start_us`` .. now."""
    if not enabled():
        return
    emit(name, cat=cat, ph="X", wid=wid, host=host, ts=start_us,
         dur=max(0.0, now_us() - start_us), args=args)


def counter(name: str, wid: int = 0, host: int = 0, **values) -> None:
    """A Chrome ``"C"`` counter sample (one Perfetto counter track per
    name); values must be numbers."""
    if not enabled():
        return
    emit(name, cat="metrics", ph="C", wid=wid, host=host, args=values)


class span:
    """``with span("steal", wid=3):`` — emits one complete event covering
    the block. Usable when tracing is off (no-op)."""

    def __init__(self, name: str, cat: str = "tts", wid: int = 0,
                 host: int = 0, args: dict | None = None):
        self.name = name
        self.cat = cat
        self.wid = wid
        self.host = host
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = now_us()
        return self

    def __exit__(self, *exc):
        complete(self.name, self._t0, cat=self.cat, wid=self.wid,
                 host=self.host, args=self.args)
        return False
