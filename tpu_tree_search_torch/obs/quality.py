"""Anytime search-quality telemetry (``TTS_QUALITY``): the incumbent
trajectory, recorded host-side at dispatch boundaries — the port of
`tpu_tree_search/obs/quality.py` (its ``@contract`` belongs to the JAX
program audit, ``tts check``, which has no counterpart in the port).

Large-scale B&B work reports *solution quality over time*, not just
nodes/s (Helbecque et al., arXiv:2012.09511 §5 plot exactly this curve);
a serving daemon needs it live — "how good is the answer so far" is the
question a tenant asks of a running job. This module records the
trajectory: one point per incumbent improvement, carrying

  ``(t_s, step, best, nodes)``

— wall-time since the first observation, cumulative dispatch step,
the new incumbent, and nodes expanded so far. The first observed
incumbent is always recorded (it anchors the curve at t≈0; for a
warm-started PFSP run that is the table UB, for N-Queens the INF
sentinel of a problem with no objective).

Cost model: the recorder consumes scalars the dispatch loop ALREADY
reads at its host boundary (the dispatch's scalars) — no new state, no
extra device work, and the dispatch graphs are the same with the knob on
or off. Off path: one ``tracker()`` call per run returning ``None``, one
``is not None`` check per dispatch.

Arming: ``TTS_QUALITY=1`` for standalone CLI runs (the trajectory
lands in ``SearchResult.quality``); the serve scheduler instead *binds*
a per-job recorder (``with bound(rec):``) that is always on and spans
preemption slices, so a job's curve survives requeues and the final
slice's result carries the full-job trajectory.
"""

from __future__ import annotations

import os
import threading

from . import events as ev


def enabled() -> bool:
    """The ``TTS_QUALITY`` knob: unset/``0`` = off, ``1`` = record the
    incumbent trajectory into ``SearchResult.quality``. Host-side only —
    flipping it never recompiles anything."""
    return os.environ.get("TTS_QUALITY", "0") not in ("", "0")


class QualityRecorder:
    """Thread-safe incumbent-trajectory recorder.

    One per run — or one per serve *job*, where it spans preemption
    slices: ``step_offset`` is set to the job's cumulative step count
    before each slice so recorded steps stay job-cumulative, and the
    wall-clock base persists across slices (queue wait between slices is
    real anytime latency and stays in the curve). The mesh/dist tiers'
    host threads may share one recorder; the lock makes concurrent
    observes merge into a single monotone trajectory."""

    def __init__(self, optimum: int | None = None):
        self._lock = threading.Lock()
        self._points: list[dict] = []  # guarded-by: _lock
        self._best: int | None = None  # guarded-by: _lock
        self._t0_us: float | None = None  # guarded-by: _lock
        #: Best-known reference for primal-gap computation (None = unknown).
        self.optimum = optimum
        #: Steps recorded before this slice (serve preemption resumes).
        self.step_offset = 0

    def observe(self, best, step: int, nodes: int,
                t_us: float | None = None) -> bool:
        """Record ``best`` if it improves on the last recorded incumbent
        (the first observation always records). Returns True when a
        point was appended."""
        best = int(best)
        now = ev.now_us() if t_us is None else t_us
        with self._lock:
            if self._best is not None and best >= self._best:
                return False
            if self._t0_us is None:
                self._t0_us = now
            self._best = best
            self._points.append({
                "t_s": round(max(0.0, now - self._t0_us) / 1e6, 6),
                "step": int(self.step_offset) + int(step),
                "best": best,
                "nodes": int(nodes),
            })
            return True

    def points(self) -> list[dict]:
        """Snapshot of the trajectory so far (serve streams new entries
        as SSE ``incumbent`` frames)."""
        with self._lock:
            return list(self._points)

    def result(self) -> dict:
        """The ``SearchResult.quality`` payload."""
        with self._lock:
            return {"optimum": self.optimum, "points": list(self._points)}


# -- per-thread binding (serve: one recorder per job) -----------------------

_TLS = threading.local()


def current() -> QualityRecorder | None:
    """The recorder bound to this thread, if any."""
    return getattr(_TLS, "rec", None)


class bound:
    """``with quality.bound(rec):`` — route this thread's ``tracker()``
    to a caller-owned recorder (regardless of TTS_QUALITY; the serve
    scheduler wraps each slice so per-job quality is always on)."""

    def __init__(self, rec: QualityRecorder | None):
        self._rec = rec
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_TLS, "rec", None)
        _TLS.rec = self._rec
        return self._rec

    def __exit__(self, *exc):
        _TLS.rec = self._prev
        return False


def tracker(problem=None) -> QualityRecorder | None:
    """The recorder an engine run should observe into: the thread-bound
    one (serve) if present, a fresh one when ``TTS_QUALITY=1``, else
    ``None`` (the off path). Resolves the problem's best-known reference
    into ``rec.optimum`` and, when event tracing is on, emits one
    ``quality_ref`` event so a merged trace can compute gaps offline."""
    rec = current()
    if rec is None:
        if not enabled():
            return None
        rec = QualityRecorder()
    if rec.optimum is None and problem is not None:
        from ..problems import taillard_optima

        rec.optimum = taillard_optima.optimum_for(problem)
    if rec.optimum is not None and ev.enabled():
        label = getattr(problem, "name", "?") if problem is not None else "?"
        inst = getattr(problem, "inst", None) if problem is not None else None
        if isinstance(inst, int):
            label = f"ta{inst:03d}"
        ev.emit("quality_ref", args={
            "instance": label, "optimum": int(rec.optimum),
        })
    return rec


# -- anytime metrics (arXiv:2012.09511 §5 conventions) ----------------------

def primal_gap(best, optimum) -> float | None:
    """Relative gap ``(best - optimum) / optimum``; None when unknown."""
    from ..problems import taillard_optima

    return taillard_optima.gap(best, optimum)


def primal_integral(points: list[dict], optimum, horizon_s: float,
                    cap: float = 1.0) -> float | None:
    """Normalized primal integral over ``[0, horizon_s]``: the
    time-weighted average of the (capped) primal gap, treating the gap
    before the first incumbent as ``cap``. 0.0 = instantly optimal;
    ``cap`` = never found anything useful. None when no reference value
    or horizon exists."""
    if optimum is None or optimum <= 0 or not horizon_s or horizon_s <= 0:
        return None
    total = 0.0
    t_prev = 0.0
    g_prev = cap
    for p in sorted(points or [], key=lambda p: p.get("t_s", 0.0)):
        t = min(max(float(p.get("t_s", 0.0)), 0.0), float(horizon_s))
        total += g_prev * (t - t_prev)
        g = primal_gap(p.get("best"), optimum)
        g_prev = cap if g is None else min(cap, max(g, 0.0))
        t_prev = t
    total += g_prev * (float(horizon_s) - t_prev)
    return total / float(horizon_s)


# -- program contracts (`check`, analysis/contracts.py) ------------------------

from ..analysis.contracts import contract  # noqa: E402


@contract(
    "quality-off-identity",
    claim="quality telemetry is host-side only: it reads the scalars the "
          "dispatch boundary already reads, and the TTS_QUALITY=1 build "
          "records the same program as the off build — the knob never "
          "forks a program",
    artifact="variants",
)
def _contract_quality_off_identity(art, cell):
    if not art.has("off", "quality1"):
        return []
    if art.text("off") != art.text("quality1"):
        return ["TTS_QUALITY=1 build differs from the off build (host-side "
                "telemetry leaked into the program)"]
    return []
