"""Crash-safe flight recorder (``TTS_FLIGHTREC``) — the port of
`tpu_tree_search/obs/flightrec.py`.

A run that dies (killed, out of time, a hung dispatch) writes its telemetry
at the end of the run, which it never reaches. This module makes a dying
run leave a diagnosis:

  * **in-run state**: a bounded ring of periodic snapshots (nodes/s,
    incumbent, pool occupancy, pipeline depth, K, steal totals) plus a
    registry of the **last completed dispatch** per (host, worker) and
    each worker's idle state — harvested only at the dispatch/chunk
    boundaries the engines already own (a ``heartbeat()`` per boundary;
    one global enable check when off, exactly the ``events.emit`` cost
    model), never from inside a device program;
  * **post-mortem dump**: on SIGTERM, SIGALRM, an unhandled exception, or
    a watchdog stall (no heartbeat for ``TTS_WATCHDOG_S`` — the signature
    of a dispatch that never returns), the recorder drains the event
    buffers and writes a valid Chrome-trace JSON plus a metrics JSONL,
    fsync'd, with the last-dispatch registry / in-flight pipeline depth /
    idle map embedded in the trace's ``otherData.flightrec`` — so
    ``report`` and Perfetto work on the corpse exactly as on a clean trace.

Everything here is host-side bookkeeping at existing host control points
(the resident engine's dispatch reads, the offload chunk loop, the
sequential tier's end); the dispatch graphs are untouched.

Knobs: ``TTS_FLIGHTREC=<path-prefix>`` arms recording and names the dump
files ``<prefix>.trace.json`` / ``<prefix>.metrics.jsonl`` (armed even
with ``TTS_OBS`` off — snapshots and the dispatch registry need no event
buffers); ``TTS_FLIGHTREC=0`` disables; unset, recording rides ``TTS_OBS``
with a ``tts_flightrec`` prefix in the temp dir. ``TTS_WATCHDOG_S`` sets
the stall threshold (default 300; ``0`` disables the watchdog thread).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque

from . import events as ev

#: Snapshot ring bound: at the default cadence (~4/s peak) this holds the
#: last several minutes of run dynamics; older snapshots age out.
RING_SNAPSHOTS = 512

#: Minimum microseconds between ring snapshots — heartbeats arrive once
#: per dispatch (possibly hundreds/s on fast configs); the ring keeps a
#: low-overhead subsample, not every boundary.
SNAPSHOT_PERIOD_US = 250_000.0

#: Default watchdog stall threshold (seconds without a heartbeat after at
#: least one arrived). The failure it catches is a dispatch that never
#: returns; long legitimate dispatches exist (the first builds the
#: kernels and graphs), so the default is lax.
WATCHDOG_DEFAULT_S = 300.0

def _knob() -> str:
    return os.environ.get("TTS_FLIGHTREC", "") or ""


def enabled() -> bool:
    """Recording armed? ``TTS_FLIGHTREC=0`` force-disables; any other
    explicit value arms it; unset, it rides ``TTS_OBS``."""
    knob = _knob()
    if knob == "0":
        return False
    if knob:
        return True
    return ev.enabled()


def dump_prefix() -> str:
    """Dump path prefix: an explicit ``TTS_FLIGHTREC`` path wins; the
    implicit default lands in the temp dir — a TTS_OBS=1 test/CI session
    must never dirty a working tree with post-mortems (armed hardware
    sessions always set the path)."""
    knob = _knob()
    if knob not in ("", "0", "1"):
        return knob
    import tempfile

    return os.path.join(tempfile.gettempdir(), "tts_flightrec")


def watchdog_interval_s() -> float:
    raw = os.environ.get("TTS_WATCHDOG_S", "")
    try:
        return float(raw) if raw else WATCHDOG_DEFAULT_S
    except ValueError:
        return WATCHDOG_DEFAULT_S


def _aggregate(now: float, tier: str, last: list[dict], idle_count: int,
               meta: dict, prev: dict | None) -> dict:
    """One global snapshot from (copies of) the per-worker dispatch
    registry; rates are deltas against the previous snapshot."""
    tree = sum(d["tree"] for d in last)
    sol = sum(d["sol"] for d in last)
    bests = [d["best"] for d in last if d["best"] is not None]
    sizes = [d["size"] for d in last if d["size"] is not None]
    nps = 0.0
    if prev is not None and now > prev["ts_us"]:
        nps = max(0.0, (tree - prev["tree"]) * 1e6 / (now - prev["ts_us"]))
    # Latest harvested phase split (TTS_PHASEPROF runs): the newest
    # registry entry that carries one names the dominant phase.
    ph = None
    for d in sorted(last, key=lambda d: d["ts_us"]):
        if d.get("phases"):
            ph = d["phases"]
    snap_phase: dict = {}
    if ph is not None:
        from . import phases as phases_mod

        snap_phase["phases"] = dict(ph)
        dom = phases_mod.dominant_phase(ph)
        if dom is not None:
            snap_phase["dominant_phase"] = dom[0]
            snap_phase["dominant_phase_share"] = round(dom[1], 4)
    # Job correlation (serve): the scheduler stamps the bound recorder's
    # meta with the job id/class; surfacing them here puts the job on
    # every SSE frame and dumped snapshot.
    for k in ("job", "cls"):
        if meta.get(k) is not None:
            snap_phase[k] = meta[k]
    # Most recent steal's link class / hierarchy level (worker heartbeats
    # or the inter-host communicator's note_steal): on a stall, this names
    # the level the run was last fed from.
    if meta.get("steal_link") is not None:
        snap_phase["steal_link"] = meta["steal_link"]
        snap_phase["steal_level"] = meta.get("steal_level")
    return {
        **snap_phase,
        "ts_us": now,
        "tier": tier,
        "seq": max((d["seq"] for d in last), default=0),
        "tree": tree,
        "sol": sol,
        "nodes_per_sec": round(nps, 1),
        "best": min(bests) if bests else None,
        "size": sum(sizes) if sizes else None,
        "inflight": max((d["inflight"] for d in last), default=0),
        "steals": sum(d["steals"] for d in last),
        "workers": len(last),
        "idle_workers": idle_count,
        "depth": meta.get("depth", 1),
        "K": meta.get("K"),
    }


class FlightRecorder:
    """Snapshot ring + last-dispatch registry + crash-dump hooks.

    One module-level instance serves the process; the class is separate so
    tests can exercise ring bounds and dump content without touching the
    global handlers.
    """

    def __init__(self, ring: int = RING_SNAPSHOTS,
                 snapshot_period_us: float = SNAPSHOT_PERIOD_US,
                 always_on: bool = False):
        # always_on: a privately-owned recorder (the serve daemon binds one
        # per job) records regardless of the TTS_FLIGHTREC/TTS_OBS knobs —
        # the binding itself is the opt-in; it never installs process-wide
        # dump hooks.
        self.always_on = always_on
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring)  # guarded-by: _lock
        self._last: dict = {}  # guarded-by: _lock -- (host, wid) -> dispatch
        self._idle: set = set()  # guarded-by: _lock -- (host, wid) idle now
        self._meta: dict = {}  # guarded-by: _lock -- run tier/label/depth/K
        self._prev_snap: dict | None = None  # guarded-by: _lock
        self._snap_period_us = snapshot_period_us
        self._last_beat: float | None = None  # monotonic s; advisory read
        self._stall_dumped = False
        self._installed = False
        self._watchdog: threading.Thread | None = None
        self._prev_handlers: dict = {}
        self._prev_excepthook = None

    # -- in-run state ------------------------------------------------------

    def heartbeat(self, tier: str, host: int = 0, wid: int = 0, *,
                  seq: int = 0, cycles: int = 0, size: int | None = None,
                  best: int | None = None, tree: int = 0, sol: int = 0,
                  depth: int = 1, K: int | None = None, inflight: int = 0,
                  steals: int = 0, phases: dict | None = None,
                  steal_link: str | None = None,
                  steal_level: int | None = None) -> None:
        """One completed dispatch/chunk boundary. Updates the registry,
        feeds the watchdog, and (rate-limited) appends a ring snapshot +
        emits a ``snapshot`` counter sample into the event stream.
        ``phases`` is the run's per-phase ns totals so far (TTS_PHASEPROF
        armed runs) — a watchdog post-mortem then names where the last
        dispatch was spending its cycles. ``steal_link``/``steal_level``
        name the worker's most recent steal's link class and hierarchy
        level (parallel/topology.py) so a stalled run's snapshot shows
        which steal level it was living off."""
        if not (self.always_on or enabled()):
            return
        now = ev.now_us()
        self._last_beat = time.monotonic()
        self._stall_dumped = False
        with self._lock:
            entry = {
                "ts_us": now, "seq": seq, "cycles": cycles, "size": size,
                "best": best, "tree": tree, "sol": sol, "inflight": inflight,
                "steals": steals,
            }
            if phases is not None:
                entry["phases"] = dict(phases)
            if steal_link is not None:
                self._meta["steal_link"] = steal_link
                self._meta["steal_level"] = steal_level
            self._last[(host, wid)] = entry
            self._idle.discard((host, wid))
            self._meta.setdefault("tier", tier)
            self._meta["depth"] = depth
            if K is not None:
                self._meta["K"] = K
            prev = self._prev_snap
            if prev is not None and now - prev["ts_us"] < self._snap_period_us:
                return
            snap = _aggregate(now, tier, list(self._last.values()),
                              len(self._idle), dict(self._meta), prev)
            self._ring.append(snap)
            self._prev_snap = snap
        # Outside the lock: the event recorder has its own buffers.
        ev.counter("snapshot", host=host, **{
            k: v for k, v in snap.items()
            if isinstance(v, (int, float)) and k != "ts_us"
        })

    def set_idle(self, host: int, wid: int, idle: bool) -> None:
        """Worker idle-state transitions (the offload tiers' busy<->idle
        edges — same call sites as their ``idle`` spans)."""
        if not (self.always_on or enabled()):
            return
        with self._lock:
            if idle:
                self._idle.add((host, wid))
            else:
                self._idle.discard((host, wid))

    def note_steal(self, host: int, link: str, level: int) -> None:
        """Record a work-migration arrival's link class / hierarchy level
        without a full heartbeat — the inter-host communicator thread's
        call site (dist/dist_mesh donation receive): the next snapshot
        (and a stall post-mortem) then names the level feeding the run."""
        if not (self.always_on or enabled()):
            return
        with self._lock:
            self._meta["steal_link"] = link
            self._meta["steal_level"] = level

    def snapshots(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def latest(self) -> dict | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def state(self) -> dict:
        """The post-mortem payload: last completed dispatch per track,
        in-flight depth, idle map, run meta."""
        with self._lock:
            return {
                "last_dispatch": {
                    f"h{h}/w{w}": dict(d)
                    for (h, w), d in sorted(self._last.items())
                },
                "idle_workers": sorted(
                    f"h{h}/w{w}" for h, w in self._idle
                ),
                "meta": dict(self._meta),
                "snapshots": len(self._ring),
            }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._last.clear()
            self._idle.clear()
            self._meta.clear()
            self._prev_snap = None
        self._last_beat = None
        self._stall_dumped = False

    # -- dump --------------------------------------------------------------

    def dump(self, reason: str, prefix: str | None = None) -> str | None:
        """Write ``<prefix>.trace.json`` + ``<prefix>.metrics.jsonl``.

        Safe to call from a signal handler or the watchdog thread: the
        event drain uses a bounded lock wait (the interrupted thread could
        hold a buffer-registry lock), writes are fsync'd, and any failure
        returns None instead of raising — a dump must never turn a dying
        process's exit into a different error."""
        from . import export

        try:
            prefix = prefix or dump_prefix()
            evts = ev.drain(timeout=2.0)
            obj = export.chrome_trace_object(evts, label="flightrec")
            obj["otherData"]["flightrec"] = {
                "reason": reason,
                "dumped_unix": time.time(),
                **self.state(),
            }
            trace_path = prefix + ".trace.json"
            with open(trace_path, "w") as f:
                json.dump(obj, f)
                f.flush()
                os.fsync(f.fileno())
            metrics_path = prefix + ".metrics.jsonl"
            with open(metrics_path, "w") as f:
                for rec in export.metrics_lines(evts):
                    f.write(json.dumps(rec) + "\n")
                for snap in self.snapshots():
                    f.write(json.dumps({"name": "snapshot", **snap}) + "\n")
                f.flush()
                os.fsync(f.fileno())
            return trace_path
        except Exception:  # noqa: BLE001 — never mask the original death
            return None

    # -- hooks -------------------------------------------------------------

    def install(self) -> bool:
        """Arm the dump triggers (idempotent). Signal handlers only attach
        from the main thread (Python's rule); the excepthook and watchdog
        attach from anywhere. Returns True when armed."""
        if not enabled():
            return False
        if not self._installed:
            self._installed = True
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._on_exception
        # Signals (re-)attempt on every arm: the FIRST install may have
        # come from a worker thread (dist_mesh virtual hosts), where
        # Python forbids signal handlers — a later main-thread arm must
        # still attach them.
        if (not self._prev_handlers
                and threading.current_thread() is threading.main_thread()):
            for sig in (signal.SIGTERM, signal.SIGALRM):
                try:
                    self._prev_handlers[sig] = signal.signal(
                        sig, self._on_signal
                    )
                except (ValueError, OSError):
                    pass
        self._maybe_start_watchdog()
        return True

    def _maybe_start_watchdog(self) -> None:
        if self._watchdog is not None and self._watchdog.is_alive():
            return
        interval = watchdog_interval_s()
        if interval <= 0:
            return
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, args=(interval,),
            name="tts-flightrec-watchdog", daemon=True,
        )
        self._watchdog.start()

    def _watchdog_loop(self, interval: float) -> None:
        # Advisory reads of _last_beat (a float assignment is atomic); the
        # dump itself takes the lock with a bounded wait.
        poll = max(1.0, interval / 4.0)
        while True:
            time.sleep(poll)
            if not enabled():
                continue
            beat = self._last_beat
            if beat is None or self._stall_dumped:
                continue
            stalled = time.monotonic() - beat
            if stalled > interval:
                self._stall_dumped = True
                self.dump(f"watchdog_stall: no dispatch heartbeat for "
                          f"{stalled:.0f}s (threshold {interval:.0f}s)")

    def _on_signal(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        self.dump(name)
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
            return
        # Default/ignored previous disposition: restore it and re-raise so
        # the process exits with the honest signal status (e.g. 143).
        signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    def _on_exception(self, exc_type, exc, tb) -> None:
        # KeyboardInterrupt is an operator action, not a crash worth a
        # post-mortem; everything else dumps before the traceback prints.
        if not issubclass(exc_type, KeyboardInterrupt):
            self.dump(f"exception: {exc_type.__name__}: {exc}")
        hook = self._prev_excepthook or sys.__excepthook__
        hook(exc_type, exc, tb)


_REC = FlightRecorder()

#: Thread-bound recorder override (``bound()``): the serve daemon runs many
#: tenant jobs in one process and namespaces each job's telemetry by
#: binding a private recorder around the engine call — the engines keep
#: calling the same module-level ``heartbeat``/``set_idle`` hooks, and the
#: binding routes them. Thread-local because jobs run on scheduler worker
#: threads; an unbound thread (every standalone run) uses the global
#: recorder exactly as before.
_TLS = threading.local()


def recorder() -> FlightRecorder:
    return _REC


def current() -> FlightRecorder:
    """The recorder this thread's heartbeats land in: the ``bound()``
    recorder when inside a binding, else the process-global one."""
    return getattr(_TLS, "rec", None) or _REC


class bound:
    """Context manager: route this thread's heartbeats/idle edges into
    ``rec`` (re-entrant; restores the previous binding on exit)."""

    def __init__(self, rec: FlightRecorder):
        self.rec = rec
        self._prev: FlightRecorder | None = None

    def __enter__(self) -> FlightRecorder:
        self._prev = getattr(_TLS, "rec", None)
        _TLS.rec = self.rec
        return self.rec

    def __exit__(self, *exc) -> None:
        _TLS.rec = self._prev


def arm(tier: str | None = None) -> bool:
    """Engine entry hook: install the dump triggers if recording is
    enabled (cheap no-op otherwise) and note the run's tier. Under a
    ``bound()`` recorder the tier lands on the binding and no process-wide
    hooks are touched — a tenant job must not re-point the daemon's signal
    handlers or watchdog."""
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        if tier is not None:
            with rec._lock:
                rec._meta["tier"] = tier
        return True
    ok = _REC.install()
    if ok and tier is not None:
        with _REC._lock:
            _REC._meta["tier"] = tier
    return ok


def heartbeat(*args, **kw) -> None:
    current().heartbeat(*args, **kw)


def set_idle(host: int, wid: int, idle: bool) -> None:
    current().set_idle(host, wid, idle)


def note_steal(host: int, link: str, level: int) -> None:
    current().note_steal(host, link, level)


def snapshots(n: int | None = None) -> list[dict]:
    return _REC.snapshots(n)


def latest() -> dict | None:
    return _REC.latest()


def dump(reason: str, prefix: str | None = None) -> str | None:
    return _REC.dump(reason, prefix)


def reset() -> None:
    _REC.reset()
