"""Per-daemon scraped state + the pure placement policy (the port of
`tpu_tree_search/fleet/placement.py`, decision for decision).

The router never asks a daemon anything on the submit path: placement
runs against the keeper thread's last scrape of every registered
daemon's ``/healthz`` + ``/classes`` + ``/metrics`` + ``/jobs``. The
policy itself is pure functions over those snapshots, so every decision
is unit-testable without a single socket:

  * **warm first** — a daemon whose ``/classes`` already shows the job's
    shape class warm gets the job (an admission that builds no program
    and no graph: the class key here is the same ``serve/pool.class_key``
    computation the daemon will make). Among warm daemons, one with a *free same-class batch
    slot* (or an empty queue when batching is off) wins;
  * **least-loaded otherwise** — a cold class warms on the daemon with
    the lowest load score: queue depth, the measured mean queue wait
    (from the ``tts_serve_queue_wait_seconds`` histogram), resident
    pool bytes, and class occupancy, with the weights below.

Lock discipline (`analysis/lockorder.py`): ``FleetView._lock`` is a leaf
guarding only the url -> DaemonState dict; scrapes replace whole
snapshot fields, readers copy the list out — no method calls out while
holding it.
"""

from __future__ import annotations

import json
import threading
import time
from urllib.request import urlopen

#: Load-score weights. Units: a queued job ~ 10 points, a second of
#: measured mean queue wait ~ 5, a GiB of resident pool ~ 1, a resident
#: class ~ 0.5 — queue state dominates, memory pressure breaks ties.
W_QUEUE_DEPTH = 10.0
W_QUEUE_WAIT_S = 5.0
W_POOL_GIB = 1.0
W_CLASSES = 0.5


def fleet_class_key(spec: dict) -> str:
    """The job's shape class, computed router-side with the exact
    ``serve/pool.py`` functions the daemon will use at admission — the
    whole warm-placement story rests on both ends agreeing. Host-only:
    ``resolved_knobs`` resolves the compaction mode without building a
    problem or importing torch."""
    from ..serve.jobs import validate_spec
    from ..serve.pool import class_key

    return class_key(validate_spec(spec))


class DaemonState:
    """One daemon's last-scraped snapshot + liveness bookkeeping.

    Mutated only by the keeper thread (health.py) through
    ``FleetView.update``; placement reads copies. ``misses`` counts
    consecutive failed probes; ``healthy`` flips false after
    ``max_misses`` of them (with exponential probe backoff in between,
    so a dead daemon costs one socket timeout per backoff step, not per
    tick)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.healthy = False
        self.draining = False
        self.misses = 0
        self.next_probe = 0.0  # monotonic; backoff gate for dead daemons
        self.health: dict = {}
        self.classes: list = []
        self.metrics: dict = {}
        self.jobs: list = []
        self.last_ok = 0.0

    def snapshot(self) -> dict:
        """JSON view for ``/daemons`` and ``top --router``."""
        return {
            "url": self.url,
            "healthy": self.healthy,
            "draining": self.draining,
            "misses": self.misses,
            "health": self.health,
            "classes": self.classes,
            "jobs_by_state": _jobs_by_state(self.jobs),
        }


def _jobs_by_state(jobs: list) -> dict:
    out: dict = {}
    for j in jobs:
        s = j.get("state", "?")
        out[s] = out.get(s, 0) + 1
    return out


def scrape(url: str, timeout: float = 3.0) -> dict:
    """One full scrape of a daemon: health, classes, metrics, jobs.
    Raises on any failure (the keeper counts it as a miss)."""
    from ..serve.metrics import parse_text

    base = url.rstrip("/")

    def get_json(path):
        with urlopen(base + path, timeout=timeout) as r:  # noqa: S310
            return json.loads(r.read().decode())

    health = get_json("/healthz")
    classes = get_json("/classes")
    with urlopen(base + "/metrics", timeout=timeout) as r:  # noqa: S310
        metrics = parse_text(r.read().decode())
    jobs = get_json("/jobs")
    return {"health": health, "classes": classes, "metrics": metrics,
            "jobs": jobs}


class FleetView:
    """url -> DaemonState behind one leaf lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._daemons: dict = {}  # guarded-by: _lock

    def add(self, url: str) -> DaemonState:
        url = url.rstrip("/")
        with self._lock:
            st = self._daemons.get(url)
            if st is None:
                st = self._daemons[url] = DaemonState(url)
            return st

    def get(self, url: str):
        with self._lock:
            return self._daemons.get(url.rstrip("/"))

    def states(self) -> list:
        with self._lock:
            return sorted(self._daemons.values(), key=lambda s: s.url)

    def mark_ok(self, st: DaemonState, scraped: dict) -> None:
        with self._lock:
            st.health = scraped["health"]
            st.classes = scraped["classes"]
            st.metrics = scraped["metrics"]
            st.jobs = scraped["jobs"]
            st.healthy = bool(scraped["health"].get("ok", False))
            st.draining = bool(scraped["health"].get("draining", False))
            st.misses = 0
            st.next_probe = 0.0
            st.last_ok = time.monotonic()

    def mark_miss(self, st: DaemonState, backoff0_s: float,
                  max_backoff_s: float) -> int:
        """Count a failed probe; schedule the next one with exponential
        backoff. Returns the new consecutive-miss count."""
        with self._lock:
            st.misses += 1
            delay = min(max_backoff_s, backoff0_s * (2 ** (st.misses - 1)))
            st.next_probe = time.monotonic() + delay
            return st.misses

    def mark_dead(self, st: DaemonState) -> None:
        with self._lock:
            st.healthy = False


# -- the pure policy ---------------------------------------------------------


def class_stat(st: DaemonState, cls: str):
    for entry in st.classes:
        if entry.get("class") == cls:
            return entry
    return None


def has_free_slot(st: DaemonState, cls: str) -> bool:
    """A warm daemon admits this job without waiting: a same-class batch
    slot is open, or (batching off) the run queue is empty."""
    entry = class_stat(st, cls)
    if entry is None:
        return False
    if "batch_slots" in entry:
        return int(entry.get("slots_occupied", 0)) < int(entry["batch_slots"])
    return int(st.health.get("queue_depth", 0)) == 0


def queue_wait_mean_s(st: DaemonState) -> float:
    """Mean measured queue wait from the scraped histogram (all classes
    pooled): the daemon's own account of how long admission-to-start
    takes under its current load."""
    sums = st.metrics.get("tts_serve_queue_wait_seconds_sum", {})
    counts = st.metrics.get("tts_serve_queue_wait_seconds_count", {})
    total = sum(sums.values())
    n = sum(counts.values())
    return total / n if n else 0.0


def pool_bytes(st: DaemonState) -> int:
    return sum(int(e.get("pool_bytes", 0) or 0) for e in st.classes)


def load_score(st: DaemonState) -> float:
    """Weighted cold-placement load: lower is better."""
    return (W_QUEUE_DEPTH * int(st.health.get("queue_depth", 0))
            + W_QUEUE_WAIT_S * queue_wait_mean_s(st)
            + W_POOL_GIB * pool_bytes(st) / (1 << 30)
            + W_CLASSES * len(st.classes))


def placeable(st: DaemonState) -> bool:
    return st.healthy and not st.draining


def choose(states: list, cls: str):
    """Pick the daemon for a job of shape class ``cls``. Returns
    ``(DaemonState, reason)`` with reason ``"warm"`` or ``"cold"``, or
    ``(None, why)`` when no daemon is placeable. Deterministic: ties
    break on URL order."""
    candidates = [st for st in states if placeable(st)]
    if not candidates:
        return None, "no healthy daemon"
    warm = [st for st in candidates
            if (class_stat(st, cls) or {}).get("warm")]
    if warm:
        warm.sort(key=lambda st: (not has_free_slot(st, cls),
                                  load_score(st), st.url))
        return warm[0], "warm"
    candidates.sort(key=lambda st: (load_score(st), st.url))
    return candidates[0], "cold"


def pick_rebalance(states: list, min_depth: int = 2):
    """A conservative hot->idle move: when one daemon has ``min_depth``+
    jobs queued and another is completely idle (empty queue, nothing
    running), pick the hot daemon's longest-running checkpointed job to
    migrate. Returns ``(hot_state, job_record, idle_state)`` or ``None``
    — the caller executes the move over the migrate transport."""
    live = [st for st in states if placeable(st)]
    if len(live) < 2:
        return None
    live.sort(key=lambda st: (int(st.health.get("queue_depth", 0)), st.url))
    cold, hot = live[0], live[-1]
    if int(hot.health.get("queue_depth", 0)) < min_depth:
        return None
    if int(cold.health.get("queue_depth", 0)) != 0 or any(
            j.get("state") == "running" for j in cold.jobs):
        return None
    runners = [j for j in hot.jobs
               if j.get("state") == "running" and j.get("checkpoint")]
    if not runners:
        return None
    runners.sort(key=lambda j: (-int(j.get("steps", 0) or 0),
                                j.get("id", "")))
    return hot, runners[0], cold
