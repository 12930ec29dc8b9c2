"""Daemon operational metrics — Prometheus text exposition on ``/metrics``
(`tpu_tree_search/serve/metrics.py`: the same series, names and labels).

The serve daemon (``server.py``) already *has* every number an operator
needs — queue depth in the scheduler, per-class program counts in the
pool, job states in the registry, rebuild deltas on each job record —
but scattered across three components behind three locks, visible only
by scripting the JSON endpoints. This module aggregates them into the
one surface fleet tooling actually scrapes: ``GET /metrics`` in
Prometheus text exposition format (version 0.0.4), hand-rendered so the
serving path stays stdlib-only (no ``prometheus_client`` dependency).

Two kinds of series:

  * **Live gauges** read from the components at scrape time (queue
    depth, jobs by state, pool per-class stats, uptime, workers alive).
    Nothing is double-counted: the components stay the source of truth.
  * **Event counters / histograms** accumulated by ``ServeMetrics`` as
    the daemon runs (admission outcomes, 409 conflicts, preemptions,
    requeues, per-class slice counts; queue-wait / run-time / lease-wait
    histograms). These capture *flow* that no point-in-time component
    read can reconstruct.

Lock discipline: ``ServeMetrics``
has exactly one lock guarding only its own dicts. ``inc``/``observe``
never call out while holding it, so call sites inside scheduler/registry
critical sections cannot deadlock (metrics lock is always a leaf).
``render`` snapshots the metrics state under the metrics lock *first*,
then reads each live component under that component's own lock — never
two locks at once. Nothing here calls into torch: the pool's gauges are
Python attributes of the cached programs.
"""

from __future__ import annotations

import re
import threading
import time

#: Histogram bucket bounds, seconds. Spans sub-10ms warm-cache slices to
#: multi-minute searches; queue/lease waits land in the low buckets on a
#: healthy daemon, so growth in the tail is the saturation signal.
BUCKETS = (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
           10.0, 30.0, 60.0, 120.0, 300.0)

_COUNTER_HELP = {
    "tts_serve_admissions_total":
        "POST /submit outcomes (admitted / invalid / queue_full / draining).",
    "tts_serve_conflicts_total":
        "HTTP 409 conflict responses, by endpoint.",
    "tts_serve_preemptions_total":
        "Quantum preemptions (slice cut at a checkpoint, job requeued).",
    "tts_serve_requeues_total":
        "Jobs pushed back to queued without preemption (drain / re-submit).",
    "tts_serve_slices_total":
        "Engine slices run, by shape class.",
    "tts_serve_slots_spliced_total":
        "Jobs spliced into a batch slot, by shape class.",
    "tts_serve_slots_retired_total":
        "Batch slots retired (finished or cut), by shape class.",
}

_HIST_HELP = {
    "tts_serve_queue_wait_seconds":
        "Submit-to-first-slice wait, by shape class.",
    "tts_serve_run_seconds":
        "Per-slice engine wall time, by shape class.",
    "tts_serve_lease_wait_seconds":
        "Env-pin lease acquisition wait before a slice.",
    "tts_serve_batch_efficiency":
        "Live-slot fraction per batched dispatch (1.0 = full batch), "
        "by shape class.",
}


def _esc(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels) -> str:
    """``(("cls","pfsp-20x20"),)`` -> ``{cls="pfsp-20x20"}``."""
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in labels) + "}"


def _key(labels: dict | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


class ServeMetrics:
    """Monotonic counters + fixed-bucket histograms behind one leaf lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}  # guarded-by: _lock -- (name, labels) -> n
        # guarded-by: _lock -- (name, labels) -> [per-bucket counts, sum, n]
        self._hists: dict = {}

    def inc(self, name: str, labels: dict | None = None, v: int = 1) -> None:
        key = (name, _key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + v

    def observe(self, name: str, value: float,
                labels: dict | None = None) -> None:
        key = (name, _key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [[0] * (len(BUCKETS) + 1), 0.0, 0]
            i = 0
            while i < len(BUCKETS) and value > BUCKETS[i]:
                i += 1
            h[0][i] += 1
            h[1] += float(value)
            h[2] += 1

    def snapshot(self) -> tuple[dict, dict]:
        """Consistent copy of (counters, histograms) for rendering."""
        with self._lock:
            return (dict(self._counters),
                    {k: [list(h[0]), h[1], h[2]]
                     for k, h in self._hists.items()})


def _header(lines: list, name: str, typ: str, help_: str) -> None:
    lines.append(f"# HELP {name} {help_}")
    lines.append(f"# TYPE {name} {typ}")


def _gauge(lines: list, name: str, help_: str, samples: list) -> None:
    """``samples``: list of (labels-tuple, value)."""
    _header(lines, name, "gauge", help_)
    for labels, v in samples:
        lines.append(f"{name}{_fmt_labels(labels)} {v}")


def render(daemon) -> str:
    """The full ``/metrics`` payload for a :class:`~.server.ServeDaemon`.

    Component reads (registry / scheduler / pool) each take that
    component's own lock internally; nothing here holds two at once.
    """
    from . import VERSION
    from .jobs import STATES

    counters, hists = daemon.metrics.snapshot()  # metrics lock, released
    jobs = daemon.registry.all()          # registry lock, released
    depth = daemon.scheduler.queue_depth()  # scheduler cv, released
    pool_stats = daemon.pool.stats()      # pool lock, released

    lines: list[str] = []
    _gauge(lines, "tts_serve_build_info",
           "Daemon build/version (value is always 1).",
           [(((("version", VERSION),)), 1)])
    _gauge(lines, "tts_serve_uptime_seconds",
           "Seconds since the daemon started.",
           [((), round(max(0.0, time.time() - daemon.started), 3))])
    _gauge(lines, "tts_serve_queue_depth",
           "Jobs waiting in the scheduler run queue.", [((), depth)])
    _gauge(lines, "tts_serve_workers_alive",
           "Scheduler worker threads currently alive.",
           [((), daemon.scheduler.workers_alive())])
    _gauge(lines, "tts_serve_batch_slots",
           "Configured instance-batch slots per batched program "
           "(--batch-slots; 1 = batching off).",
           [((), daemon.scheduler.batch_slots)])
    batch = daemon.scheduler.batch_stats()  # batch lock, released
    if batch:
        _gauge(lines, "tts_serve_batch_slots_occupied",
               "Batch slots currently holding a live job, by shape class.",
               sorted(((("cls", b["class"]),), int(b["occupied"]))
                      for b in batch))

    by_state: dict = {s: 0 for s in STATES}
    by_class_state: dict = {}
    new_prog: dict = {}
    new_steps: dict = {}
    for j in jobs:
        by_state[j.state] = by_state.get(j.state, 0) + 1
        ck = (("cls", j.class_key), ("state", j.state))
        by_class_state[ck] = by_class_state.get(ck, 0) + 1
        cls = (("cls", j.class_key),)
        new_prog[cls] = new_prog.get(cls, 0) + int(j.new_programs or 0)
        new_steps[cls] = (new_steps.get(cls, 0)
                         + int(j.new_step_compiles or 0))
    _gauge(lines, "tts_serve_jobs", "Jobs in the registry, by state.",
           [((("state", s),), n) for s, n in sorted(by_state.items())])
    _gauge(lines, "tts_serve_class_jobs",
           "Jobs in the registry, by shape class and state.",
           sorted(by_class_state.items()))

    # Compile deltas are per-job monotonic facts summed over an
    # append-only registry, so exposing them as counters is sound.
    _header(lines, "tts_serve_new_programs_total", "counter",
            "Fresh program-cache entries attributed to jobs, by class.")
    for cls, n in sorted(new_prog.items()):
        lines.append(f"tts_serve_new_programs_total{_fmt_labels(cls)} {n}")
    _header(lines, "tts_serve_new_step_compiles_total", "counter",
            "Dispatch graphs built, attributed to jobs, by class (the JAX "
            "daemon's step-fn compiles).")
    for cls, n in sorted(new_steps.items()):
        lines.append(
            f"tts_serve_new_step_compiles_total{_fmt_labels(cls)} {n}")

    _gauge(lines, "tts_serve_pool_classes",
           "Shape classes resident in the program pool.",
           [((), len(pool_stats))])
    by_class = sorted(pool_stats, key=lambda st: st.get("class", ""))
    for metric, field, help_ in (
        ("tts_serve_class_programs", "programs",
         "Compiled programs resident, by shape class."),
        ("tts_serve_class_step_cache_entries", "step_cache_entries",
         "Dispatch graphs built on the class's programs, by shape class."),
        ("tts_serve_class_warm", "warm",
         "1 if the class program is warm (built and run), by shape class."),
        ("tts_serve_class_jobs_admitted", "jobs_admitted",
         "Jobs ever admitted, by shape class."),
        ("tts_serve_pool_bytes", "pool_bytes",
         "Device-resident pool bytes across the class's cached programs "
         "(capacity x per-node pool bytes x slots), read at scrape time."),
    ):
        _gauge(lines, metric, help_,
               [((("cls", st.get("class", "?")),), int(st.get(field, 0)))
                for st in by_class])

    by_name: dict = {}
    for (name, labels), v in counters.items():
        by_name.setdefault(name, []).append((labels, v))
    for name in sorted(by_name):
        _header(lines, name, "counter",
                _COUNTER_HELP.get(name, "Daemon event counter."))
        for labels, v in sorted(by_name[name]):
            lines.append(f"{name}{_fmt_labels(labels)} {v}")

    hist_by_name: dict = {}
    for (name, labels), h in hists.items():
        hist_by_name.setdefault(name, []).append((labels, h))
    for name in sorted(hist_by_name):
        _header(lines, name, "histogram",
                _HIST_HELP.get(name, "Daemon latency histogram."))
        for labels, (bucket_counts, total, count) in sorted(
                hist_by_name[name]):
            cum = 0
            for bound, n in zip(BUCKETS, bucket_counts):
                cum += n
                lab = labels + (("le", f"{bound}"),)
                lines.append(f"{name}_bucket{_fmt_labels(lab)} {cum}")
            cum += bucket_counts[-1]
            lab = labels + (("le", "+Inf"),)
            lines.append(f"{name}_bucket{_fmt_labels(lab)} {cum}")
            lines.append(
                f"{name}_sum{_fmt_labels(labels)} {round(total, 6)}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {count}")
    return "\n".join(lines) + "\n"


#: Content-Type for the exposition format.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'        # metric name
    r'(?:\{(.*)\})?'                      # optional label body
    r'\s+(-?(?:[0-9.eE+-]+|\+?Inf|NaN))$')  # value
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_text(text: str) -> dict:
    """Lenient exposition-format parser (for tests and ``tts top``):
    ``{name: {labels-tuple: value}}``. Raises ``ValueError`` on a
    malformed sample line, so tests double as a format check."""
    out: dict = {}
    for ln in text.splitlines():
        if not ln.strip() or ln.startswith("#"):
            continue
        m = _SAMPLE_RE.match(ln)
        if m is None:
            raise ValueError(f"unparseable metrics line: {ln!r}")
        name, body, val = m.groups()
        labels = []
        if body:
            labels = [(k, v.replace('\\"', '"').replace("\\n", "\n")
                       .replace("\\\\", "\\"))
                      for k, v in _LABEL_RE.findall(body)]
        out.setdefault(name, {})[tuple(labels)] = float(val)
    return out
