"""Trace and metrics exporters (the port of `tpu_tree_search/obs/export.py`;
the same formats).

Two artifact formats, both written from the same drained event list:

  * **Chrome trace event JSON** (``write_chrome_trace``) — the
    ``{"traceEvents": [...]}`` object format, loadable in Perfetto
    (ui.perfetto.dev) or ``chrome://tracing``. One process row per host,
    one thread track per worker (plus a communicator track), counter
    events as counter tracks. Events are already recorded in this shape
    (``events.py``), so export is metadata + dump, not translation.
  * **metrics JSON lines** (``write_metrics_jsonl``) — one flat JSON
    object per counter sample (``ph == "C"``), suitable for scraping /
    `jq` / pandas; the machine-readable companion of the reference's
    appended ``stats_*.dat`` lines (`pfsp_gpu_cuda.c:140-148`).
"""

from __future__ import annotations

import json

from .events import COMM_TID


def _track_name(tid: int) -> str:
    if tid == COMM_TID:
        return "communicator"
    return f"worker{tid}"


#: tid base for synthetic per-job lanes (clear of worker ids and the
#: communicator track).
JOB_TID_BASE = 2000


def _job_lanes(evts: list[dict]) -> tuple[list[dict], dict]:
    """Remap job-stamped events (``events.job_context``, stamped by the
    serve scheduler) onto one synthetic thread lane per job, so a merged
    daemon trace renders per-job rows instead of interleaving every
    tenant's spans on one worker track. Events without a ``job`` field
    pass through untouched; lane ids are stable (sorted job order)."""
    jobs = sorted({e["job"] for e in evts
                   if isinstance(e, dict) and e.get("job") is not None})
    if not jobs:
        return evts, {}
    lane = {j: JOB_TID_BASE + i for i, j in enumerate(jobs)}
    out = []
    for e in evts:
        j = e.get("job") if isinstance(e, dict) else None
        if j is not None:
            e = {**e, "tid": lane[j]}
        out.append(e)
    return out, {lane[j]: j for j in jobs}


def chrome_trace_object(evts: list[dict], label: str = "tts") -> dict:
    """The full Chrome-trace object for a drained event list (metadata
    process/thread-name records prepended for every (pid, tid) seen)."""
    evts, job_lanes = _job_lanes(evts)
    meta: list[dict] = []
    pids = sorted({e.get("pid", 0) for e in evts})
    tracks = sorted({(e.get("pid", 0), e.get("tid", 0)) for e in evts})
    for pid in pids:
        meta.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{label} host{pid}"},
        })
    for pid, tid in tracks:
        meta.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": job_lanes.get(tid) or _track_name(tid)},
        })
    other = {"producer": "tpu_tree_search_torch obs"}
    # Dispatch-pipeline metadata (span semantics):
    # the resident engines emit one "pipeline" instant at phase-2 start;
    # a reader needs the depth to interpret overlapping dispatch spans.
    pipe = next(
        (e.get("args") or {} for e in evts if e.get("name") == "pipeline"),
        None,
    )
    if pipe is not None:
        other["pipeline_depth"] = pipe.get("depth", 1)
        if "K" in pipe:
            other["k_initial"] = pipe["K"]
        if "k_auto" in pipe:
            other["k_auto"] = pipe["k_auto"]
    return {
        "traceEvents": meta + evts,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def _fsync(f) -> None:
    """Flush + fsync (durability satellite: the tail of a killed run must
    survive — an OS-buffered write dies with the process)."""
    f.flush()
    try:
        import os

        os.fsync(f.fileno())
    except OSError:
        pass  # exotic filesystems; the flush already left the process


def write_chrome_trace(evts: list[dict], path: str, label: str = "tts") -> int:
    """Write the trace file (fsync'd); returns the event count (sans
    metadata)."""
    with open(path, "w") as f:
        json.dump(chrome_trace_object(evts, label=label), f)
        _fsync(f)
    return len(evts)


def load_trace(path: str) -> list[dict]:
    """Read back a trace file (either the object format this module writes
    or a bare event array) minus metadata records."""
    with open(path) as f:
        obj = json.load(f)
    evts = obj["traceEvents"] if isinstance(obj, dict) else obj
    return [e for e in evts if e.get("ph") != "M"]


def _metrics_line_event(rec: dict) -> dict:
    """A metrics-JSONL record back into counter-event shape, so the report
    summarizer consumes traces and metrics files interchangeably."""
    args = {k: v for k, v in rec.items()
            if k not in ("ts_us", "name", "host", "worker")}
    return {
        "name": rec.get("name", ""), "cat": "metrics", "ph": "C",
        "ts": rec.get("ts_us", 0.0), "pid": rec.get("host", 0),
        "tid": rec.get("worker", 0), "args": args,
    }


def _salvage_truncated(text: str) -> list[dict]:
    """Best-effort event recovery from a truncated trace: a killed writer
    leaves a prefix of the ``{"traceEvents": [...`` object — walk the
    array with ``raw_decode`` and keep every complete event object."""
    start = text.find("[")
    if start < 0:
        return []
    dec = json.JSONDecoder()
    evts: list[dict] = []
    i = start + 1
    n = len(text)
    while i < n:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] != "{":
            break
        try:
            obj, end = dec.raw_decode(text, i)
        except ValueError:
            break
        if isinstance(obj, dict):
            evts.append(obj)
        i = end
    return evts


def load_trace_lenient(path: str) -> tuple[list[dict], str | None]:
    """Load a trace, a metrics JSONL, or the readable prefix of either —
    the ``report`` robustness contract: report what exists. Returns
    ``(events, warning)``; raises ``OSError`` only when the file cannot
    be read at all."""
    with open(path) as f:
        text = f.read()
    if not text.strip():
        return [], f"{path}: empty file"
    try:
        obj = json.loads(text)
    except ValueError:
        obj = None
    if isinstance(obj, dict) and isinstance(obj.get("traceEvents"), list):
        return ([e for e in obj["traceEvents"] if isinstance(e, dict)
                 and e.get("ph") != "M"], None)
    if isinstance(obj, list):
        return ([e for e in obj if isinstance(e, dict)
                 and e.get("ph") != "M"], None)
    # Not one whole JSON document: metrics JSONL, or a truncated trace.
    lines = text.splitlines()
    recs = []
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except ValueError:
            continue  # torn tail line from a mid-write kill
        if isinstance(rec, dict):
            recs.append(rec)
    if recs:
        if "ph" in recs[0]:  # a JSONL of raw events
            return ([e for e in recs if e.get("ph") != "M"],
                    f"{path}: read as event JSONL ({len(recs)} lines)")
        return ([_metrics_line_event(r) for r in recs],
                f"{path}: read as metrics JSONL ({len(recs)} lines)")
    evts = [e for e in _salvage_truncated(text) if e.get("ph") != "M"]
    if evts:
        return evts, f"{path}: truncated trace, salvaged {len(evts)} events"
    return [], f"{path}: unrecognized/corrupt content, no events recovered"


def metrics_lines(evts: list[dict]) -> list[dict]:
    """Flatten counter samples to scrape-ready records."""
    out = []
    for e in evts:
        if e.get("ph") != "C":
            continue
        rec = {
            "ts_us": e.get("ts", 0.0),
            "name": e.get("name", ""),
            "host": e.get("pid", 0),
            "worker": e.get("tid", 0),
        }
        rec.update(e.get("args") or {})
        out.append(rec)
    return out


def write_metrics_jsonl(evts: list[dict], path: str) -> int:
    """Append one JSON line per counter sample; returns the line count.
    Append mode on purpose — like the reference's ``--stats-file``, repeat
    runs accumulate into one scrapeable file."""
    lines = metrics_lines(evts)
    with open(path, "a") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
        _fsync(f)
    return len(lines)
