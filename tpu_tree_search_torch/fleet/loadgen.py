"""Seeded synthetic fleet traffic + the saturation-curve runner (the port
of `tpu_tree_search/fleet/loadgen.py`; a library: the port has no bench
yet).

The tests (tests/test_torch_fleet.py) drive a router with a
reproducible open-loop workload: **Poisson arrivals** (exponential
inter-arrival gaps at a fixed offered rate — an open system, so queueing
delay shows up as queue wait instead of throttling the generator),
**mixed shape classes** (round-robin-free random draws over a small
class mix, exercising warm placement and cold spills), and
**heavy-tailed job sizes** (Pareto-distributed ``max_steps``, capped —
most jobs are small, a few are long-runners, which is what makes
rebalancing and checkpointed recovery worth having).

Everything is driven by one ``random.Random(seed)``: ``make_plan`` is a
pure function of its arguments (pinned by a test), so a saturation curve
is re-runnable bit-for-bit at the plan level and comparable across
daemons/routers. The measured side reads each job's daemon record:
queue wait is ``started - submitted`` — the daemon's own clock, the same
quantity its ``tts_serve_queue_wait_seconds`` histogram observes.
"""

from __future__ import annotations

import random
import threading
import time

from ..serve.client import _get, _post

#: The default class mix: three nqueens shape classes small enough to
#: run on the CPU in tests, distinct in class key (N and M
#: both feed serve/pool.class_key). Weights skew toward one "hot" class
#: so warm placement has something to be right about.
DEFAULT_CLASSES = [
    {"spec": {"problem": "nqueens", "N": 10, "M": 256}, "weight": 3},
    {"spec": {"problem": "nqueens", "N": 11, "M": 256}, "weight": 2},
    {"spec": {"problem": "nqueens", "N": 10, "M": 128}, "weight": 1},
]


def make_plan(seed: int, n_jobs: int, rate_per_s: float,
              classes: list | None = None, steps_scale: int = 24,
              steps_cap: int = 600, pareto_alpha: float = 1.5) -> list:
    """The deterministic workload: ``n_jobs`` arrivals as
    ``[{at_s, spec}, ...]`` sorted by offset. ``max_steps`` ~
    ``steps_scale * Pareto(alpha)`` capped at ``steps_cap`` (alpha 1.5:
    infinite variance, the classic heavy tail). Same arguments -> same
    plan, exactly."""
    rng = random.Random(seed)
    classes = classes or DEFAULT_CLASSES
    weights = [float(c.get("weight", 1)) for c in classes]
    t = 0.0
    plan = []
    for i in range(int(n_jobs)):
        t += rng.expovariate(rate_per_s)
        cls = rng.choices(classes, weights=weights, k=1)[0]
        steps = min(int(steps_cap),
                    max(8, int(steps_scale * rng.paretovariate(pareto_alpha))))
        spec = dict(cls["spec"])
        spec["max_steps"] = steps
        spec["label"] = f"loadgen-{seed}-{i:04d}"
        plan.append({"at_s": round(t, 6), "spec": spec})
    return plan


def _submit_worker(base: str, item: dict, t_zero: float, out: list,
                   lock: threading.Lock) -> None:
    delay = t_zero + item["at_s"] - time.monotonic()
    if delay > 0:
        time.sleep(delay)
    row = {"at_s": item["at_s"], "spec": item["spec"], "id": None,
           "error": None}
    try:
        code, resp = _post(base + "/submit", item["spec"], timeout=60.0,
                           retry_s=5.0)
        if code == 201:
            row["id"] = resp["id"]
            row["placement"] = resp.get("placement")
        else:
            row["error"] = f"{code}: {resp.get('error', resp)}"
    except (OSError, ValueError) as e:
        row["error"] = f"{type(e).__name__}: {e}"
    with lock:
        out.append(row)


def run_plan(router_url: str, plan: list, timeout_s: float = 600.0) -> dict:
    """Fire a plan at the router (open loop: one timer thread per
    arrival, so a slow admission never delays the next arrival), then
    poll every admitted job to a terminal state and measure.

    Returns ``{jobs: [...], summary: {...}, per_class: {...}}`` where
    each job row carries the daemon-clock ``queue_wait_ms``, final
    state, steps, and the placement decision the router made."""
    base = router_url.rstrip("/")
    if "://" not in base:
        base = "http://" + base
    rows: list = []
    lock = threading.Lock()
    t_zero = time.monotonic() + 0.05
    threads = [threading.Thread(target=_submit_worker,
                                args=(base, item, t_zero, rows, lock),
                                daemon=True)
               for item in plan]
    t_wall = time.time()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout_s)
    final = ("done", "failed", "cancelled")
    deadline = time.monotonic() + timeout_s
    for row in rows:
        if row["id"] is None:
            continue
        rec = None
        while time.monotonic() < deadline:
            try:
                code, rec = _get(f"{base}/job/{row['id']}", timeout=10.0,
                                 retry_s=5.0)
            except (OSError, ValueError):
                time.sleep(0.5)
                continue
            if code == 200 and rec.get("state") in final \
                    and not rec.get("stale"):
                break
            time.sleep(0.2)
        if rec is None or rec.get("state") not in final:
            row["state"] = "timeout"
            continue
        row["state"] = rec["state"]
        row["steps"] = rec.get("steps", 0)
        row["daemon"] = rec.get("daemon")
        row["resubmits"] = rec.get("resubmits", 0)
        started, submitted = rec.get("started"), rec.get("submitted")
        if started is not None and submitted is not None:
            row["queue_wait_ms"] = round(1000.0 * max(0.0,
                                                      started - submitted), 3)
    wall_s = max(1e-9, time.time() - t_wall)
    return {"jobs": rows, "summary": _summarize(rows, wall_s),
            "per_class": _per_class(rows)}


def _quantile(xs: list, q: float) -> float:
    """Nearest-rank quantile — 10-sample p99 must be the max, not an
    interpolated fiction."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[k]


def _class_of(spec: dict) -> str:
    """A human-stable class label for reporting (the router's real class
    key is opaque and long): problem + the shape fields that feed it."""
    keep = ("problem", "N", "M", "K", "tier", "lb")
    return ",".join(f"{k}={spec[k]}" for k in keep if spec.get(k)
                    is not None)


def _summarize(rows: list, wall_s: float) -> dict:
    done = [r for r in rows if r.get("state") == "done"]
    waits = [r["queue_wait_ms"] for r in done if "queue_wait_ms" in r]
    return {
        "offered": len(rows),
        "admitted": sum(1 for r in rows if r.get("id")),
        "done": len(done),
        "failed": sum(1 for r in rows
                      if r.get("state") in ("failed", "cancelled")),
        "timeout": sum(1 for r in rows if r.get("state") == "timeout"),
        "rejected": sum(1 for r in rows
                        if r.get("id") is None),
        "achieved_jobs_per_s": round(len(done) / wall_s, 4),
        "queue_wait_ms_p50": round(_quantile(waits, 0.50), 3),
        "queue_wait_ms_p99": round(_quantile(waits, 0.99), 3),
        "wall_s": round(wall_s, 3),
    }


def _per_class(rows: list) -> dict:
    out: dict = {}
    for r in rows:
        if r.get("state") != "done" or "queue_wait_ms" not in r:
            continue
        out.setdefault(_class_of(r["spec"]), []).append(r["queue_wait_ms"])
    return {cls: {"done": len(waits),
                  "queue_wait_ms_p50": round(_quantile(waits, 0.50), 3),
                  "queue_wait_ms_p99": round(_quantile(waits, 0.99), 3)}
            for cls, waits in sorted(out.items())}


def saturation_curve(router_url: str, rates: list, seed: int = 0,
                     jobs_per_rate: int = 12, classes: list | None = None,
                     steps_scale: int = 24, steps_cap: int = 600,
                     timeout_s: float = 600.0, on_point=None) -> list:
    """The ``fleet_sat`` ladder: one ``run_plan`` per offered rate,
    ascending, each from a derived seed (``seed*1000 + step``) so points
    are independent but the whole curve re-runs identically. Returns one
    row per rate: offered jobs/s, achieved jobs/s, p50/p99 queue wait
    (overall and per class). ``on_point(row)`` fires after each rate — a
    caller banks partial curves through it, so a wall-clock cap still
    leaves a usable prefix."""
    curve = []
    for i, rate in enumerate(rates):
        plan = make_plan(seed * 1000 + i, jobs_per_rate, rate,
                         classes=classes, steps_scale=steps_scale,
                         steps_cap=steps_cap)
        res = run_plan(router_url, plan, timeout_s=timeout_s)
        row = {"offered_jobs_per_s": rate, **res["summary"],
               "per_class": res["per_class"]}
        curve.append(row)
        if on_point is not None:
            on_point(row)
    return curve
