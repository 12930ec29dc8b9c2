"""``python -m tpu_tree_search_torch report <trace>`` — summarize a recorded
trace (the port of `tpu_tree_search/obs/report.py`; either package's trace
reads in either package's report).

Consumes the Chrome-trace JSON written by ``--trace`` (or a drained event
list) and prints the three summaries the load-balancing literature reads
off exactly this kind of per-round telemetry (Helbecque et al.,
arXiv:2012.09511; Melab et al., arXiv:0809.3285):

  * **steal efficiency** — successful steals / attempts, nodes moved,
    plus the inter-host donation and exchange-round totals;
  * **idle fraction per worker** — recorded idle spans over the trace
    span, the direct per-worker imbalance metric;
  * **cycle-rate timeline** — bucketed device cycles/sec and explored
    nodes/sec over the run, from the per-dispatch events.

All three sections always print (zeros / "none recorded" when a tier has
no such events) so downstream tooling can parse unconditionally.
"""

from __future__ import annotations

import json

from .events import COMM_TID


def _span_us(evts: list[dict]) -> tuple[float, float]:
    if not evts:
        return 0.0, 0.0
    t0 = min(e.get("ts", 0.0) for e in evts)
    t1 = max(e.get("ts", 0.0) + e.get("dur", 0.0) for e in evts)
    return t0, t1


def summarize(evts: list[dict], buckets: int = 10,
              costmodel: dict | None = None) -> dict:
    """Structured summary of a drained/loaded event list.

    ``costmodel`` is an optional loaded COSTMODEL.json profile
    (obs/costmodel.py) consulted for a measured ``hbm`` link when the
    trace carries the inputs for a roofline audit."""
    t0, t1 = _span_us(evts)
    span_s = max(t1 - t0, 0.0) / 1e6

    # -- steal / donation efficiency --------------------------------------
    steals = [e for e in evts if e.get("name") == "steal"]
    misses = [e for e in evts if e.get("name") == "steal_miss"]
    attempts = len(steals) + len(misses)
    stolen_nodes = sum((e.get("args") or {}).get("nodes", 0) for e in steals)
    sends = [e for e in evts if e.get("name") == "donate_send"]
    recvs = [e for e in evts if e.get("name") == "donate_recv"]
    rounds = sum(1 for e in evts if e.get("name") == "exchange")
    steal = {
        "attempts": attempts,
        "successes": len(steals),
        "efficiency": (len(steals) / attempts) if attempts else None,
        "nodes_moved": stolen_nodes,
        "interhost_blocks_sent": len(sends),
        "interhost_nodes_sent": sum(
            (e.get("args") or {}).get("nodes", 0) for e in sends
        ),
        "interhost_blocks_received": len(recvs),
        "exchange_rounds": rounds,
    }

    # -- per-link-class steal table (TTS_STEAL, parallel/topology.py) ------
    # Steal-path events stamp their link class (local / ici / dcn) and
    # hierarchy level; bucketing them per class is the observable form of
    # the two-level policy. Acquisition cost is the span duration of the
    # events that DELIVER work (local steal + donate_recv) — the same
    # samples the cost model's steal/donate fits consume; donate_send
    # counts as the inter-host attempt. Traces predating the stamps (no
    # "link" arg) simply produce an empty table.
    steal_links: dict = {}

    def _link_bucket(link: str) -> dict:
        return steal_links.setdefault(link, {
            "attempts": 0, "hits": 0, "misses": 0,
            "nodes": 0, "bytes": 0, "_cost_us": 0.0, "_cost_n": 0,
        })

    for e in steals:
        a = e.get("args") or {}
        if a.get("link") is None:
            continue
        b = _link_bucket(a["link"])
        b["attempts"] += 1
        b["hits"] += 1
        b["nodes"] += a.get("nodes", 0)
        b["bytes"] += a.get("bytes", 0)
        if "dur" in e:
            b["_cost_us"] += e["dur"]
            b["_cost_n"] += 1
    for e in misses:
        a = e.get("args") or {}
        if a.get("link") is None:
            continue
        b = _link_bucket(a["link"])
        b["attempts"] += 1
        b["misses"] += 1
    for e in sends:
        a = e.get("args") or {}
        if a.get("link") is None:
            continue
        _link_bucket(a["link"])["attempts"] += 1
    for e in recvs:
        a = e.get("args") or {}
        if a.get("link") is None:
            continue
        b = _link_bucket(a["link"])
        b["hits"] += 1
        b["nodes"] += a.get("nodes", 0)
        b["bytes"] += a.get("bytes", 0)
        if "dur" in e:
            b["_cost_us"] += e["dur"]
            b["_cost_n"] += 1
    for b in steal_links.values():
        n = b.pop("_cost_n")
        us = b.pop("_cost_us")
        b["mean_cost_us"] = round(us / n, 1) if n else None

    # -- idle fraction per worker -----------------------------------------
    # Busy time is the UNION of dispatch/chunk spans, not their sum: under
    # pipelined dispatch (TTS_PIPELINE >= 2) a track carries up to `depth`
    # overlapping enqueue->scalars-ready spans at once, and summing them
    # would claim more busy time than wall time — the idle/busy fractions
    # must stay truthful at any depth (busy time is a union).
    workers: dict[str, dict] = {}
    busy_ivals: dict[str, list] = {}
    for e in evts:
        tid = e.get("tid", 0)
        if tid == COMM_TID:
            continue
        key = f"h{e.get('pid', 0)}/w{tid}"
        w = workers.setdefault(key, {"idle_us": 0.0, "busy_us": 0.0})
        if e.get("name") == "idle":
            w["idle_us"] += e.get("dur", 0.0)
        elif e.get("name") in ("dispatch", "chunk") and "dur" in e:
            ts = e.get("ts", 0.0)
            busy_ivals.setdefault(key, []).append((ts, ts + e["dur"]))
    for key, ivals in busy_ivals.items():
        ivals.sort()
        total = 0.0
        cur_s, cur_e = ivals[0]
        for s, e_ in ivals[1:]:
            if s <= cur_e:
                cur_e = max(cur_e, e_)
            else:
                total += cur_e - cur_s
                cur_s, cur_e = s, e_
        total += cur_e - cur_s
        workers[key]["busy_us"] = total
    idle = {
        key: {
            "idle_fraction": (w["idle_us"] / (t1 - t0)) if t1 > t0 else 0.0,
            "busy_fraction": (w["busy_us"] / (t1 - t0)) if t1 > t0 else 0.0,
        }
        for key, w in sorted(workers.items())
    }

    # -- cycle-rate timeline ----------------------------------------------
    # Resident tiers emit per-dispatch spans; the offload tiers (multi/
    # dist workers) emit per-chunk spans instead — use whichever exists so
    # every tier gets a rate timeline (chunk events carry no device cycle
    # count; their cycles contribution is 0).
    dispatches = [e for e in evts if e.get("name") == "dispatch"]
    if not dispatches:
        dispatches = [e for e in evts if e.get("name") == "chunk"]
    timeline = []
    if dispatches and t1 > t0:
        nb = min(buckets, max(1, len(dispatches)))
        width = (t1 - t0) / nb
        acc = [{"cycles": 0, "nodes": 0, "dispatches": 0} for _ in range(nb)]
        for e in dispatches:
            # Attribute at completion: the counters were harvested then.
            end = e.get("ts", 0.0) + e.get("dur", 0.0)
            b = min(nb - 1, int((end - t0) / width))
            a = e.get("args") or {}
            acc[b]["cycles"] += a.get("cycles", 0)
            acc[b]["nodes"] += a.get("tree", 0)
            acc[b]["dispatches"] += 1
        for i, a in enumerate(acc):
            sec = width / 1e6
            timeline.append({
                "t_s": round(i * width / 1e6, 3),
                "cycles_per_sec": round(a["cycles"] / sec, 1),
                "nodes_per_sec": round(a["nodes"] / sec, 1),
                "dispatches": a["dispatches"],
            })

    counters_total: dict = {}
    for e in evts:
        if e.get("name") == "device_counters":
            for k, v in (e.get("args") or {}).items():
                if k in ("pool_hwm", "surv_hwm"):
                    counters_total[k] = max(counters_total.get(k, 0), v)
                else:
                    counters_total[k] = counters_total.get(k, 0) + v

    # -- per-phase cycle decomposition (TTS_PHASEPROF, obs/phases.py) ------
    # device_phases counter samples carry per-dispatch nanoseconds per
    # phase; their sum is the run's measured on-device cycle split.
    phases_total: dict = {}
    for e in evts:
        if e.get("name") == "device_phases":
            for k, v in (e.get("args") or {}).items():
                if isinstance(v, (int, float)):
                    phases_total[k] = phases_total.get(k, 0) + v
    phase_decomp = None
    if phases_total.get("total"):
        from . import phases as phases_mod

        phase_decomp = phases_mod.decomp(phases_total)

    # -- memory-roofline audit (obs/roofline.py) ---------------------------
    # Needs four things a phase-profiled trace carries: the static shape
    # facts (the resident loop's `roofline_meta` event), the measured phase
    # splits above, the counter totals (the byte floors: the rows this run
    # moved) and the per-dispatch device cycle counts. Absent any one of
    # them the section is simply None — the `--roofline` flag turns that
    # into a hard requirement.
    roofline = None
    metas = [e for e in evts if e.get("name") == "roofline_meta"]
    if metas and phases_total.get("total"):
        cycles = sum(
            (e.get("args") or {}).get("cycles", 0) for e in dispatches
        )
        if cycles > 0:
            from . import roofline as roofline_mod

            roofline = roofline_mod.from_meta(
                metas[-1].get("args") or {}, phases_total, cycles,
                costmodel=costmodel, counters=counters_total,
            )

    # -- survivor-path work split (maintenance vs evaluator) ---------------
    # The resident cycle does two kinds of work: the evaluator bounds every
    # candidate child (pushed + leaves + pruned evaluations), and the
    # survivor path pops/compacts/pushes rows (push_rows — the fused path
    # touches its full budget per cycle regardless of how many children
    # survived). This is the WORK split; the phase clock (TTS_PHASEPROF)
    # gives the time split.
    survivor = None
    if counters_total.get("push_rows"):
        evals = (counters_total.get("pushed", 0)
                 + counters_total.get("leaves", 0)
                 + counters_total.get("pruned", 0))
        pushed = counters_total.get("pushed", 0)
        survivor = {
            "eval_rows": evals,
            "push_rows": counters_total["push_rows"],
            "push_rows_per_survivor": (
                round(counters_total["push_rows"] / pushed, 2) if pushed
                else None
            ),
            "overflow_cycles": counters_total.get("overflow", 0),
        }

    # -- per-job lanes (serve traces; events.job_context stamps) -----------
    # A merged daemon trace interleaves every tenant's events; the job
    # field (stamped by the scheduler around each slice) groups them back
    # into the per-job view an operator reads.
    jobs_seen = sorted({e["job"] for e in evts if e.get("job") is not None})
    job_lanes: dict = {}
    for j in jobs_seen:
        je = [e for e in evts if e.get("job") == j]
        jt0, jt1 = _span_us(je)
        disp = [e for e in je if e.get("name") in ("dispatch", "chunk")]
        bests = [
            b for b in ((e.get("args") or {}).get("best") for e in disp)
            if b is not None
        ]
        # Batched dispatches (serve/batch.py) stamp the slot index and
        # batch width onto each dispatch span; a job that was spliced,
        # cut, and re-admitted legitimately shows more than one slot.
        slots = sorted({
            s for s in ((e.get("args") or {}).get("slot") for e in disp)
            if s is not None
        })
        widths = [
            b for b in ((e.get("args") or {}).get("B") for e in disp)
            if b is not None
        ]
        job_lanes[j] = {
            "events": len(je),
            "dispatches": len(disp),
            "span_s": round(max(jt1 - jt0, 0.0) / 1e6, 6),
            "best": min(bests) if bests else None,
            "slots": slots or None,
            "batch_width": max(widths) if widths else None,
        }

    # -- anytime quality (obs/quality.py; incumbent + quality_ref events) --
    refs = [e for e in evts if e.get("name") == "quality_ref"]
    ref_args = (refs[-1].get("args") or {}) if refs else {}
    optimum = ref_args.get("optimum")
    incumbents = [e for e in evts if e.get("name") == "incumbent"]
    quality = None
    if incumbents:
        from . import quality as quality_mod

        by_job: dict = {}
        for e in incumbents:
            by_job.setdefault(e.get("job") or "-", []).append({
                "t_s": round(max(0.0, e.get("ts", 0.0) - t0) / 1e6, 6),
                "best": (e.get("args") or {}).get("best"),
            })
        jobs_q = {}
        for key, pts in sorted(by_job.items()):
            pts.sort(key=lambda p: p["t_s"])
            for p in pts:
                g = quality_mod.primal_gap(p["best"], optimum)
                p["gap"] = None if g is None else round(g, 6)
            pi = quality_mod.primal_integral(pts, optimum, span_s)
            jobs_q[key] = {
                "points": pts,
                "final_best": pts[-1]["best"],
                "final_gap": pts[-1]["gap"],
                "primal_integral": None if pi is None else round(pi, 6),
            }
        quality = {
            "instance": ref_args.get("instance"),
            "optimum": optimum,
            "jobs": jobs_q,
        }

    return {
        "events": len(evts),
        "span_s": round(span_s, 6),
        "hosts": len({e.get("pid", 0) for e in evts}),
        "steal": steal,
        "steal_links": steal_links,
        "idle": idle,
        "cycle_rate": timeline,
        "device_counters": counters_total,
        "survivor_path": survivor,
        "phase_decomp": phase_decomp,
        "roofline": roofline,
        "jobs": job_lanes,
        "quality": quality,
    }


#: Human names for the phase slots (the decomposition table + the
#: "next structural cost" line use these, not the internal slugs).
_PHASE_LABELS = {
    "pop": "pop/select",
    "eval": "bound evaluation",
    "compact": "compaction",
    "push": "fused prune+push",
    "overflow": "overflow branch",
    "balance": "steal/exchange (mesh)",
    "loop": "loop overhead",
}


def phase_table(decomp: dict) -> list[str]:
    """The ``report`` / ``profile`` decomposition table: one line
    per phase (measured device ns + share of the cycle), closed by the
    dominant-phase call-out — the "measured cycle decomposition naming
    the next structural cost" deliverable of ROADMAP item 1."""
    ns = decomp.get("ns", {})
    sh = decomp.get("shares", {})
    out = ["phase decomposition (on-device cycle clocks, ns):"]
    for slot in ("pop", "eval", "compact", "push", "overflow"):
        out.append(
            f"  {_PHASE_LABELS[slot]:<22} {ns.get(slot, 0):>14,}  "
            f"{100.0 * sh.get(slot, 0.0):5.1f}% of cycle"
        )
    out.append(f"  {'cycle total':<22} {ns.get('total', 0):>14,}")
    for slot in ("balance", "loop"):
        if ns.get(slot):
            out.append(
                f"  {_PHASE_LABELS[slot]:<22} {ns.get(slot, 0):>14,}  "
                "(outside the cycle)"
            )
    if decomp.get("dominant"):
        out.append(
            f"  next structural cost: {_PHASE_LABELS[decomp['dominant']]}, "
            f"{100.0 * decomp.get('dominant_share', 0.0):.0f}% of cycle"
        )
    return out


def render(summary: dict) -> str:
    """Human-readable report text."""
    out = []
    out.append(
        f"trace: {summary['events']} events over {summary['span_s']:.3f}s "
        f"across {summary['hosts']} host(s)"
    )
    s = summary["steal"]
    if s["attempts"]:
        eff = 100.0 * s["efficiency"]
        out.append(
            f"steal efficiency: {s['successes']}/{s['attempts']} attempts "
            f"({eff:.1f}%), {s['nodes_moved']} nodes moved"
        )
    else:
        out.append("steal efficiency: no steal attempts recorded")
    out.append(
        f"inter-host: {s['exchange_rounds']} exchange round(s), "
        f"{s['interhost_blocks_sent']} block(s) / "
        f"{s['interhost_nodes_sent']} node(s) donated"
    )
    if summary.get("steal_links"):
        # Cheapest link class first — the victim-selection escalation
        # order of the hierarchical policy (parallel/topology.py).
        order = {"local": 0, "ici": 1, "dcn": 2}
        out.append("steal table per link class:")
        for link, b in sorted(summary["steal_links"].items(),
                              key=lambda kv: (order.get(kv[0], 9), kv[0])):
            mc = (f"{b['mean_cost_us']:,.0f}us"
                  if b["mean_cost_us"] is not None else "-")
            out.append(
                f"  {link:<6} attempts={b['attempts']} hits={b['hits']} "
                f"misses={b['misses']} nodes={b['nodes']} "
                f"bytes={b['bytes']} mean_cost={mc}"
            )
    out.append("idle fraction per worker:")
    if summary["idle"]:
        for key, w in summary["idle"].items():
            out.append(
                f"  {key}: idle {100.0 * w['idle_fraction']:5.1f}%  "
                f"busy {100.0 * w['busy_fraction']:5.1f}%"
            )
    else:
        out.append("  no worker tracks recorded")
    out.append("cycle-rate timeline:")
    if summary["cycle_rate"]:
        for b in summary["cycle_rate"]:
            out.append(
                f"  t={b['t_s']:8.3f}s  {b['cycles_per_sec']:12.1f} cyc/s  "
                f"{b['nodes_per_sec']:14.1f} nodes/s  "
                f"({b['dispatches']} dispatch(es))"
            )
    else:
        out.append("  no dispatch events recorded")
    if summary["device_counters"]:
        c = summary["device_counters"]
        out.append(
            "device counters: "
            + "  ".join(f"{k}={v}" for k, v in sorted(c.items()))
        )
    if summary.get("phase_decomp"):
        out.extend(phase_table(summary["phase_decomp"]))
    if summary.get("roofline"):
        from . import roofline as roofline_mod

        out.extend(roofline_mod.table(summary["roofline"]))
    if summary.get("survivor_path"):
        sp = summary["survivor_path"]
        out.append(
            f"survivor path: {sp['eval_rows']} child evals vs "
            f"{sp['push_rows']} push rows"
            + (f" ({sp['push_rows_per_survivor']} rows/survivor)"
               if sp["push_rows_per_survivor"] is not None else "")
            + f", {sp['overflow_cycles']} overflow cycle(s)"
        )
    if summary.get("jobs"):
        out.append("per-job lanes:")
        for j, info in summary["jobs"].items():
            out.append(
                f"  {j}: {info['events']} event(s), "
                f"{info['dispatches']} dispatch(es) over "
                f"{info['span_s']:.3f}s"
                + (f", best={info['best']}"
                   if info["best"] is not None else "")
                + (f", slot {'/'.join(str(s) for s in info['slots'])}"
                   f" of B={info['batch_width']}"
                   if info.get("slots") else "")
            )
    if summary.get("quality"):
        q = summary["quality"]
        head = "quality vs time"
        if q.get("instance") and q.get("optimum") is not None:
            head += f" (instance {q['instance']}, optimum {q['optimum']})"
        out.append(head + ":")
        for key, jq in q["jobs"].items():
            label = "" if key == "-" else f"{key}: "
            for p in jq["points"]:
                gap = ("gap ?" if p["gap"] is None
                       else f"gap {100.0 * p['gap']:6.2f}%")
                out.append(
                    f"  {label}t={p['t_s']:8.3f}s  best={p['best']}  {gap}"
                )
            tail = []
            if jq["final_gap"] is not None:
                tail.append(f"final gap {100.0 * jq['final_gap']:.2f}%")
            if jq["primal_integral"] is not None:
                tail.append(f"primal integral {jq['primal_integral']:.4f}")
            if tail:
                out.append(f"  {label}" + ", ".join(tail))
    return "\n".join(out)


def report_main(trace_paths, as_json: bool = False,
                roofline: bool = False,
                costmodel: str | None = None) -> int:
    """The ``report`` entry point.

    Accepts one or many files — traces, metrics JSONL, flight-recorder
    dumps — merged into a single report (multi-worker sessions write one
    metrics file per host; the union is the honest whole-run view).
    Robustness contract: a truncated or empty file is summarized as far
    as it parses, with a warning on stderr and exit 0 — a post-mortem
    artifact from a killed run must never be unreadable by its own
    tooling. Exit 2 only when NO input could be read at all.

    ``roofline=True`` (the ``--roofline`` flag) makes the memory-roofline
    section mandatory: exit 2 with a diagnostic when the trace lacks the
    phase splits / cycle counts / ``roofline_meta`` facts it needs.
    ``costmodel`` optionally names a COSTMODEL.json whose measured ``hbm``
    link fit supplies the peak-bandwidth denominator."""
    import sys

    from .export import load_trace_lenient

    if isinstance(trace_paths, str):
        trace_paths = [trace_paths]
    profile = None
    if costmodel:
        from . import costmodel as CM

        profile = CM.load(costmodel)
        if profile is None:
            # An explicitly named profile that cannot be read is an
            # operator error here (unlike the controllers' soft fallback).
            print(f"Error: cannot load cost model {costmodel!r}",
                  file=sys.stderr)
            return 2
    evts: list[dict] = []
    readable = 0
    for path in trace_paths:
        try:
            part, warn = load_trace_lenient(path)
        except OSError as e:
            print(f"Error: cannot read {path!r}: {e}", file=sys.stderr)
            continue
        readable += 1
        if warn:
            print(f"Warning: {warn}", file=sys.stderr)
        evts.extend(part)
    if not readable:
        return 2
    if not evts:
        print("Warning: no events recovered from "
              f"{len(trace_paths)} file(s); reporting empty summary",
              file=sys.stderr)
    evts.sort(key=lambda e: e.get("ts", 0.0))
    summary = summarize(evts, costmodel=profile)
    if roofline and not summary.get("roofline"):
        print(
            "Error: --roofline needs a phase-profiled trace "
            "(TTS_PHASEPROF=1 run with dispatch cycle counts and a "
            "roofline_meta event); none of the inputs carry one",
            file=sys.stderr,
        )
        return 2
    try:
        if as_json:
            print(json.dumps(summary))
        else:
            print(render(summary))
    except BrokenPipeError:
        # `report t.json | head` closing the pipe is not an error.
        import os
        import sys

        try:
            sys.stdout.close()
        except Exception:
            os._exit(0)
    return 0
