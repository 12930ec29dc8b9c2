#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port on one card.

    python3 chip_ab.py OTHER_ROOT [--out DIR]
    python3 chip_ab.py OTHER_ROOT --rows       # the kernel rows only
    python3 chip_ab.py OTHER_ROOT --searches   # the fused searches' phase 2 only
    python3 chip_ab.py OTHER_ROOT --searches --unfused   # the unfused ones

Runs each checkout's own ``chip_smoke.py`` from its root, one process a
run, in turns A, B, B, A: A is OTHER_ROOT (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists),
B the checkout this script sits in. Each run's output goes to
``DIR/<run>_<A|B>.log`` (default ``_checkout/ab``, gitignored). Prints
one JSON line a run (exit code, the card as ``nvidia-smi`` names it, every
kernel's time from the ``kernels`` line, the rows of kernels 1, 3 and 5,
of the fused and streamed cycles (kernels 2, 4, 8 and 9a-9c), of kernel 6
and of kernel 7 (keyed by R and n_active) with the cycles' device time by
launch,
the searches' times and the profiled searches' device times, dispatches and
graph build seconds, the graph dispatches' device time by CUDA events, the
dispatch-pipeline runs and the graph dispatch's rows), then one line that
sets the four runs side by side. Exits non-zero when a run failed.

``--rows`` runs, in the same turns, only the kernel rows that both
checkouts' ``chip_smoke.py`` time: kernels 2, 4, 8 (ta014 and ta021), 9a,
9b, 9c, 3, 6 (ta014, ta021, ta051, ta081) and 7, each run in a process
that imports that checkout's own ``chip_smoke.py`` and calls its phases
(``--rows-of ROOT``, one JSON line ``{row: ms}``), then one line that sets
the four runs side by side, with ``outside``: the rows whose two B times
both fall outside the two A times, and B's mean over A's less one.

``--searches`` runs, in the same turns, the fused ta014 lb1, N-Queens N=15
and ta014 lb2 searches and the streamed N=15 (``--mt 80``) through each
checkout's own ``resident_search`` at
the CLI's defaults, one process a run, each search once to build its
kernels and graphs and then ``SEARCH_REPS`` times (``--searches-of ROOT``,
one JSON line: per search the phase 2 seconds and the dispatches' device
ms by CUDA events of each timed run), then the medians side by side with
``outside`` as above. Telemetry off in both (the knobs unset), but for
``PHASE_REPS`` more runs of each fused search with the phase clock armed
(``TTS_PHASEPROF=1``, which arms the counters: their graph ends with
``dispatch_cond_obs``), whose ``loop`` phase (the time between one
cycle's last mark and the next one's first) goes beside the rest as
``loop_ms``. With
``--unfused`` the searches are the unfused cycle's: ta014 lb1_d, ta014
lb2 staged and single-pass (``fused=False``, ``staged=False``), ta014 lb1
at M = 1024 and N-Queens N = 14 (a checkout whose unfused dispatches are
no graph reports no device ms: null).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CYCLE_PHASES = ("kernel1", "kernel2", "kernel3", "kernel4", "kernel5", "kernel6",
                "kernel7", "kernel8", "kernel9", "kernel10", "kernel11")
# The kernel 1 and 5 rows of a checkout that names no instance are ta014's.
DEFAULT_INST = {"kernel1": "ta014", "kernel5": "ta014"}
# The fields that name a row of those phases (those it has, in this order).
ROW_FIELDS = ("phase", "inst", "n", "N", "dtype", "M", "mt", "B", "g", "chunk",
              "incumbent", "R", "n_active")


def summarize(stdout: str) -> dict:
    lines, card = [], None
    for ln in stdout.splitlines():
        if ln.startswith("{"):
            lines.append(json.loads(ln))
        elif card is None and ln.strip() and "," in ln:
            card = ln.strip()
    kernels = next((ln["kernels"] for ln in lines if "kernels" in ln), [])
    cycles, launch_ms = {}, {}
    for ln in lines:
        if ln.get("phase") in CYCLE_PHASES:
            if ln["phase"] in DEFAULT_INST:
                ln.setdefault("inst", DEFAULT_INST[ln["phase"]])
            key = "/".join(str(ln.get(k)) for k in ROW_FIELDS
                           if ln.get(k) is not None)
            cycles[key] = ln["ms"]
            if ln.get("launch_ms"):
                launch_ms[key] = ln["launch_ms"]
    searches = {ln["phase"]: [ln["elapsed_s"], ln["phases"][1][2]]
                for ln in lines if str(ln.get("phase", "")).startswith("search_")}
    profiles = {ln["search"]: {k: ln.get(k) for k in
                               ("device_busy_ms", "phase2_ms", "busy_share",
                                "launches_per_cycle", "cycle_ms_per_traced_cycle",
                                "kernel_device_ms", "kernel_launches",
                                "top_device_ms", "dispatches", "graph_build_s",
                                "cond_ms_per_cycle", "dispatch_device_ms",
                                "event_busy_share", "trace_complete")}
                for ln in lines if ln.get("phase") == "profile"}
    pipeline = {ln["run"]: {k: ln.get(k) for k in
                            ("dispatches", "K", "graph_build_s", "phase2_s",
                             "phase2_less_build_s", "dispatch_device_ms",
                             "profiled_device_ms", "busy_share")}
                for ln in lines if ln.get("phase") == "pipeline"}
    graph = {ln["search"]: {k: ln.get(k) for k in
                            ("dispatch_ms", "plain_ms", "graph_build_s")}
             for ln in lines if ln.get("phase") == "graph_dispatch"}
    return dict(card=card, ok=any(ln.get("ok") for ln in lines),
                kernels={k["name"]: k["ms"] for k in kernels},
                cycles=cycles, launch_ms=launch_ms, searches=searches,
                profiles=profiles, pipeline=pipeline, graph=graph)


def rows_of(root: Path) -> dict:
    """The kernel rows of the checkout at ``root`` (the current directory),
    through its own chip_smoke.py: ``{phase/key: ms}``."""
    import contextlib
    import importlib.util
    import io

    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from tpu_tree_search_torch.problems import PFSPProblem

    with contextlib.redirect_stdout(io.StringIO()):
        cs.phase_build()
        dev = torch.device("cuda", 0)
        tables = {f"ta{i:03d}": PFSPProblem(inst=i, lb="lb2", ub=1).device_tables(dev)
                  for i in (14, 21, 51, 81)}
        lb1 = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(dev)
        got = {"kernel2": cs.phase_pfsp_cycle("kernel2", dev, lb1, "lb1", 1),
               "kernel4": cs.phase_kernel4(dev),
               "kernel8": cs.phase_pfsp_cycle("kernel8", dev, tables["ta014"], "lb2", 8),
               "kernel8/ta021": cs.phase_pfsp_cycle("kernel8", dev, tables["ta021"],
                                                    "lb2", 21, inst="ta021"),
               "kernel9": cs.phase_pfsp_cycle("kernel9", dev, lb1, "lb1", 9, tiled=True),
               "kernel10": cs.phase_kernel4(dev, "kernel10", tiled=True),
               "kernel11": cs.phase_pfsp_cycle(
                   "kernel11", dev, tables["ta014"], "lb2", 11, tiled=True,
                   shapes=((1024, 16), (49152, 64), (49152, 8))),
               "kernel3": cs.phase_kernel3(dev),
               "kernel6": cs.phase_kernel6(dev, tables),
               "kernel7": cs.phase_kernel7(dev, tables["ta014"])}
    return {f"{ph}/" + "/".join(map(str, key)): row["ms"]
            for ph, rows in got.items() for key, row in rows.items()}


# The --searches runs: (name, CLI argv), and the timed runs of each.
SEARCHES = (("ta014_lb1", ["pfsp", "--inst", "14", "--lb", "lb1", "--ub", "1"]),
            ("nqueens_N15", ["nqueens", "--N", "15"]),
            ("ta014_lb2", ["pfsp", "--inst", "14", "--lb", "lb2", "--ub", "1"]),
            ("nqueens_N15_mt80", ["nqueens", "--N", "15", "--mt", "80"]))
SEARCH_REPS = 5
PHASE_REPS = 2
# The --searches --unfused runs: (name, CLI argv, M or None for the CLI's
# default, resident_search's keywords).
UNFUSED_SEARCHES = (
    ("ta014_lb1_d", ["pfsp", "--inst", "14", "--lb", "lb1_d", "--ub", "1"], None,
     {}),
    ("ta014_lb2_staged", ["pfsp", "--inst", "14", "--lb", "lb2", "--ub", "1"], None,
     {"fused": False}),
    ("ta014_lb2_single", ["pfsp", "--inst", "14", "--lb", "lb2", "--ub", "1"], None,
     {"fused": False, "staged": False}),
    ("ta014_lb1_M1024", ["pfsp", "--inst", "14", "--lb", "lb1", "--ub", "1"], 1024,
     {"fused": False}),
    ("nqueens_N14", ["nqueens", "--N", "14"], None, {"fused": False}))


def searches_of(root: Path, unfused: bool = False) -> dict:
    """The fused searches of ``SEARCHES`` (``unfused``: of
    ``UNFUSED_SEARCHES``) through the checkout at ``root`` (the current
    directory): ``{name: [[phase2_s, device_ms, tree], ...]}``, and for the
    fused searches ``{"loop": {name: [loop_ms, ...]}}``, the phase clock's
    ``loop`` of each armed run after the first."""
    import contextlib
    import io
    import os

    for k in ("TTS_OBS", "TTS_PHASEPROF", "TTS_PIPELINE", "TTS_K"):
        os.environ.pop(k, None)
    sys.path.insert(0, str(root))
    import torch
    from tpu_tree_search_torch import cli, native
    from tpu_tree_search_torch.engine.resident import resident_search
    from tpu_tree_search_torch.ops import _build

    native.build()
    _build.build_all()
    dev = torch.device("cuda", 0)
    out = {}
    runs_of = (UNFUSED_SEARCHES if unfused
               else tuple((name, argv, None, {}) for name, argv in SEARCHES))
    for name, argv, M, kwargs in runs_of:
        args = cli.build_parser().parse_args(argv)
        prob = cli.make_problem(args)
        runs = []
        for rep in range(SEARCH_REPS + 1):
            with contextlib.redirect_stdout(io.StringIO()):
                res = resident_search(prob, m=args.m,
                                      M=M or cli.default_M(args.problem, "cuda"),
                                      K=4096, device=dev, mt=args.mt, **kwargs)
            if rep:
                dev_s = res.dispatch_device_s
                runs.append([res.phases[1].seconds,
                             None if dev_s is None else dev_s * 1e3,
                             res.explored_tree])
        out[name] = runs
        if unfused:
            continue
        os.environ["TTS_PHASEPROF"] = "1"
        try:
            for rep in range(PHASE_REPS + 1):
                with contextlib.redirect_stdout(io.StringIO()):
                    res = resident_search(prob, m=args.m,
                                          M=cli.default_M(args.problem, "cuda"),
                                          K=4096, device=dev, mt=args.mt)
                if rep:
                    out.setdefault("loop", {}).setdefault(name, []).append(
                        res.phase_profile["loop"] / 1e6)
        finally:
            os.environ.pop("TTS_PHASEPROF", None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--out", type=Path, default=HERE / "_checkout" / "ab")
    ap.add_argument("--rows", action="store_true",
                    help="kernels 6, 4 and 9a only, through each checkout's phases")
    ap.add_argument("--rows-of", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--searches", action="store_true",
                    help="the fused searches' phase 2 only")
    ap.add_argument("--searches-of", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--unfused", action="store_true",
                    help="with --searches: the unfused cycle's searches")
    args = ap.parse_args()
    if args.rows_of is not None:
        print(json.dumps({"root": str(args.rows_of), "rows": rows_of(args.rows_of)}))
        return 0
    if args.searches_of is not None:
        print(json.dumps({"root": str(args.searches_of),
                          "searches": searches_of(args.searches_of,
                                                  args.unfused)}))
        return 0
    if args.other is None:
        ap.error("OTHER_ROOT is required")
    args.out.mkdir(parents=True, exist_ok=True)
    roots = {"A": args.other.resolve(), "B": HERE}
    if args.rows:
        return main_rows(roots, args.out)
    if args.searches:
        return main_searches(roots, args.out, args.unfused)
    runs, failed = [], False
    for i, tag in enumerate("ABBA"):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=roots[tag],
                           capture_output=True, text=True, timeout=1100)
        (args.out / f"{i}_{tag}.log").write_text(p.stdout + "\n--- stderr\n" + p.stderr)
        run = dict(run=i, tree=tag, root=str(roots[tag]), rc=p.returncode,
                   seconds=time.perf_counter() - t0, **summarize(p.stdout))
        failed |= p.returncode != 0 or not run["ok"]
        runs.append(run)
        print(json.dumps(run), flush=True)
    side = {}
    for part in ("kernels", "cycles", "launch_ms", "searches", "pipeline", "graph"):
        keys = sorted({k for r in runs for k in r[part]})
        side[part] = {k: [r[part].get(k) for r in runs] for k in keys}
    side["profiles"] = {
        k: [{f: (r["profiles"].get(k) or {}).get(f)
             for f in ("device_busy_ms", "phase2_ms", "busy_share", "kernel_device_ms",
                      "dispatches")}
            for r in runs]
        for k in sorted({k for r in runs for k in r["profiles"]})}
    print(json.dumps({"order": "ABBA", **side}), flush=True)
    return 1 if failed else 0


def main_rows(roots: dict, out: Path) -> int:
    """``--rows``: A B B A of the kernel rows, one process a run."""
    runs = []
    for i, tag in enumerate("ABBA"):
        p = subprocess.run([sys.executable, str(HERE / "chip_ab.py"), "--rows-of",
                            str(roots[tag])], cwd=roots[tag], capture_output=True,
                           text=True, timeout=1100)
        (out / f"rows_{i}_{tag}.log").write_text(p.stdout + "\n--- stderr\n" + p.stderr)
        if p.returncode != 0:
            print(json.dumps({"run": i, "tree": tag, "rc": p.returncode}), flush=True)
            return 1
        runs.append(json.loads(p.stdout.strip().splitlines()[-1])["rows"])
        print(json.dumps({"run": i, "tree": tag, "rc": 0, "rows": runs[-1]}), flush=True)
    keys = sorted({k for r in runs for k in r})
    rows = {k: [r.get(k) for r in runs] for k in keys}
    print(json.dumps({"order": "ABBA", "rows": rows, "outside": outside(rows)}), flush=True)
    return 0


def main_searches(roots: dict, out: Path, unfused: bool = False) -> int:
    """``--searches``: A B B A of the fused (``unfused``: the unfused)
    searches, one process a run."""
    import statistics

    runs = []
    names = [r[0] for r in (UNFUSED_SEARCHES if unfused else SEARCHES)]
    for i, tag in enumerate("ABBA"):
        p = subprocess.run([sys.executable, str(HERE / "chip_ab.py"), "--searches-of",
                            str(roots[tag])] + (["--unfused"] if unfused else []),
                           cwd=roots[tag], capture_output=True,
                           text=True, timeout=900)
        (out / f"searches_{i}_{tag}.log").write_text(p.stdout + "\n--- stderr\n" + p.stderr)
        if p.returncode != 0:
            print(json.dumps({"run": i, "tree": tag, "rc": p.returncode}), flush=True)
            return 1
        runs.append(json.loads(p.stdout.strip().splitlines()[-1])["searches"])
        print(json.dumps({"run": i, "tree": tag, "rc": 0, "searches": runs[-1]}), flush=True)
    rows = {}
    for name in names:
        for j, field in enumerate(("phase2_s", "device_ms")):
            rows[f"{name}/{field}"] = [
                None if any(r[j] is None for r in run[name])
                else statistics.median(r[j] for r in run[name]) for run in runs]
        loops = [run.get("loop", {}).get(name) for run in runs]
        if all(loops):
            rows[f"{name}/loop_ms"] = [statistics.median(v) for v in loops]
    print(json.dumps({"order": "ABBA", "median": rows, "outside": outside(rows)}),
          flush=True)
    return 0


def outside(rows: dict) -> dict:
    """The rows (A, B, B, A times) whose two B times both fall outside the
    two A times, on one side: B's mean over A's, less one."""
    out = {}
    for k, (a0, b0, b1, a1) in rows.items():
        if None in (a0, b0, b1, a1):
            continue
        lo, hi = min(a0, a1), max(a0, a1)
        if (b0 > hi and b1 > hi) or (b0 < lo and b1 < lo):
            out[k] = (b0 + b1) / (a0 + a1) - 1
    return out


if __name__ == "__main__":
    sys.exit(main())
