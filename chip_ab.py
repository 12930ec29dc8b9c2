#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port on one card.

    python3 chip_ab.py OTHER_ROOT [--out DIR]

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
the searches' times and the profiled searches' device times), then one line
that sets the four runs side by side. Exits non-zero when a run failed.
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
                                "launches_per_cycle", "cycle_ms_per_real_cycle",
                                "kernel_device_ms", "kernel_launches",
                                "top_device_ms")}
                for ln in lines if ln.get("phase") == "profile"}
    return dict(card=card, ok=any(ln.get("ok") for ln in lines),
                kernels={k["name"]: k["ms"] for k in kernels},
                cycles=cycles, launch_ms=launch_ms, searches=searches,
                profiles=profiles)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=HERE / "_checkout" / "ab")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    roots = {"A": args.other.resolve(), "B": HERE}
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
    for part in ("kernels", "cycles", "launch_ms", "searches"):
        keys = sorted({k for r in runs for k in r[part]})
        side[part] = {k: [r[part].get(k) for r in runs] for k in keys}
    side["profiles"] = {
        k: [{f: (r["profiles"].get(k) or {}).get(f)
             for f in ("device_busy_ms", "phase2_ms", "busy_share", "kernel_device_ms")}
            for r in runs]
        for k in sorted({k for r in runs for k in r["profiles"]})}
    print(json.dumps({"order": "ABBA", **side}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
