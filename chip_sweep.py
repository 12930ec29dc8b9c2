#!/usr/bin/env python3
"""Time the lb2 kernels 6 and 8 on one card, for this checkout or for
variants of its CUDA sources.

    python3 chip_sweep.py                         # this checkout, once
    python3 chip_sweep.py VARIANTS.json [--rounds N]

Without arguments: kernel 6 (``lb2_bounds``) on ta014 and ta021 at
B = 1024 and 49152 and on ta081 at B = 1024, and kernel 8 (``cycle_lb2``)
on a full chunk of ta014 and ta021 at M = 1024 and 49152, each against its
plain version (``err`` is the largest difference), then its device time
from the profiler (kernel 8: the whole cycle and its bounds launch) and
the block shape it chose. Prints one JSON line.

With VARIANTS.json, a list of ``[name, {source: {old: new}}]``: each
variant is a copy of the package under ``_checkout/sweep/<name>``
(gitignored) with each ``old`` text of ``tpu_tree_search_torch/csrc/
<source>`` replaced by ``new``; the copies run in turns, one process each,
``--rounds`` times (default 1), each printing its line. A variant that
changes what a kernel computes shows in its ``err``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PKG = "tpu_tree_search_torch"


def make_variant(root: Path, dest: Path, subs: dict) -> None:
    """Copy ``root``'s package and this script to ``dest`` and apply
    ``subs`` ({source under csrc: {old: new}}); each ``old`` must occur."""
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(root / PKG, dest / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in ("chip_smoke.py", "chip_sweep.py"):
        shutil.copy(root / name, dest / name)
    for source, pairs in subs.items():
        path = dest / PKG / "csrc" / source
        text = path.read_text()
        for old, new in pairs.items():
            if old not in text:
                raise ValueError(f"{source}: {old!r} not found")
            text = text.replace(old, new)
        path.write_text(text)


def measure() -> dict:
    """The JSON line of one checkout (see the module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_tree_search_torch.ops import _build, lb2_kernel
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.problems import PFSPProblem

    t0 = time.perf_counter()
    _build.library("lb2_bounds")
    _build.library("cycle_lb2")
    dev = torch.device("cuda", 0)
    out = {"build_s": time.perf_counter() - t0, "k6": {}, "k8": {},
           "k8_bounds_launch": {}, "block": {}, "err": 0}
    tabs = {i: PFSPProblem(inst=i, lb="lb2", ub=1).device_tables(dev)
            for i in (14, 21, 81)}
    for inst, B in [(14, 1024), (14, 49152), (21, 1024), (21, 49152), (81, 1024)]:
        t = tabs[inst]
        n = t.jobs
        prmu, l1 = cs.random_nodes(np.random.default_rng(inst + B), n, B)
        p = torch.from_numpy(prmu).to(dev).to(torch.int8)
        lim = torch.from_numpy(l1).to(dev).to(torch.int8)
        got = lb2_kernel.lb2_bounds_cuda(p, lim, t)
        want = lb2_kernel.plain(p, lim, t)
        op = torch.from_numpy(np.arange(n)[None, :] > l1[:, None]).to(dev)
        out["err"] = max(out["err"], int((got[op].long() - want[op].long()).abs().max()))
        key = f"ta{inst:03d}/B={B}"
        out["k6"][key], _ = cs.kernel_device_ms(
            lambda: lb2_kernel.lb2_bounds_cuda(p, lim, t), 30, ("lb2_bounds_kernel",))
        out["block"][f"k6/{key}"] = lb2_kernel.last_shape("lb2_bounds")
    for inst, M in [(14, 1024), (14, 49152), (21, 1024), (21, 49152)]:
        t = tabs[inst]
        n = t.jobs
        size = M + 517
        prmu, l1 = cs.random_nodes(np.random.default_rng(inst + M), n, size)
        cap = size + M * n
        pv0 = torch.zeros((cap, n), dtype=torch.int8, device=dev)
        pa0 = torch.zeros(cap, dtype=torch.int8, device=dev)
        pv0[:size] = torch.from_numpy(prmu).to(dev).to(torch.int8)
        pa0[:size] = torch.from_numpy(l1).to(dev).to(torch.int8)
        st0 = C.new_state(size, 1500 if inst == 14 else 2300, dev)
        scratch = C.cycle_scratch(M, n, torch.int8, dev)
        pv, pa, st = pv0.clone(), pa0.clone(), st0.clone()
        C.cycle_lb2_cuda(pv, pa, st, scratch, t, M, 25, 4)
        pv2, pa2, st2 = pv0.clone(), pa0.clone(), st0.clone()
        C.cycle_lb2_plain(pv2, pa2, st2, t, M, 25, 4)
        live = int(st2[C.ST_SIZE])
        out["err"] = max(out["err"],
                         int((st[:C.ST_BASE + 1] - st2[:C.ST_BASE + 1]).abs().max()),
                         int((pv[:live].int() - pv2[:live].int()).abs().max()))

        def restore():
            pv.copy_(pv0)
            pa.copy_(pa0)
            st.copy_(st0)

        key = f"ta{inst:03d}/M={M}"
        out["k8"][key], _ = cs.kernel_device_ms(
            lambda: C.cycle_lb2_cuda(pv, pa, st, scratch, t, M, 25, 4), 30,
            cs.LB2_CYCLE_KERNELS, restore)
        out["k8_bounds_launch"][key] = cs.LAST_LAUNCH_MS.get("lb2_cycle_bounds")
        out["block"][f"k8/{key}"] = lb2_kernel.last_shape("cycle_lb2")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="?", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--name", default="this")
    args = ap.parse_args()
    if args.variants is None:
        print(json.dumps({"variant": args.name, **measure()}), flush=True)
        return 0
    variants = json.loads(args.variants.read_text())
    base = HERE / "_checkout" / "sweep"
    for name, subs in variants:
        make_variant(HERE, base / name, subs)
    failed = False
    for _ in range(args.rounds):
        for name, _subs in variants:
            p = subprocess.run([sys.executable, "chip_sweep.py", "--name", name],
                               cwd=base / name, capture_output=True, text=True,
                               timeout=900)
            failed |= p.returncode != 0
            print(p.stdout.strip() or json.dumps(
                {"variant": name, "rc": p.returncode, "stderr": p.stderr[-2000:]}),
                flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
