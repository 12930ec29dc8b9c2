"""The warm matrix (`tpu_tree_search/serve/warmup.py`, on the port).

Two consumers share the one config table:

  * ``warmup`` runs each config in a subprocess, reporting per-config
    **hit/miss** on the port's build directory
    (``tpu_tree_search_torch/_build/``, or ``TTS_BUILD_DIR``): the ``nvcc``
    kernel libraries and the ``g++`` native runtime a config builds at
    first use. A miss built new files there, a hit built nothing — the
    count of new files is the measurement, so a second run of the same
    matrix reports all hits. (The JAX package counts its XLA compile
    cache; the port has none: its graphs live in the process.)
  * ``serve --warm`` admits the servable configs as internal
    ``max_steps=1`` jobs, so that the daemon's program and graph caches
    (`engine/resident.py`) are warm: the first tenant job of a warmed
    class admits with zero new programs and graphs.

Each config is one ``resident_search(..., max_steps=1)``: the program, its
kernels and its dispatch graph, built and run for one dispatch. The JAX
rows whose knob the port lacks (``TTS_PALLAS``, ``TTS_LB2_PAIRBLOCK``;
ROADMAP.md C) are left out; ``TTS_LB2_STAGED`` maps to the port's cycles
(1: the staged unfused evaluator, 0: the fused lb2 cycle, which folds the
unstaged keep), and a ``TTS_COMPACT`` row runs the unfused cycle under
that compaction mode (its spec pins ``compact``, as the JAX row's does).
Each subprocess has its own timeout.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

_ITEM = r"""
import os, sys, time
t0 = time.time()
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.ops import _build
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem
from tpu_tree_search_torch.problems.pfsp import taillard

device = sys.argv[1]
kind = sys.argv[2]
if device != "cpu":
    _build.build_all()
if kind == "kernel":
    # Kernel-level warm at the smoke-gate shapes: the bound kernel of a
    # large instance on B seeded rows (a full search would not fit a slot).
    import torch
    from tpu_tree_search_torch.ops.pfsp_device import lb1_bounds, lb2_bounds
    inst, lb, B = int(sys.argv[3]), sys.argv[4], int(sys.argv[5])
    prob = PFSPProblem(inst=inst, lb=lb, ub=1)
    t = prob.device_tables(torch.device(device))
    n = taillard.nb_jobs(inst)
    prmu = torch.arange(n, dtype=torch.int32, device=device).repeat(B, 1)
    limit1 = torch.full((B,), -1, dtype=torch.int32, device=device)
    out = (lb1_bounds if lb == "lb1" else lb2_bounds)(prmu, limit1, t)
    print(f"WARM_OK shape={tuple(out.shape)} wall={time.time() - t0:.1f}s")
    sys.exit(0)
if kind == "nqueens":
    prob = NQueensProblem(N=int(sys.argv[3]))
    M, staged = int(sys.argv[4]), None
else:
    prob = PFSPProblem(inst=int(sys.argv[3]), lb=sys.argv[4], ub=1)
    M, staged = int(sys.argv[6]), os.environ.get("TTS_LB2_STAGED")
K = int(os.environ.get("TTS_K") or 4096)
fused = staged != "1" and not os.environ.get("TTS_COMPACT")
res = resident_search(prob, m=25, M=M, K=K, max_steps=1, device=device,
                      fused=fused)
print(f"WARM_OK tree={res.explored_tree} wall={time.time() - t0:.1f}s")
"""


class WarmConfig:
    """One warm slot: a name (CLI-selectable), the subprocess argv tail,
    env overrides, and — when the config is a full resident run the serve
    daemon can replay — the equivalent job spec."""

    def __init__(self, name: str, label: str, argv: list[str],
                 env: dict | None = None):
        self.name = name
        self.label = label
        self.argv = argv
        self.env = env or {}

    @property
    def servable(self) -> bool:
        return self.argv[0] != "kernel"

    def spec(self) -> dict | None:
        """The serve-side job spec for this config (``max_steps=1``), or
        None for kernel-only rows. ``TTS_K`` maps to the spec's K and
        ``TTS_COMPACT`` to its ``compact``; the staged rows have no spec
        field and warm the daemon's own cycle."""
        if not self.servable:
            return None
        kind = self.argv[0]
        spec: dict = {"tier": "device", "max_steps": 1,
                      "label": f"warm:{self.name}"}
        if kind == "nqueens":
            spec.update(problem="nqueens", N=int(self.argv[1]),
                        M=int(self.argv[2]))
        else:
            spec.update(problem="pfsp", inst=int(self.argv[1]),
                        lb=self.argv[2], ub=1, M=int(self.argv[4]))
        if "TTS_K" in self.env:
            spec["K"] = int(self.env["TTS_K"])
        if "TTS_COMPACT" in self.env:
            spec["compact"] = self.env["TTS_COMPACT"]
        return spec


# The JAX package's matrix, most valuable first, without the rows of knobs
# the port lacks (TTS_PALLAS, TTS_LB2_PAIRBLOCK).
CONFIGS: list[WarmConfig] = [
    WarmConfig("ta014-lb2-staged", "ta014 lb2 staged M=1024",
               ["pfsp", "14", "lb2", "-", "1024"], {"TTS_LB2_STAGED": "1"}),
    WarmConfig("ta014-lb2-unstaged", "ta014 lb2 unstaged M=1024",
               ["pfsp", "14", "lb2", "-", "1024"], {"TTS_LB2_STAGED": "0"}),
    WarmConfig("ta021-lb2-staged", "ta021 lb2 staged M=1024",
               ["pfsp", "21", "lb2", "-", "1024"], {"TTS_LB2_STAGED": "1"}),
    WarmConfig("ta021-lb2-unstaged", "ta021 lb2 unstaged M=1024",
               ["pfsp", "21", "lb2", "-", "1024"], {"TTS_LB2_STAGED": "0"}),
    WarmConfig("ta014-lb1-K1", "ta014 lb1 M=1024 K=1",
               ["pfsp", "14", "lb1", "-", "1024"], {"TTS_K": "1"}),
    WarmConfig("ta014-lb1-K4", "ta014 lb1 M=1024 K=4",
               ["pfsp", "14", "lb1", "-", "1024"], {"TTS_K": "4"}),
    WarmConfig("ta014-lb1-K16", "ta014 lb1 M=1024 K=16",
               ["pfsp", "14", "lb1", "-", "1024"], {"TTS_K": "16"}),
    WarmConfig("ta014-lb1-K64", "ta014 lb1 M=1024 K=64",
               ["pfsp", "14", "lb1", "-", "1024"], {"TTS_K": "64"}),
    WarmConfig("ta014-lb1-K256", "ta014 lb1 M=1024 K=256",
               ["pfsp", "14", "lb1", "-", "1024"], {"TTS_K": "256"}),
    WarmConfig("ta014-lb1-K1024", "ta014 lb1 M=1024 K=1024",
               ["pfsp", "14", "lb1", "-", "1024"], {"TTS_K": "1024"}),
    WarmConfig("ta014-lb1", "ta014 lb1 M=1024",
               ["pfsp", "14", "lb1", "-", "1024"]),
    WarmConfig("ta014-lb1d", "ta014 lb1_d M=1024",
               ["pfsp", "14", "lb1_d", "-", "1024"]),
    WarmConfig("nqueens-15", "nqueens N=15 M=65536",
               ["nqueens", "15", "65536"]),
    WarmConfig("nqueens-16", "nqueens N=16 M=65536",
               ["nqueens", "16", "65536"]),
    WarmConfig("nqueens-17", "nqueens N=17 M=65536",
               ["nqueens", "17", "65536"]),
    WarmConfig("nqueens-15-M8k", "nqueens N=15 M=8192",
               ["nqueens", "15", "8192"]),
    WarmConfig("nqueens-15-M256k", "nqueens N=15 M=262144",
               ["nqueens", "15", "262144"]),
    WarmConfig("nqueens-16-M256k", "nqueens N=16 M=262144",
               ["nqueens", "16", "262144"]),
    WarmConfig("nqueens-17-M128k", "nqueens N=17 M=131072",
               ["nqueens", "17", "131072"]),
    WarmConfig("ta014-lb1-scatter", "ta014 lb1 M=1024 compact=scatter",
               ["pfsp", "14", "lb1", "-", "1024"],
               {"TTS_COMPACT": "scatter"}),
    WarmConfig("ta014-lb1-sort", "ta014 lb1 M=1024 compact=sort",
               ["pfsp", "14", "lb1", "-", "1024"], {"TTS_COMPACT": "sort"}),
    WarmConfig("ta014-lb1-search", "ta014 lb1 M=1024 compact=search",
               ["pfsp", "14", "lb1", "-", "1024"],
               {"TTS_COMPACT": "search"}),
    WarmConfig("ta014-lb2-scatter", "ta014 lb2 M=1024 compact=scatter",
               ["pfsp", "14", "lb2", "-", "1024"],
               {"TTS_COMPACT": "scatter"}),
    WarmConfig("ta014-lb2-sort", "ta014 lb2 M=1024 compact=sort",
               ["pfsp", "14", "lb2", "-", "1024"], {"TTS_COMPACT": "sort"}),
    WarmConfig("ta014-lb2-search", "ta014 lb2 M=1024 compact=search",
               ["pfsp", "14", "lb2", "-", "1024"],
               {"TTS_COMPACT": "search"}),
    WarmConfig("nqueens-15-scatter", "nqueens N=15 M=65536 compact=scatter",
               ["nqueens", "15", "65536"], {"TTS_COMPACT": "scatter"}),
    WarmConfig("ta031-lb1-kernel", "ta031 lb1 kernel B=64",
               ["kernel", "31", "lb1", "64"]),
    WarmConfig("ta056-lb1-kernel", "ta056 lb1 kernel B=32",
               ["kernel", "56", "lb1", "32"]),
    WarmConfig("ta056-lb2-kernel", "ta056 lb2 kernel B=16",
               ["kernel", "56", "lb2", "16"]),
    WarmConfig("ta111-lb1-kernel", "ta111 lb1 kernel B=16",
               ["kernel", "111", "lb1", "16"]),
]


def select_configs(names: str | None) -> list[WarmConfig]:
    """``names``: None/"all" for the whole matrix, "serve" for the
    serve-able subset, else a comma-separated name list (unknown names
    raise ValueError — a typo must not silently warm nothing)."""
    if names in (None, "", "all"):
        return list(CONFIGS)
    if names == "serve":
        return [c for c in CONFIGS if c.servable]
    by_name = {c.name: c for c in CONFIGS}
    out = []
    unknown = []
    for name in names.split(","):
        name = name.strip()
        if name in by_name:
            out.append(by_name[name])
        elif name:
            unknown.append(name)
    if unknown:
        raise ValueError(
            f"unknown warm config(s): {', '.join(unknown)} "
            f"(known: {', '.join(sorted(by_name))})"
        )
    return out


def cache_dir() -> str:
    """The build directory a child of this process builds into — the
    hit/miss accounting target (``TTS_BUILD_DIR``, else the package's
    ``_build/``)."""
    from ..ops import _build

    return str(_build.BUILD)


def _cache_files(path: str) -> set[str]:
    if not os.path.isdir(path):
        return set()
    out = set()
    for root, _dirs, files in os.walk(path):
        for f in files:
            out.add(os.path.join(root, f))
    return out


def run_configs(configs: list[WarmConfig], timeout_s: float | None = None,
                emit=print, device: str = "cuda") -> int:
    """The subprocess warm loop (``warmup``): returns the failure count.
    Per config, reports ok/FAIL, wall seconds, and the build-directory
    delta — ``miss(+N files)`` built N new files, ``hit`` built nothing."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("TTS_WARM_TIMEOUT", "420"))
    cdir = cache_dir()
    failures = 0
    for cfg in configs:
        before = _cache_files(cdir)
        t0 = time.time()
        try:
            res = subprocess.run(
                [sys.executable, "-c", _ITEM, device, *cfg.argv],
                timeout=timeout_s, capture_output=True, text=True,
                env={**os.environ, **cfg.env},
            )
            ok = res.returncode == 0 and "WARM_OK" in res.stdout
            detail = (res.stdout.strip().splitlines() or [""])[-1] if ok else \
                (res.stderr or res.stdout).strip().splitlines()[-1:]
        except subprocess.TimeoutExpired:
            ok, detail = False, f"timeout {timeout_s:.0f}s"
        failures += not ok
        new = len(_cache_files(cdir) - before)
        cache = f"miss(+{new} files)" if new else "hit"
        # flush: a redirected log must stream per-config progress.
        emit(f"{'ok ' if ok else 'FAIL'} {time.time() - t0:7.1f}s  "
             f"[{cache}]  {cfg.name}  {detail}")
    return failures


def warmup_main(names: str | None = None, timeout_s: float | None = None,
                device: str = "cuda") -> int:
    """The ``warmup`` entry point."""
    try:
        configs = select_configs(names)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    failures = run_configs(configs, timeout_s=timeout_s,
                           emit=lambda line: print(line, flush=True),
                           device=device)
    return 1 if failures else 0


def warm_pool(daemon, names: str | None = "serve", timeout_s: float = 600.0):
    """``serve --warm``: admit each serve-able config as an internal
    max_steps=1 job and wait, warming the daemon's program pool so the
    first real job of each class is a zero-rebuild admission. Yields one
    progress line per config (the daemon prints them)."""
    configs = [c for c in select_configs(names or "serve") if c.servable]
    for cfg in configs:
        spec = cfg.spec()
        payload, code = daemon.submit(spec)
        if code != 201:
            yield (f"warm FAIL {cfg.name}: {payload.get('error')}")
            continue
        job = daemon.registry.get(payload["id"])
        t0 = time.time()
        while (job.state not in ("done", "failed", "cancelled")
               and time.time() - t0 < timeout_s):
            time.sleep(0.1)
        state = "ok " if job.state == "done" else "FAIL"
        yield (f"warm {state} {time.time() - t0:6.1f}s  {cfg.name}  "
               f"class={job.class_key}")
