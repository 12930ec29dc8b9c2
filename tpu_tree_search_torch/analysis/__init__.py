"""``tpu_tree_search_torch.analysis`` — the port's ``lint`` (the lock rules
and the capture rules), its program contracts (``check``) and the
steady-state guard of its resident loops (the JAX package's ``analysis/``).

Static side: the AST-pass framework (``core``), five rules — ``guarded-by``
(``locks``) and ``lock-order`` (``lockorder``), and the capture rules
``host-sync-in-capture``, ``tensor-branch`` and ``program-key-hygiene``
(``torch_rules``: the JAX package's ``host-sync-in-jit``,
``tracer-branch`` and ``static-arg-hygiene`` over the code a dispatch
graph captures) — inline waivers and a count-ratchet baseline
(``baseline``), all stdlib. Program side: the contract registry
(``contracts``) and its auditor over the cycles and their dispatch graphs
(``program_audit``, ``check``). Runtime side: the ``TTS_GUARD=1``
steady-state guard (``guard``).
"""

from __future__ import annotations

import argparse
import json
import os

from .baseline import (
    apply_waivers,
    load_baseline,
    ratchet,
    save_baseline,
)
from .core import RULES, Finding, parse_modules, run_rules
from .guard import GuardViolation, SteadyStateGuard, guard_enabled

# Rule modules register themselves into RULES at import time.
from . import lockorder as _lockorder  # noqa: E402,F401  (registration)
from . import locks as _locks  # noqa: E402,F401  (registration)
from . import torch_rules as _torch_rules  # noqa: E402,F401  (registration)

__all__ = [
    "Finding",
    "GuardViolation",
    "RULES",
    "SteadyStateGuard",
    "add_lint_args",
    "guard_enabled",
    "lint",
    "lint_main",
    "run_lint_cli",
]

#: The port's ratchet file (``.tts-lint-baseline.json`` is the JAX
#: package's). The port lints clean without one, so none is committed.
DEFAULT_BASELINE = ".tts-torch-lint-baseline.json"


def lint(paths, baseline: dict[str, int] | None = None,
         rules=None) -> dict[str, list[Finding]]:
    """Run the analysis; returns findings split into ``new`` (fail the
    build), ``baselined`` (accepted debt) and ``waived`` (inline-justified).
    """
    modules, parse_errors = parse_modules(paths)
    findings = run_rules(modules, only=rules)
    active, waived = apply_waivers(
        modules, findings,
        selected_rules=set(rules) if rules is not None else None,
    )
    active = parse_errors + active
    new, old = ratchet(active, baseline or {})
    return {"new": new, "baselined": old, "waived": waived}


def _default_paths() -> list[str]:
    # A checkout: the package and the chip script; elsewhere the installed
    # package, so `lint` works from anywhere.
    if os.path.isdir("tpu_tree_search_torch"):
        paths = ["tpu_tree_search_torch"]
        if os.path.isfile("chip_smoke.py"):
            paths.append("chip_smoke.py")
        return paths
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def add_lint_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to lint (default: tpu_tree_search_torch "
                        "and chip_smoke.py)")
    p.add_argument("--baseline", default=None,
                   help=f"ratchet file (default: ./{DEFAULT_BASELINE} "
                        "when present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: report ALL findings")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to the current finding set")
    p.add_argument("--rule", action="append", default=None, dest="rules",
                   choices=sorted(RULES), metavar="NAME",
                   help="run only this rule (repeatable): "
                        + ", ".join(sorted(RULES)))
    p.add_argument("--json", action="store_true", dest="lint_json",
                   help="emit one JSON object instead of text")
    p.add_argument("--show-waived", action="store_true",
                   help="also list waived findings")


def run_lint_cli(args) -> int:
    paths = args.paths or _default_paths()
    baseline_path = args.baseline
    if baseline_path is None and os.path.exists(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE
    baseline = {} if args.no_baseline else load_baseline(baseline_path)
    res = lint(paths, baseline, rules=args.rules)
    if args.update_baseline:
        target = args.baseline or DEFAULT_BASELINE
        save_baseline(target, res["new"] + res["baselined"])
        print(f"baseline written: {target} "
              f"({len(res['new']) + len(res['baselined'])} finding(s))")
        return 0
    if args.lint_json:
        print(json.dumps({
            k: [vars(f) for f in v] for k, v in res.items()
        }))
        return 1 if res["new"] else 0
    for f in res["new"]:
        print(f.render())
    if args.show_waived:
        for f in res["waived"]:
            print(f"{f.render()}  (waived)")
    n_new, n_old, n_waived = (
        len(res["new"]), len(res["baselined"]), len(res["waived"])
    )
    print(
        f"lint: {n_new} new finding(s), {n_old} baselined, "
        f"{n_waived} waived"
    )
    return 1 if res["new"] else 0


def lint_main(argv=None, prog: str = "python -m tpu_tree_search_torch.analysis"
              ) -> int:
    """The ``lint`` entry point (``python -m tpu_tree_search_torch lint``
    and ``python -m tpu_tree_search_torch.analysis``)."""
    p = argparse.ArgumentParser(
        prog=prog,
        description="the lock rules (guarded-by, lock-order) over the "
                    "port's host threads and the capture rules "
                    "(host-sync-in-capture, tensor-branch, "
                    "program-key-hygiene) over the code its dispatch "
                    "graphs capture",
    )
    add_lint_args(p)
    return run_lint_cli(p.parse_args(argv))
