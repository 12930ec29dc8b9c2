"""Inline waivers + the baseline ratchet for the port's ``lint`` (a copy of
the JAX package's ``analysis/baseline.py``).

Two suppression mechanisms, with different jobs:

* **Inline waiver** — a trailing comment on the flagged line (or the line
  above it): ``# tts-lint: waive <rule> -- <one-line justification>``.
  The justification is mandatory; a waiver without one is itself a finding
  (rule ``waiver-format``). Use waivers for accesses that are *individually*
  safe (e.g. an advisory racy ``pool.size`` read re-checked under the lock).

* **Baseline file** — a committed JSON ratchet keyed per ``rule:file`` with
  the accepted finding *count*. Pre-existing debt lints green; any edit that
  *adds* a finding to a cell fails; fixing findings lets ``--update-baseline``
  shrink the cell. Counts (not line numbers) keep the ratchet stable under
  unrelated edits. Use the baseline for legacy debt you intend to burn down,
  not for new code.
"""

from __future__ import annotations

import json
import re

from .core import PRAGMA, Finding, Module

_WAIVE_RE = re.compile(
    r"#\s*" + re.escape(PRAGMA) + r"\s*waive\s+(?P<rules>[\w\-, ]+?)"
    r"(?:\s*--\s*(?P<reason>.+))?\s*$"
)


def waivers_for(module: Module) -> tuple[dict[int, set[str]], list[Finding]]:
    """Map line -> waived rule names. A waiver on its own line applies to the
    next source line; a trailing waiver applies to its own line. Returns
    (waivers, format_findings) — reasonless waivers are flagged, not honored.
    """
    waived: dict[int, set[str]] = {}
    bad: list[Finding] = []
    for line, comment in module.comments.items():
        m = _WAIVE_RE.search(comment)
        if m is None:
            continue
        if not m.group("reason"):
            bad.append(
                Finding(
                    "waiver-format", module.path, line, 0,
                    "waiver missing justification: use "
                    f"'# {PRAGMA} waive <rule> -- <why this is safe>'",
                )
            )
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        # Trailing comment waives its own line; a standalone comment line
        # waives the following line.
        target = line if module.text.splitlines()[line - 1].split("#")[0].strip() else line + 1
        waived.setdefault(target, set()).update(rules)
    return waived, bad


def apply_waivers(
    modules: list[Module], findings: list[Finding],
    selected_rules: set[str] | None = None,
) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (active, waived).

    Stale-waiver detection: a waiver whose rule *did run* but no
    longer fires on its line is dead weight that silently disarms the rule
    for any future edit of that line — it becomes a ``waiver-stale``
    finding.  ``selected_rules`` is the set of rules this run executed
    (``None`` = all): a waiver for a rule that was not run cannot be judged
    and is left alone, and a waiver naming a rule that does not exist is
    always stale."""
    from .core import RULES

    by_path: dict[str, dict[int, set[str]]] = {}
    extra: list[Finding] = []
    for mod in modules:
        w, bad = waivers_for(mod)
        by_path[mod.path] = w
        extra.extend(bad)
    active: list[Finding] = list(extra)
    waived: list[Finding] = []
    used: set[tuple[str, int, str]] = set()
    for f in findings:
        rules = by_path.get(f.path, {}).get(f.line, set())
        if f.rule in rules:
            waived.append(f)
            used.add((f.path, f.line, f.rule))
        else:
            active.append(f)
    ran = set(RULES) if selected_rules is None else set(selected_rules)
    for mod in modules:
        for line, rules in sorted(by_path.get(mod.path, {}).items()):
            for r in sorted(rules):
                if r in RULES and r not in ran:
                    continue  # not judged this run
                if (mod.path, line, r) in used:
                    continue
                reason = (
                    "names unknown rule" if r not in RULES
                    else "its rule no longer fires on this line"
                )
                active.append(Finding(
                    "waiver-stale", mod.path, line, 0,
                    f"stale waiver for '{r}': {reason} — remove it (a dead "
                    "waiver silently disarms the rule for future edits)",
                ))
    return active, waived


# -- baseline ratchet -----------------------------------------------------


def load_baseline(path: str | None) -> dict[str, int]:
    if path is None:
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    counts = data.get("counts", {})
    return {str(k): int(v) for k, v in counts.items()}


def save_baseline(path: str, findings: list[Finding]) -> None:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.cell] = counts.get(f.cell, 0) + 1
    with open(path, "w", encoding="utf-8") as f:
        json.dump(
            {
                "comment": "lint ratchet: accepted finding count per "
                "rule:file cell; regenerate with `python -m "
                "tpu_tree_search_torch lint --update-baseline` (counts may "
                "only shrink in review)",
                "counts": dict(sorted(counts.items())),
            },
            f,
            indent=2,
        )
        f.write("\n")


def ratchet(
    findings: list[Finding], baseline: dict[str, int]
) -> tuple[list[Finding], list[Finding]]:
    """Split active findings into (new, baselined). A cell at-or-under its
    baseline count is wholly baselined; a cell over it surfaces *all* its
    findings (a count ratchet cannot know which ones are the new ones)."""
    cells: dict[str, list[Finding]] = {}
    for f in findings:
        cells.setdefault(f.cell, []).append(f)
    new: list[Finding] = []
    old: list[Finding] = []
    for cell, fs in cells.items():
        if len(fs) <= baseline.get(cell, 0):
            old.extend(fs)
        else:
            new.extend(fs)
    new.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    old.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return new, old
