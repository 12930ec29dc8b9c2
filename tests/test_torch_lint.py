"""The port's ``lint`` (`tpu_tree_search_torch/analysis/`: the lock rules
``guarded-by`` and ``lock-order``, and the capture rules of
tests/test_torch_capture_rules.py), held to the JAX package's
(`tpu_tree_search/analysis/`, the lock-rule part of tests/test_lint.py).

  * on every fixture of tests/data/lint/, the port's lock-rule findings —
    new and waived, ``(rule, file, line)`` — equal the JAX lint's run with
    the same two rules; the baseline ratchet agrees, and either package's
    baseline file loads in the other;
  * the rules' own cases: the bad fixtures' lines, a waiver honoured, a
    stale or reasonless waiver flagged, the good fixture clean;
  * the port lints clean with no baseline (the pool's lock contract
    restored, its waivers each with a reason), and without torch;
  * the CLI: ``lint`` (exit 1 on a finding, 0 on the port, ``--json``,
    ``--update-baseline``), ``python -m tpu_tree_search_torch.analysis``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_tree_search.analysis import lint as jax_lint
from tpu_tree_search.analysis.baseline import load_baseline as jax_load
from tpu_tree_search.analysis.baseline import save_baseline as jax_save
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.analysis import DEFAULT_BASELINE, lint
from tpu_tree_search_torch.analysis.baseline import (
    load_baseline,
    ratchet,
    save_baseline,
)
from tpu_tree_search_torch.analysis.core import RULES
from tpu_tree_search_torch.analysis.torch_rules import JAX_COUNTERPART

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "lint"
LOCK_RULES = ["guarded-by", "lock-order"]


def _keys(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


def findings_of(path, rule=None):
    out = lint([str(path)])["new"]
    return [f for f in out if rule is None or f.rule == rule]


def test_the_lock_and_capture_rules_are_registered():
    """Five rules: the two lock rules and the three capture rules (the
    counterparts of the JAX package's program rules)."""
    assert set(RULES) == set(LOCK_RULES) | set(JAX_COUNTERPART)
    assert len(RULES) == 5
    assert DEFAULT_BASELINE != ".tts-lint-baseline.json"


@pytest.mark.parametrize("fixture", sorted(p.name for p in
                                           FIXTURES.glob("*.py")))
def test_fixture_findings_equal_jax(fixture):
    path = str(FIXTURES / fixture)
    mine = lint([path], rules=LOCK_RULES)
    theirs = jax_lint([path], rules=LOCK_RULES)
    for part in ("new", "waived", "baselined"):
        assert _keys(mine[part]) == _keys(theirs[part]), part


def test_fixture_directory_equals_jax():
    mine = lint([str(FIXTURES)], rules=LOCK_RULES)
    theirs = jax_lint([str(FIXTURES)], rules=LOCK_RULES)
    assert _keys(mine["new"]) == _keys(theirs["new"])
    assert _keys(mine["waived"]) == _keys(theirs["waived"])
    assert {f.rule for f in mine["new"]} == set(LOCK_RULES)


def test_guarded_by_bad_fixture():
    fs = findings_of(FIXTURES / "bad_guarded_by.py", "guarded-by")
    assert sorted(f.line for f in fs) == [29, 34, 35, 42, 44]


def test_guarded_by_waiver_honored():
    res = lint([str(FIXTURES / "bad_guarded_by.py")])
    waived = [f for f in res["waived"] if f.rule == "guarded-by"]
    assert len(waived) == 1 and waived[0].line == 49


def test_lock_order_bad_fixture():
    fs = findings_of(FIXTURES / "bad_lock_order.py", "lock-order")
    # The A->B->A blocking cycle closes at 29; 35 blocking-acquires a
    # same-class sibling; the try_lock probe (41) is sanctioned.
    assert sorted(f.line for f in fs) == [29, 35]
    msgs = " ".join(f.message for f in fs)
    assert "cycle" in msgs and "try_lock" in msgs


def test_good_fixture_is_clean():
    assert findings_of(FIXTURES / "good_clean.py") == []


def test_stale_waiver_is_a_finding(tmp_path):
    """A waiver whose rule ran and no longer fires is stale; one naming a
    rule the port does not have (a JAX rule's name, whose port counterpart
    has a name of its own) is always stale."""
    f = tmp_path / "s.py"
    f.write_text(
        "x = 1  # tts-lint: waive guarded-by -- long-fixed\n"
        "y = 2  # tts-lint: waive host-sync-in-jit -- a JAX-only rule\n"
    )
    stale = [x for x in lint([str(f)])["new"] if x.rule == "waiver-stale"]
    assert sorted(x.line for x in stale) == [1, 2]
    assert "unknown rule" in stale[1].message
    stale2 = [x for x in lint([str(f)], rules=["lock-order"])["new"]
              if x.rule == "waiver-stale"]
    assert [x.line for x in stale2] == [2]


def test_waiver_without_reason_is_a_finding(tmp_path):
    f = tmp_path / "w.py"
    f.write_text(
        "import threading\n\n\n"
        "class C:\n"
        "    # guarded-by: lock -- x\n"
        "    def __init__(self):\n"
        "        self.lock = threading.Lock()\n"
        "        self.x = 0\n\n\n"
        "def f(c: C):\n"
        "    # tts-lint: waive guarded-by\n"
        "    return c.x\n"
    )
    res, theirs = lint([str(f)]), jax_lint([str(f)], rules=LOCK_RULES)
    assert {x.rule for x in res["new"]} == {"waiver-format", "guarded-by"}
    assert _keys(res["new"]) == _keys(theirs["new"])


def test_baseline_ratchet_equals_jax(tmp_path):
    bad = str(FIXTURES / "bad_guarded_by.py")
    res = lint([bad])
    assert len(res["new"]) == 5
    bl = tmp_path / "bl.json"
    save_baseline(str(bl), res["new"])
    counts = load_baseline(str(bl))
    assert counts == jax_load(str(bl))
    res2 = lint([bad], counts)
    theirs = jax_lint([bad], counts, rules=LOCK_RULES)
    assert res2["new"] == [] and len(res2["baselined"]) == 5
    assert _keys(res2["baselined"]) == _keys(theirs["baselined"])
    # Shrinking the accepted count resurfaces the whole cell.
    cell = next(iter(counts))
    counts[cell] -= 1
    new, old = ratchet(res["new"], counts)
    assert len(new) == 5 and old == []
    # The JAX package's baseline file loads in the port.
    jbl = tmp_path / "jbl.json"
    jax_save(str(jbl), jax_lint([bad], rules=LOCK_RULES)["new"])
    assert lint([bad], load_baseline(str(jbl)))["new"] == []


def test_port_lints_clean_without_a_baseline():
    """The port and chip_smoke.py: no finding without any baseline, no
    lock-order finding, and the pool's contract seen (its waivers, each
    with its reason, suppress live findings)."""
    res = lint([str(REPO / "tpu_tree_search_torch"),
                str(REPO / "chip_smoke.py")])
    assert res["new"] == [], "\n".join(f.render() for f in res["new"])
    assert res["baselined"] == []
    waived = {(Path(f.path).name, f.rule) for f in res["waived"]}
    assert ("multidevice.py", "guarded-by") in waived
    assert ("dist.py", "guarded-by") in waived
    assert len(res["waived"]) >= 7
    assert not (REPO / DEFAULT_BASELINE).exists()


def test_lint_loads_no_torch():
    code = ("import sys; from tpu_tree_search_torch.analysis import lint; "
            f"lint([{str(FIXTURES)!r}]); "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_lint_bad_fixture_nonzero(capsys):
    assert cli.main(["lint", "--no-baseline",
                     str(FIXTURES / "bad_guarded_by.py")]) == 1
    assert "[guarded-by]" in capsys.readouterr().out


def test_cli_lint_port_zero(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert cli.main(["lint", "--no-baseline"]) == 0
    assert "lint: 0 new finding(s)" in capsys.readouterr().out


def test_cli_lint_json(capsys):
    assert cli.main(["lint", "--no-baseline", "--json",
                     str(FIXTURES / "bad_lock_order.py")]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["line"] for f in out["new"]] == [29, 35]


def test_module_entry_point():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_tree_search_torch.analysis",
         "--no-baseline", str(FIXTURES / "bad_guarded_by.py")],
        capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert proc.returncode == 1
    assert "guarded-by" in proc.stdout


def test_update_baseline_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bad = str(FIXTURES / "bad_guarded_by.py")
    bl = tmp_path / "bl.json"
    assert cli.main(["lint", "--baseline", str(bl), "--update-baseline",
                     bad]) == 0
    assert cli.main(["lint", "--baseline", str(bl), bad]) == 0
    assert cli.main(["lint", bad]) == 1  # no default baseline here


@pytest.mark.parametrize("rule", LOCK_RULES)
def test_rule_selection(rule):
    res = lint([str(FIXTURES)], rules=[rule])
    assert all(f.rule in (rule, "waiver-format") for f in res["new"])
    assert any(f.rule == rule for f in res["new"])
    theirs = jax_lint([str(FIXTURES)], rules=[rule])
    assert _keys(res["new"]) == _keys(theirs["new"])
