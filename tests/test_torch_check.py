"""``check``, the port's program contract auditor, against the JAX package's
(`tests/test_contracts.py` on `tpu_tree_search/analysis/`).

Three layers, as there:

* registry mechanics (declaration next to the code, a name registered
  twice, the bar, every JAX contract mapped to a port counterpart or a
  written reason);
* **tamper tests** — break each contract class's subject (a sort smuggled
  into the dense cycle, a collapsed or forked cache key, counters leaking
  into the off path, a clock in an unarmed cycle, an ``.item()`` in the
  cycle, a drifted fingerprint, a lock cycle) and the matching named
  contract fires, and ``check`` exits 1;
* the CLI (``check --list``, ``--family``, ``--update`` round trip, the
  whole matrix clean against the committed ``.tts-torch-contracts.json``).

Everything runs on the CPU: each cell's program is recorded under the
``TorchDispatchMode`` recorder (`analysis/contracts.py`); the card's graph
claims are exercised here on made-up node lists.
"""

from __future__ import annotations

import os
from pathlib import Path

import pytest

from tpu_tree_search.analysis import program_audit as jax_audit
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.analysis import contracts, program_audit
from tpu_tree_search_torch.engine import resident as resident_mod
from tpu_tree_search_torch.obs import counters as obs_counters
from tpu_tree_search_torch.obs import phases as obs_phases

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "lint"

program_audit.load_contracts()


def _check_family(capsys) -> tuple[int, str]:
    """``check --family nqueens --no-locks --device cpu``: its exit code
    and output."""
    rc = cli.main(["check", "--family", "nqueens", "--no-locks", "--device",
                   "cpu"])
    return rc, capsys.readouterr().out


# -- registry mechanics ----------------------------------------------------


def test_registry_meets_the_contract_bar():
    reg = program_audit.load_contracts()
    assert len(reg) >= 20
    assert {
        "dense-step-no-sort-scatter", "dense-ids-shift-only",
        "scatter-ids-unique", "compact-auto-identity",
        "fused-push-single-gather", "pool-in-place",
        "step-callback-armed-only", "program-cache-key-sound",
        "lb2-pair-blocks-one-launch", "obs-off-identity",
        "obs-counter-block", "phaseprof-off-identity",
        "phaseprof-block-leaf", "pipeline-knob-inert", "guard-knob-inert",
        "fused-single-launch", "lock-order-acyclic", "op-fingerprint",
    } <= set(reg)
    # Declared next to the code they pin, not centrally.
    where = {name: c.declared_in for name, c in reg.items()}
    assert where["dense-step-no-sort-scatter"].endswith("ops.compaction")
    assert where["pool-in-place"].endswith("engine.resident")
    assert where["obs-off-identity"].endswith("obs.counters")
    assert where["fused-single-launch"].endswith("ops.cycle")
    assert where["lb2-pair-blocks-one-launch"].endswith("ops.pfsp_device")
    assert where["lock-order-acyclic"].endswith("analysis.lockorder")
    for c in reg.values():
        assert c.claim and c.artifact


def test_contract_name_collision_rejected():
    with pytest.raises(ValueError, match="already declared"):
        contracts.contract("pool-in-place", claim="imposter",
                           artifact="cycle")(lambda a, c: [])
    assert contracts.get("pool-in-place").claim != "imposter"


def test_unknown_contract_name_raises():
    with pytest.raises(KeyError, match="unknown contract"):
        contracts.get("no-such-contract")


def test_every_jax_contract_has_a_counterpart_or_a_reason():
    theirs = set(jax_audit.load_contracts())
    mine = set(program_audit.load_contracts())
    mapped = set(program_audit.JAX_COUNTERPARTS)
    reasons = program_audit.NO_COUNTERPART
    assert theirs <= mapped | set(reasons), sorted(theirs - mapped - set(reasons))
    assert not mapped & set(reasons)
    for name, ports in program_audit.JAX_COUNTERPARTS.items():
        assert ports and set(ports) <= mine, (name, ports)
    assert all(isinstance(r, str) and r for r in reasons.values())
    # Every port contract stands for a JAX one.
    assert mine == {p for ps in program_audit.JAX_COUNTERPARTS.values()
                    for p in ps}


# -- what the recorder sees --------------------------------------------------


def test_a_route_is_one_entry_named_after_its_wrapper():
    art = program_audit.record_cell(program_audit.Cell("pfsp-lb1",
                                                       compact="dense"))
    names = [e.name for e in art.record.body]
    assert names.count("lb1_bounds_cuda") == 1
    assert names[-1] == "dispatch_cond"
    assert [e.name for e in art.record.outer] == ["dispatch_init", "while"]
    # The plain lb1 bound's own operations stay inside its entry.
    assert "lb1_bounds_cuda" in art.eval_counts
    # A fused cycle sets the loop condition itself: its body is its route.
    fused = program_audit.record_cell(program_audit.Cell(
        "pfsp-lb1", cycle="fused"))
    assert [e.name for e in fused.record.body] == ["cycle_lb1_cuda"]
    tiled = program_audit.record_cell(program_audit.Cell(
        "nqueens", cycle="fused", mt=program_audit.TILE_MT))
    assert [e.name for e in tiled.record.body] == ["tiled_nqueens_cuda"]


# -- tamper tests: each contract class catches its injected violation ------


def test_tamper_sort_injected_into_dense_compaction(monkeypatch, capsys):
    """Route the dense rank inversion through the sort mode: the dense-path
    contract names the smuggled sort."""
    real = resident_mod.compact_ids

    def tampered(keep, S, mode):
        return real(keep, S, "sort" if mode == "dense" else mode)

    monkeypatch.setattr(resident_mod, "compact_ids", tampered)
    cell = program_audit.Cell("nqueens", compact="dense")
    art = program_audit.record_cell(cell)
    msgs = contracts.run_one("dense-step-no-sort-scatter", art, cell)
    assert msgs and "sort" in msgs[0], msgs
    rc, out = _check_family(capsys)
    assert rc == 1 and "contract:dense-step-no-sort-scatter" in out


def test_tamper_cache_key_collapsed(monkeypatch, capsys):
    """Make the program cache blind to TTS_OBS: the cache-key contract
    reports the flip reusing a stale program."""
    monkeypatch.setattr(obs_counters, "device_counters_enabled",
                        lambda: False)
    art = program_audit.cache_key_artifact("nqueens")
    msgs = contracts.run_one("program-cache-key-sound", art)
    assert any("TTS_OBS" in m and "reused" in m for m in msgs), msgs
    rc, out = _check_family(capsys)
    assert rc == 1 and "contract:program-cache-key-sound" in out


def test_tamper_cache_key_forked_by_host_knob(monkeypatch, capsys):
    """Leak the host-only TTS_PIPELINE into the program key: the cache-key
    contract reports the forked program."""
    real = resident_mod.program_key
    monkeypatch.setattr(
        resident_mod, "program_key",
        lambda *a, **k: real(*a, **k) + (os.environ.get("TTS_PIPELINE"),))
    art = program_audit.cache_key_artifact("nqueens")
    msgs = contracts.run_one("program-cache-key-sound", art)
    assert any("TTS_PIPELINE" in m and "rebuilt" in m for m in msgs), msgs
    rc, out = _check_family(capsys)
    assert rc == 1 and "contract:program-cache-key-sound" in out


def test_tamper_counters_leak_into_off_path(monkeypatch, capsys):
    """Arm the counter block unconditionally: the off-identity contract
    notices the off build carries it."""
    monkeypatch.setattr(obs_counters, "device_counters_enabled",
                        lambda: True)
    art = program_audit.variant_artifact(
        "nqueens", labels=["off", "obs0", "obs-host", "obs1"])
    msgs = contracts.run_one("obs-off-identity", art)
    assert msgs and "counter block" in " ".join(msgs), msgs
    rc, out = _check_family(capsys)
    assert rc == 1 and "contract:obs-off-identity" in out


def test_tamper_phase_clock_in_unarmed_cycle(monkeypatch, capsys):
    """Arm the phase clock unconditionally: the steady-state contract
    flags the clock inside an unarmed cell."""
    monkeypatch.setattr(obs_phases, "phase_profiling_enabled", lambda: True)
    cell = program_audit.Cell("nqueens", phaseprof="0")
    art = program_audit.record_cell(cell)
    msgs = contracts.run_one("step-callback-armed-only", art, cell)
    assert msgs and "unarmed" in msgs[0], msgs
    rc, out = _check_family(capsys)
    assert rc == 1 and "contract:step-callback-armed-only" in out


def test_tamper_item_in_the_cycle(monkeypatch, capsys):
    """Read the survivor count back in the cycle (a fault once found on
    the card as a guarded search raising at dispatch 2): the steady-state
    contract names the host read."""
    real = resident_mod.compact_ids

    def reads(keep, S, mode):
        ids, tree_inc = real(keep, S, mode)
        tree_inc.item()
        return ids, tree_inc

    monkeypatch.setattr(resident_mod, "compact_ids", reads)
    cell = program_audit.Cell("nqueens", compact="scatter")
    art = program_audit.record_cell(cell)
    msgs = contracts.run_one("step-callback-armed-only", art, cell)
    assert msgs and "_local_scalar_dense" in msgs[0], msgs
    rc, out = _check_family(capsys)
    assert rc == 1 and "contract:step-callback-armed-only" in out


def test_tamper_fingerprint_drift(tmp_path, capsys):
    """A histogram differing from the baseline fails with the named cell
    and a per-entry diff; so do a moved entry count and missing or stale
    cells, and a missing baseline says how to make one."""
    import torch

    baseline = {"torch": torch.__version__,
                "cells": {"cellA": {"ops": {"index": 1, "while": 1},
                                    "entries": 7}}}
    current = {"cellA": {"ops": {"index": 2, "while": 1}, "entries": 7}}
    msgs = contracts.run_one("op-fingerprint", {
        "current": current, "baseline": baseline, "path": "x.json"})
    assert msgs == ["cellA: op drift — index: 1 -> 2"], msgs
    current2 = {"cellA": {"ops": {"index": 1, "while": 1}, "entries": 8},
                "cellB": {"ops": {}}}
    msgs2 = contracts.run_one("op-fingerprint", {
        "current": current2, "baseline": baseline, "path": "x.json"})
    assert any("entry count 7 -> 8" in m for m in msgs2)
    assert any("cellB" in m and "missing" in m for m in msgs2)
    msgs3 = contracts.run_one("op-fingerprint", {
        "current": current, "baseline": None, "path": "x.json"})
    assert msgs3 and "--update" in msgs3[0]
    # The whole check against a tampered copy of the committed baseline.
    doc = program_audit.load_baseline(str(REPO / program_audit.DEFAULT_BASELINE))
    key = "nqueens|compact=dense|obs=0|ph=0"
    doc["cells"][key]["ops"]["sort"] = 1
    bad = tmp_path / "drift.json"
    bad.write_text(__import__("json").dumps(doc))
    res = program_audit.run_check(baseline_path=str(bad), with_locks=False,
                                  device="cpu")
    drift = [f for f in res.findings if f.rule == "contract:op-fingerprint"]
    assert [f.message for f in drift] == [f"{key}: op drift — sort: 1 -> 0"]
    assert cli.main(["check", "--no-locks", "--baseline", str(bad),
                     "--device", "cpu"]) == 1
    assert "op drift" in capsys.readouterr().out


def test_tamper_lock_cycle_detected(monkeypatch, capsys):
    """A deliberate A->B / B->A blocking cycle fails the lock-order
    contract (the fixture of the lint tests)."""
    findings = program_audit.audit_locks(
        paths=[str(FIXTURES / "bad_lock_order.py")])
    assert findings
    assert all(f.rule == "contract:lock-order-acyclic" for f in findings)
    text = " ".join(f.message for f in findings)
    assert "A.lock -> B.lock -> A.lock" in text
    assert "same-class" in text
    real = program_audit.audit_locks
    monkeypatch.setattr(program_audit, "audit_locks", lambda paths=None: real(
        [str(FIXTURES / "bad_lock_order.py")]))
    assert cli.main(["check", "--family", "nqueens", "--device", "cpu"]) == 1
    assert "contract:lock-order-acyclic" in capsys.readouterr().out


def test_card_graph_claims_read_the_node_lists():
    """The card's node-level claims, on made-up node lists: a memcpy with a
    host end in a body, a torch kernel in a fused body, a wrong last node
    under TTS_OBS=1."""
    E = contracts.Entry
    cell = program_audit.Cell("nqueens", cycle="fused")
    art = program_audit.record_cell(cell)
    art.record.nodes = {
        "outer": [("_Z13dispatch_init", "kernel"), ("conditional",
                                                    "conditional")],
        "body": [("_Z10nq_cycle_labels", "kernel"),
                 ("memcpy_host", "memcpy_host"),
                 ("_ZN2at6native18elementwise_kernel", "kernel"),
                 ("_Z13dispatch_cond", "kernel")]}
    msgs = contracts.run_one("step-callback-armed-only", art, cell)
    assert any("memcpy_host" in m for m in msgs), msgs
    msgs = contracts.run_one("fused-single-launch", art, cell)
    assert any("at6native" in m for m in msgs), msgs
    off = contracts.Record([E("route", "dispatch_init")],
                           [E("route", "cycle_nqueens_cuda"),
                            E("route", "dispatch_cond")], {"obs": False})
    on = contracts.Record([E("route", "dispatch_init")],
                          [E("route", "cycle_nqueens_cuda"),
                           E("route", "dispatch_cond_obs")], {"obs": True},
                          {"outer": [], "body": [("_Z13dispatch_cond",
                                                  "kernel")]})
    msgs = contracts.run_one("obs-counter-block", contracts.VariantArtifact(
        {"off": off, "obs1": on}, fused=True))
    assert any("last body node" in m for m in msgs), msgs


def test_host_node_in_a_nested_graph_is_found():
    """A host node in a graph nested in the body (a batch slot's gated
    body) breaks the claim as one in the body does; the batched programs'
    records are held to it too."""
    from types import SimpleNamespace

    rec = contracts.Record([], [], {}, {
        "outer": [("_Z10batch_init", "kernel")],
        "body": [("_Z9slot_gate", "kernel"), ("conditional", "conditional")],
        "gate1": [("_Z12lb1_bounds", "kernel"), ("host", "host")]})
    msgs = contracts.run_one("step-callback-armed-only",
                             SimpleNamespace(record=rec))
    assert any("gate1" in m and "host" in m for m in msgs), msgs
    assert program_audit.audit_batched(widths=(1,)) == []


# -- audit mechanics -------------------------------------------------------


def test_matrix_cells_cover_every_axis():
    cells = program_audit.matrix_cells()
    keys = {c.key for c in cells}
    assert len(keys) == len(cells)  # no duplicate cells
    assert {c.family for c in cells} == set(program_audit.FAMILIES)
    assert {c.compact for c in cells} == set(program_audit.COMPACT_AXIS)
    for fam in program_audit.FAMILIES:
        unfused = [c for c in cells if c.family == fam and not c.fused]
        assert len(unfused) == 5 * 2 * 2
        fused = [c for c in cells if c.family == fam and c.fused]
        assert {(c.obs, c.phaseprof) for c in fused} == {
            ("0", "0"), ("0", "1"), ("1", "0"), ("1", "1")}
        assert any(c.mt for c in fused) == (fam != "pfsp-lb1d")


def test_pin_is_hermetic(monkeypatch):
    """The audit's pin isolates from the caller's knobs and restores
    them."""
    monkeypatch.setenv("TTS_COMPACT", "sort")
    monkeypatch.setenv("TTS_OBS", "1")
    with program_audit._pin({"TTS_PHASEPROF": "1", "TTS_NARROW": "0"}):
        assert os.environ.get("TTS_COMPACT") is None
        assert os.environ.get("TTS_OBS") is None
        assert os.environ.get("TTS_PHASEPROF") == "1"
        assert os.environ.get("TTS_NARROW") == "0"
    assert os.environ.get("TTS_COMPACT") == "sort"
    assert os.environ.get("TTS_OBS") == "1"
    assert os.environ.get("TTS_PHASEPROF") is None
    assert os.environ.get("TTS_NARROW") is None


def test_committed_baseline_is_loadable_and_hashed():
    path = str(REPO / program_audit.DEFAULT_BASELINE)
    doc = program_audit.load_baseline(path)
    assert doc is not None, "commit .tts-torch-contracts.json (check --update)"
    assert doc["fingerprint"] == program_audit._hash_cells(doc["cells"])
    assert len(doc["cells"]) >= 100  # the whole matrix, not a stub
    assert doc["torch"]


# -- CLI surfaces ----------------------------------------------------------


def test_cli_check_list(capsys):
    assert cli.main(["check", "--list"]) == 0
    out = capsys.readouterr().out
    assert "dense-step-no-sort-scatter  [cycle]" in out
    assert "lock-order-acyclic" in out


def test_cli_check_family_end_to_end(capsys):
    rc, out = _check_family(capsys)
    assert rc == 0, out
    assert "check: 0 finding(s) over 25 matrix cells" in out


def test_cli_check_rejects_update_with_family(capsys):
    assert cli.main(["check", "--update", "--family", "nqueens"]) == 2


def test_cli_check_update_roundtrip(tmp_path, capsys):
    """--update writes a loadable baseline whose hash matches its cells
    (family-scoped, into a temp file), and the JSON report reads it."""
    bl = tmp_path / "contracts.json"
    res = program_audit.run_check(families=["nqueens"], update=True,
                                  baseline_path=str(bl), with_locks=False,
                                  device="cpu")
    assert res.findings == [], [f.render() for f in res.findings]
    doc = program_audit.load_baseline(str(bl))
    assert doc is not None and res.updated == str(bl)
    assert doc["fingerprint"] == program_audit._hash_cells(doc["cells"])
    assert set(doc["cells"]) == {c.key for c in
                                 program_audit.matrix_cells(["nqueens"])}


def test_cli_check_whole_matrix_is_clean(capsys):
    """The acceptance bar: `check` exits 0 on the CPU with no findings over
    every cell, the committed fingerprint included."""
    assert cli.main(["check", "--json", "--device", "cpu"]) == 0
    rep = __import__("json").loads(capsys.readouterr().out.strip())
    assert rep["findings"] == [] and rep["warnings"] == []
    assert rep["cells"] == len(program_audit.matrix_cells())
    doc = program_audit.load_baseline(str(REPO / program_audit.DEFAULT_BASELINE))
    assert rep["fingerprint"] == doc["fingerprint"]
