"""The port's steady-state guard (`tpu_tree_search_torch/analysis/guard.py`,
``TTS_GUARD`` / ``--guard``) on the CPU, held to the JAX package's
(`tpu_tree_search/analysis/guard.py`, tests/test_guard.py).

  * the knob's resolution, the warm dispatch, ``rearm`` and the disabled
    no-op, as the JAX guard's;
  * a fake program whose steady-state dispatch builds a graph raises
    ``GuardViolation`` naming the dispatch;
  * the synchronising-call check's thread attribution, with torch's sync
    debug mode stubbed (this build has no CUDA): a synchronising call of
    the guarded thread raises, another thread's passes silently, and the
    mode and the warning hook come back when the last guarded enqueue
    closes;
  * guarded CPU searches (the resident engine, the mesh, two dist_mesh
    virtual hosts, a 2-slot batch in the serve daemon) complete with the
    JAX package's counts after more than one dispatch;
  * the CLI: ``--guard`` pins ``TTS_GUARD=1`` for the run only, and is
    refused off the resident loops with the JAX CLI's reason.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
import warnings

import pytest
import torch

from tpu_tree_search.analysis.guard import guard_enabled as jax_guard_enabled
from tpu_tree_search.engine import sequential_search as jax_sequential
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.analysis import guard as G
from tpu_tree_search_torch.analysis.guard import (
    GuardViolation,
    SteadyStateGuard,
    guard_enabled,
)
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.ops._build import build_counts, count_build
from tpu_tree_search_torch.parallel.dist_mesh import dist_mesh_search
from tpu_tree_search_torch.parallel.resident_mesh import mesh_resident_search
from tpu_tree_search_torch.problems import NQueensProblem
from tpu_tree_search_torch.serve.server import ServeDaemon

SYNC = "called a synchronizing CUDA operation"


def _jax_counts(N):
    res = jax_sequential(JaxNQueens(N=N))
    return res.explored_tree, res.explored_sol


@pytest.mark.parametrize("env,flag", [
    (None, None), (None, True), ("1", None), ("1", False), ("0", None),
    ("", None), ("0", True)])
def test_guard_enabled_resolution_equals_jax(monkeypatch, env, flag):
    if env is None:
        monkeypatch.delenv("TTS_GUARD", raising=False)
    else:
        monkeypatch.setenv("TTS_GUARD", env)
    assert guard_enabled(flag) == jax_guard_enabled(flag)


class _FakeProgram:
    """A program whose dispatch may build a graph (the counterpart of the
    JAX test's jitted function called at a new shape)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device) if device == "cpu" else \
            type("D", (), {"type": device})()

    def step(self, build=False):
        if build:
            count_build("graphs")


def test_guard_catches_a_steady_state_build():
    prog = _FakeProgram()
    g = SteadyStateGuard(prog, "test step")
    with g.step():
        prog.step(build=True)  # warm: the build is expected
    with g.step():
        prog.step()
    before = build_counts()
    with pytest.raises(GuardViolation, match=r"test step: steady-state "
                       r"dispatch 3 built something \(graphs \d+ -> \d+\)"):
        with g.step():
            prog.step(build=True)
    assert build_counts()["graphs"] == before.get("graphs", 0) + 1
    assert (g.warm, g.checked) == (1, 2)


def test_build_counts_are_per_thread():
    """Another thread's build is not this thread's dispatch's."""
    prog = _FakeProgram()
    g = SteadyStateGuard(prog, "test step")
    with g.step():
        pass
    with g.step():
        t = threading.Thread(target=count_build, args=("graphs",))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert g.checked == 1


def test_guard_rearm_accepts_a_new_warm_dispatch():
    prog = _FakeProgram()
    g = SteadyStateGuard(prog, "test step")
    with g.step():
        prog.step(build=True)
    g.rearm()
    with g.step():  # warm again: the rebuild is sanctioned
        prog.step(build=True)
    with g.step():
        prog.step()
    assert (g.warm, g.checked) == (2, 1)
    rec = G.guard_record([g])
    assert (rec["warm_dispatches"], rec["checked_dispatches"],
            rec["checks"]) == (2, 1, ["builds"])
    assert "synchronising calls" in rec["not_checked"]


def test_guard_disabled_is_noop():
    prog = _FakeProgram()
    g = SteadyStateGuard(prog, "test step", enabled=False)
    for _ in range(3):
        with g.step():
            prog.step(build=True)
    assert g.steps == 0 and G.guard_record([g]) is None


@pytest.fixture
def stub_sync_mode(monkeypatch):
    """torch's sync debug mode, stubbed: this build has no CUDA. Records
    each mode the guard sets, and warns as torch's switch may (the guard
    must neither deadlock on nor swallow it)."""
    modes = [0]

    def set_mode(mode):
        warnings.warn(f"sync debug mode set to {mode}")
        modes.append(mode)

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return modes


def test_sync_call_in_a_guarded_enqueue_raises(stub_sync_mode, monkeypatch):
    prog = _FakeProgram("cuda")
    g = SteadyStateGuard(prog, "resident step")
    assert g.sync_check
    with pytest.warns(UserWarning, match="synchroniz"), g.step():
        warnings.warn(SYNC)  # warm: unchecked, and the mode is off
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *a, **k: shown.append(str(message)))
    for _ in range(2):  # a repeat at one call site is caught too
        with pytest.raises(GuardViolation, match="resident step: "
                           "synchronising call in steady-state dispatch"):
            with g.step():
                warnings.warn(SYNC)
    assert stub_sync_mode == [0, "warn", 0, "warn", 0]
    # The hook stays in place, and hands a sync warning that no guarded
    # enqueue made to the showwarning it replaced.
    warnings.warn(SYNC)
    assert shown[-1] == SYNC
    assert G.guard_record([g])["checks"] == ["builds", "sync"]


def test_another_threads_sync_call_passes(stub_sync_mode, capsys):
    """A sanctioned read of another thread while a guarded enqueue is open
    raises nothing and prints nothing, as it would unguarded; the mode
    stays armed until the last of two overlapping enqueues closes."""
    prog = _FakeProgram("cuda")
    g = SteadyStateGuard(prog, "resident step")
    with g.step():
        pass
    errors = []
    opened, release = threading.Event(), threading.Event()

    def other_guarded():
        g2 = SteadyStateGuard(prog, "other")
        with g2.step():
            pass
        try:
            with g2.step():
                opened.set()
                release.wait(timeout=30)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    t = threading.Thread(target=other_guarded)
    t.start()
    assert opened.wait(timeout=30)
    with g.step():
        reader = threading.Thread(target=lambda: warnings.warn(SYNC))
        reader.start()
        reader.join(timeout=30)
        assert not reader.is_alive()
    assert stub_sync_mode[-1] == "warn"  # the other enqueue is still open
    release.set()
    t.join(timeout=30)
    assert not t.is_alive() and errors == []
    assert stub_sync_mode[-1] == 0 and stub_sync_mode.count("warn") == 1
    assert SYNC not in capsys.readouterr().err


def test_resident_steady_state_is_pure_under_guard():
    res = resident_search(NQueensProblem(9), m=25, M=128, K=2, device="cpu",
                          guard=True)
    assert res.complete
    assert res.diagnostics.kernel_launches > 2 and res.dispatches > 1
    assert (res.explored_tree, res.explored_sol) == _jax_counts(9)
    assert res.guard["checked_dispatches"] == res.dispatches - 1
    assert res.guard["warm_dispatches"] == 1


def test_resident_guard_env_knob_and_k_rungs(monkeypatch):
    """TTS_GUARD=1 arms it; under K auto each rung's first dispatch is its
    warm one."""
    monkeypatch.setenv("TTS_GUARD", "1")
    res = resident_search(NQueensProblem(8), m=25, M=64, K=2, device="cpu")
    assert res.complete and res.diagnostics.kernel_launches > 2
    assert res.guard["checked_dispatches"] >= 1
    res = resident_search(NQueensProblem(10), m=25, M=64, K="auto",
                          device="cpu")
    assert (res.explored_tree, res.explored_sol) == _jax_counts(10)
    assert res.guard["warm_dispatches"] >= 1
    assert (res.guard["warm_dispatches"] + res.guard["checked_dispatches"]
            == res.dispatches)


def test_unfused_guarded_search_on_the_cpu():
    res = resident_search(NQueensProblem(9), m=25, M=128, K=2, device="cpu",
                          fused=False, guard=True)
    assert (res.explored_tree, res.explored_sol) == _jax_counts(9)
    assert res.guard["checked_dispatches"] >= 1


def test_mesh_resident_guard():
    res = mesh_resident_search(NQueensProblem(9), m=5, M=64, K=2, D=2,
                               device="cpu", guard=True)
    assert res.complete and res.dispatches > 1
    assert (res.explored_tree, res.explored_sol) == _jax_counts(9)
    assert res.guard["checked_dispatches"] >= 1


def test_dist_mesh_guard_two_virtual_hosts():
    res = dist_mesh_search(NQueensProblem(9), m=5, M=64, K=2, D=2,
                           num_hosts=2, device="cpu", guard=True)
    assert res.complete
    assert (res.explored_tree, res.explored_sol) == _jax_counts(9)
    assert res.guard["checked_dispatches"] >= 1


def test_batched_daemon_jobs_under_guard(tmp_path, monkeypatch):
    """Two same-class jobs through a 2-slot batch under TTS_GUARD=1: the
    batched dispatches' enqueues are guarded, and the counts are JAX's."""
    monkeypatch.setenv("TTS_GUARD", "1")
    d = ServeDaemon(port=0, state_dir=str(tmp_path / "state"), device="cpu",
                    batch_slots=2)
    d._http_thread = threading.Thread(
        target=d._httpd.serve_forever, kwargs={"poll_interval": 0.2},
        daemon=True)
    d._http_thread.start()
    try:
        ids = []
        for _ in range(2):
            req = urllib.request.Request(
                d.url + "/submit", headers={"Content-Type": "application/json"},
                data=json.dumps({"problem": "nqueens", "N": 10, "M": 256,
                                 "K": 4}).encode())
            with urllib.request.urlopen(req, timeout=30) as r:
                ids.append(json.loads(r.read())["id"])
        d.scheduler.start()
        deadline = time.monotonic() + 120
        recs = {}
        while len(recs) < 2 and time.monotonic() < deadline:
            for jid in ids:
                with urllib.request.urlopen(f"{d.url}/job/{jid}",
                                            timeout=30) as r:
                    rec = json.loads(r.read())
                if rec["state"] in ("done", "failed", "cancelled"):
                    recs[jid] = rec
            time.sleep(0.05)
        assert len(recs) == 2
        for rec in recs.values():
            assert rec["state"] == "done", rec.get("error")
            res = rec["result"]
            assert (res["explored_tree"], res["explored_sol"]) == \
                _jax_counts(10)
            assert res["guard"]["checked_dispatches"] >= 1
    finally:
        d.scheduler.drain(timeout_s=30.0)
        d.close()


def test_cli_guard_pins_the_knob_for_the_run(monkeypatch, capsys):
    monkeypatch.delenv("TTS_GUARD", raising=False)
    assert cli.main(["nqueens", "--N", "8", "--device", "cpu", "--M", "64",
                     "--K", "2", "--guard", "--json"]) == 0
    out = capsys.readouterr().out
    rec = json.loads(out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == _jax_counts(8)
    assert rec["guard"]["checked_dispatches"] >= 1
    assert "Steady-state guard:" in out and "not checked" in out
    assert "TTS_GUARD" not in os.environ


@pytest.mark.parametrize("argv", [
    ["nqueens", "--N", "8", "--tier", "seq", "--guard"],
    ["nqueens", "--N", "8", "--engine", "offload", "--guard"],
    ["nqueens", "--N", "8", "--tier", "dist", "--guard"],
])
def test_cli_guard_flag_rejected_off_resident_tiers(argv, capsys):
    assert cli.main(argv + ["--device", "cpu"] if "seq" not in argv
                    else argv) == 2
    err = capsys.readouterr().err
    assert err.startswith("Error: --guard asserts steady-state purity")
