"""The port's dispatch pipeline against the JAX package's, on the CPU.

  * the controllers: ``AdaptiveK``, ``resolve_k``,
    ``resolve_pipeline_depth`` and ``DispatchQueue`` of
    ``tpu_tree_search_torch.engine.pipeline`` give the outputs and raise
    the ``ValueError``s of ``tpu_tree_search.engine.pipeline`` on the same
    inputs (the ladders, a decision sequence drawn with numpy from a seed,
    every knob value of `tests/test_pipeline.py`);
  * the searches: ``resident_search(device="cpu")`` at ``TTS_PIPELINE``
    0-3 and at ``K="auto"`` gives the tree, sol and best of the JAX
    ``resident_search`` on the CPU and of the goldens (N-Queens N=8 and 10,
    a reduced ta014 under lb1 and lb2, fused and unfused);
  * the controller in the loop: a search under ``K="auto"`` reports
    ``k_auto`` and a K on the ladder;
  * refusals reach the CLI user as ``Error:`` and exit 2, never a
    traceback.

Tolerance: exact equality (integer counts and controller decisions).
"""

from __future__ import annotations

import numpy as np
import pytest

from tpu_tree_search.engine import pipeline as jax_pipeline
from tpu_tree_search.engine.resident import resident_search as jax_resident_search
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine import pipeline
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

PTM = taillard.reduced_instance(14, jobs=10, machines=5)
# The reduced ta014 corner under its optimal incumbent 609 (lb1: the JAX
# sequential tier's counts, tests/test_torch_resident.py; lb2: the same).
REDUCED = {"lb1": (2074, 90, 609), "lb2": (326, 0, 609)}
NQ_GOLDEN = {8: (2056, 92), 10: (35538, 724)}


# -- the controllers -----------------------------------------------------------


@pytest.mark.parametrize("k_max", [1, 7, 4096, 2184])
def test_adaptive_k_ladders_match_jax(k_max):
    assert pipeline.AdaptiveK(k_max).ladder == \
        jax_pipeline.AdaptiveK(k_max).ladder
    # At most 8 rungs, factor 4 from the cap down to 1.
    ladder = pipeline.AdaptiveK(k_max).ladder
    assert ladder[-1] == k_max and ladder[0] == 1 and len(ladder) <= 8


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k_max", [4096, 2184])
def test_adaptive_k_decisions_match_jax(seed, k_max):
    rng = np.random.default_rng(seed)
    ours = pipeline.AdaptiveK(k_max)
    theirs = jax_pipeline.AdaptiveK(k_max)
    for _ in range(200):
        # Per-cycle times over four decades, some empty or partial
        # dispatches.
        per_cycle = 10.0 ** rng.uniform(-6, -2)
        cycles = int(rng.integers(0, ours.K + 1)) if rng.random() < 0.3 \
            else ours.K
        period = per_cycle * max(cycles, 1)
        assert ours.observe(period, cycles) == theirs.observe(period, cycles)
        assert (ours.K, ours.idx, ours.resizes) == (
            theirs.K, theirs.idx, theirs.resizes)


_DEPTH_CASES = [(None, "auto"), ("0", None), ("1", None), ("2", None),
                ("3", None), (None, "0"), (None, "3"), ("4", None),
                ("fast", None), (None, "-1"), (None, "x")]


@pytest.mark.parametrize("knob,env", _DEPTH_CASES)
def test_pipeline_depth_matches_jax(monkeypatch, knob, env):
    if env is None:
        monkeypatch.delenv("TTS_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("TTS_PIPELINE", env)

    def outcome(fn):
        try:
            return fn(knob)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(pipeline.resolve_pipeline_depth) == \
        outcome(jax_pipeline.resolve_pipeline_depth)


_K_CASES = [(None, 4096, 4096), (None, "auto", 16), (None, "sometimes", 16),
            ("auto", 64, 4096), ("auto", "auto", 4096), ("128", 4096, 4096),
            ("bogus", 4096, 4096), ("0", 7, 4096), (None, 0, 4096)]


@pytest.mark.parametrize("env,K,default_max", _K_CASES)
def test_resolve_k_matches_jax(monkeypatch, env, K, default_max):
    if env is None:
        monkeypatch.delenv("TTS_K", raising=False)
    else:
        monkeypatch.setenv("TTS_K", env)

    def outcome(fn):
        try:
            return fn(K, default_max)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(pipeline.resolve_k) == outcome(jax_pipeline.resolve_k)


def test_dispatch_queue_matches_jax():
    for Q in (pipeline.DispatchQueue, jax_pipeline.DispatchQueue):
        q = Q(2)
        assert not q.full and len(q) == 0 and q.depth == 2
        q.push("a", 1.0)
        q.push("b", 2.0)
        assert q.full
        with pytest.raises(RuntimeError, match="overfull"):
            q.push("c", 3.0)
        assert q.pop() == ("a", 1.0)
        assert list(q.drain()) == [("b", 2.0)]
        assert len(q) == 0
        assert Q(0).depth == 1
    assert (pipeline.MAX_DEPTH, pipeline.RESIDENT_TARGET,
            pipeline.MESH_TARGET) == (jax_pipeline.MAX_DEPTH,
                                      jax_pipeline.RESIDENT_TARGET,
                                      jax_pipeline.MESH_TARGET)


def test_target_band_default_and_costmodel_refusal(monkeypatch, tmp_path):
    # TTS_COSTMODEL resolves the band as the JAX function does: unset, "0",
    # a missing or a corrupt profile give the default band; a profile with
    # a matching entry gives JAX's band (the CPU's key is "cpu").
    from tpu_tree_search_torch.obs import costmodel

    monkeypatch.delenv("TTS_COSTMODEL", raising=False)
    band = pipeline.resolve_target_band("resident", pipeline.RESIDENT_TARGET)
    assert band == jax_pipeline.resolve_target_band(
        "resident", jax_pipeline.RESIDENT_TARGET) == (
        pipeline.RESIDENT_TARGET, None)
    monkeypatch.setenv("TTS_COSTMODEL", "0")
    assert pipeline.resolve_target_band("resident", (1.0, 2.0)) == (
        (1.0, 2.0), None)
    (tmp_path / "corrupt.json").write_text("{not json")
    for path in ("profile.json", str(tmp_path / "corrupt.json")):
        monkeypatch.setenv("TTS_COSTMODEL", path)
        assert pipeline.resolve_target_band(
            "resident", pipeline.RESIDENT_TARGET, device="cpu") == \
            jax_pipeline.resolve_target_band(
                "resident", jax_pipeline.RESIDENT_TARGET) == (
            pipeline.RESIDENT_TARGET, None)
    prof = str(tmp_path / "COSTMODEL.json")
    evts = [{"name": "dispatch", "ph": "X", "ts": float(i),
             "dur": 20_000.0 + 5.0 * c, "args": {"cycles": c}}
            for i, c in enumerate((2, 4, 8, 16, 32))]
    costmodel.save(prof, costmodel.build_profile(evts, "cpu", "device-D1",
                                                 "nqueens_n10"))
    monkeypatch.setenv("TTS_COSTMODEL", prof)
    got = pipeline.resolve_target_band(
        "resident", pipeline.RESIDENT_TARGET, NQueensProblem(10),
        topology="device-D1", device="cpu")
    assert got == jax_pipeline.resolve_target_band(
        "resident", jax_pipeline.RESIDENT_TARGET, JaxNQueens(10),
        topology="device-D1")
    assert got[1] == "cpu|device-D1|nqueens_n10" and got[0] != (
        pipeline.RESIDENT_TARGET)


# -- the searches --------------------------------------------------------------

_PROBLEMS = ["nq8", "nq10", "lb1", "lb2"]


def _problem(name: str, jax: bool):
    if name.startswith("nq"):
        return (JaxNQueens if jax else NQueensProblem)(int(name[2:]))
    return (JaxPFSP if jax else PFSPProblem)(lb=name, ub=0, p_times=PTM)


def _kwargs(name: str) -> dict:
    return {} if name.startswith("nq") else {"initial_best": 609}


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


def _golden(name: str):
    if name.startswith("nq"):
        return NQ_GOLDEN[int(name[2:])]
    return REDUCED[name]


@pytest.fixture(scope="module")
def jax_counts():
    """The JAX resident engine's counts on the CPU, at K="auto" and the
    default pipeline depth (its counts do not depend on either)."""
    return {name: _counts(jax_resident_search(
        _problem(name, True), m=8, M=64, K="auto", **_kwargs(name)))
        for name in _PROBLEMS}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("K", [16, "auto"])
@pytest.mark.parametrize("depth", ["0", "1", "2", "3"])
@pytest.mark.parametrize("name", _PROBLEMS)
def test_search_at_every_depth_matches_jax_and_goldens(
        monkeypatch, jax_counts, name, depth, K, fused):
    monkeypatch.setenv("TTS_PIPELINE", depth)
    monkeypatch.delenv("TTS_K", raising=False)
    res = resident_search(_problem(name, False), m=8, M=64, K=K,
                          device="cpu", fused=fused, **_kwargs(name))
    counts = _counts(res)
    assert counts == jax_counts[name]
    assert (counts[:2] if name.startswith("nq") else counts) == _golden(name)
    assert res.pipeline_depth == max(1, int(depth))
    assert res.k_auto is (K == "auto")
    assert sum(p.tree for p in res.phases) == res.explored_tree


def test_k_auto_reports_a_rung_of_the_ladder(monkeypatch):
    monkeypatch.delenv("TTS_K", raising=False)
    monkeypatch.delenv("TTS_PIPELINE", raising=False)
    res = resident_search(NQueensProblem(10), m=8, M=64, K="auto",
                          device="cpu")
    assert res.k_auto and res.pipeline_depth == 2
    assert res.k_resolved in pipeline.AdaptiveK(4096).ladder
    assert _counts(res)[:2] == NQ_GOLDEN[10]
    # Pinned K: no controller, K clamped to the int32 counters' headroom.
    fixed = resident_search(NQueensProblem(8), m=8, M=64, device="cpu")
    assert (fixed.k_auto, fixed.k_resolved) == (False, 4096)
    monkeypatch.setenv("TTS_K", "auto")
    env = resident_search(NQueensProblem(8), m=8, M=64, K=64, device="cpu")
    assert env.k_auto and env.k_resolved in pipeline.AdaptiveK(64).ladder


def test_cli_reports_the_pipeline(capsys, monkeypatch):
    monkeypatch.delenv("TTS_K", raising=False)
    monkeypatch.setenv("TTS_PIPELINE", "3")
    assert cli.main(["nqueens", "--N", "8", "--device", "cpu", "--M", "64",
                     "--K", "auto", "--json"]) == 0
    out = capsys.readouterr().out
    rec = __import__("json").loads(out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == NQ_GOLDEN[8]
    assert rec["pipeline_depth"] == 3 and rec["k_auto"] is True
    assert f"Dispatch pipeline: depth=3, K={rec['K']} (auto)" in out
    monkeypatch.delenv("TTS_PIPELINE")
    assert cli.main(["nqueens", "--N", "8", "--device", "cpu", "--M", "64",
                     "--json"]) == 0
    rec = __import__("json").loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["K"] == 4096 and "k_auto" not in rec


# -- refusals at the CLI -------------------------------------------------------


@pytest.mark.parametrize("argv,env", [
    (["--K", "banana"], {}),
    (["--K", "0"], {}),
    ([], {"TTS_HBM_GBPS": "-1"}),
    ([], {"TTS_PIPELINE": "9"}),
    ([], {"TTS_K": "bogus"}),
    (["--N", "300"], {}),
    (["--M", "64", "--mt", "12"], {}),
])
def test_cli_refusals_exit_2_without_traceback(capsys, monkeypatch, argv,
                                               env):
    for k in ("TTS_COSTMODEL", "TTS_PIPELINE", "TTS_K", "TTS_HBM_GBPS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = cli.main(["nqueens", "--N", "8", "--device", "cpu", *argv])
    cap = capsys.readouterr()
    assert rc == 2
    assert cap.err.startswith("Error: ") and "Traceback" not in cap.err
    assert cap.out == ""  # refused before the search: no banner


def test_cli_runs_on_the_default_band_with_an_unreadable_costmodel(
        capsys, monkeypatch):
    # TTS_COSTMODEL naming no profile: the run takes the fixed band and
    # exits 0 (the JAX CLI's behaviour), where it was refused before.
    monkeypatch.setenv("TTS_COSTMODEL", "profile.json")
    monkeypatch.delenv("TTS_PIPELINE", raising=False)
    monkeypatch.delenv("TTS_K", raising=False)
    assert cli.main(["nqueens", "--N", "8", "--device", "cpu", "--M", "64",
                     "--K", "auto", "--json"]) == 0
    rec = __import__("json").loads(capsys.readouterr().out.splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == NQ_GOLDEN[8]


def test_cli_lets_errors_inside_the_search_propagate(monkeypatch):
    # Only what `prepare` refuses exits 2; a ValueError raised by the search
    # itself (an engine or wrapper fault) is not a refusal.
    from tpu_tree_search_torch.engine import resident

    def broken(*args, **kwargs):
        raise ValueError("scratch must be cycle_scratch(M, n)")

    monkeypatch.setattr(resident, "resident_search", broken)
    with pytest.raises(ValueError, match="scratch"):
        cli.main(["nqueens", "--N", "8", "--device", "cpu", "--M", "64"])


# -- launch counts under the graph dispatch (ops/dispatch.py) -------------------


def test_count_launch_counts_launches_not_captures():
    # Outside a capture a wrapper counts its launch; under one it counts a
    # capture and the graph counts the body's runs, read after a dispatch,
    # as the wrapper's launches (one a cycle run, none past termination).
    from tpu_tree_search_torch.ops import dispatch

    def wrapper():
        dispatch.count_launch(wrapper)

    wrapper.launches = wrapper.captures = 0
    wrapper()
    assert (wrapper.launches, wrapper.captures) == (1, 0)
    graph = object.__new__(dispatch.DispatchGraph)
    graph.wrappers = []
    with dispatch.recording(graph.wrappers):
        wrapper()
    assert (wrapper.launches, wrapper.captures) == (1, 1)
    graph.count(65)
    graph.count(0)  # a speculative dispatch past termination
    assert (wrapper.launches, wrapper.captures) == (66, 1)
