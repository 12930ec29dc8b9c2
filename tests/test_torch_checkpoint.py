"""Checkpoint and resume of the port (`tpu_tree_search_torch/engine/checkpoint.py`
and ``resident_search``'s ``max_steps``/``checkpoint_path``/``resume_from``/
``yield_fn``) against the JAX package, on the CPU.

  * ``save``/``load`` round trips, and the file is the JAX package's:
    either package loads the other's file to the same frontier;
  * refusals: another problem, another p_times matrix, a v1 PFSP file, a
    per-host file of a multi-host cut;
  * the committed v1 fixture (`tests/data/nqueens_n9_v1.ckpt.npz`, a JAX
    cut) resumes to the sequential goldens;
  * ``TTS_NARROW`` writer/reader crosses;
  * a cut under ``TTS_PIPELINE`` 1 and 2 saves counters that match its
    frontier: the resumed run lands on the goldens;
  * ``yield_fn`` cuts exactly as ``max_steps`` does;
  * across packages, both ways: a JAX ``resident_search(max_steps=2)`` cut
    resumed by the port, and a port cut resumed by the JAX engine, on
    N-Queens N=11 (M=64, K=2, as `tests/test_checkpoint.py`) and on a
    reduced lb1 ub=0 instance (the optimum as a fixed incumbent), each
    landing on the sequential goldens;
  * the CLI's cut and resume on N=10, and its refusals.

Tolerance: exact equality (counts, node values).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from tpu_tree_search.engine import checkpoint as jax_ckpt
from tpu_tree_search.engine.resident import resident_search as jax_resident_search
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine import checkpoint as ckpt
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

FIXTURE = Path(__file__).resolve().parent / "data" / "nqueens_n9_v1.ckpt.npz"
NQ = {9: (8393, 352), 10: (35538, 724), 11: (166925, 2680)}
PTM = taillard.reduced_instance(14, jobs=10, machines=5)
# The reduced instance's optimum and the sequential counts under it as a
# fixed incumbent (the JAX sequential tier; held in
# test_pfsp_goldens_are_the_jax_sequential_ones).
PFSP_OPT = 609
PFSP_SEQ = (2074, 90, 609)


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


def _pfsp():
    return PFSPProblem(lb="lb1", ub=0, p_times=PTM)


def _cut(path, problem, **kw):
    part = resident_search(problem, m=8, M=64, K=2, device="cpu", max_steps=2,
                           checkpoint_path=str(path), **kw)
    assert not part.complete and part.steps == 2 and len(part.phases) == 2
    return part


def test_pfsp_goldens_are_the_jax_sequential_ones():
    from tpu_tree_search.engine.sequential import sequential_search

    assert sequential_search(JaxPFSP(lb="lb1", ub=0, p_times=PTM)).best == PFSP_OPT
    assert _counts(sequential_search(JaxPFSP(lb="lb1", ub=0, p_times=PTM),
                                     initial_best=PFSP_OPT)) == PFSP_SEQ


# -- the file -------------------------------------------------------------------


@pytest.mark.parametrize("problem", ["nqueens", "pfsp"])
def test_save_load_round_trip_in_both_packages(tmp_path, problem):
    rng = np.random.default_rng(5)
    if problem == "nqueens":
        ours, theirs = NQueensProblem(9), JaxNQueens(9)
        board = np.tile(np.arange(9, dtype=np.uint8), (40, 1))
        for row in board:
            rng.shuffle(row)
        batch = {"depth": rng.integers(0, 9, 40).astype(np.int16),
                 "board": board}
    else:
        ours, theirs = _pfsp(), JaxPFSP(lb="lb1", ub=0, p_times=PTM)
        prmu = np.tile(np.arange(10, dtype=np.int8), (40, 1))
        for row in prmu:
            rng.shuffle(row)
        limit1 = rng.integers(-1, 9, 40).astype(np.int16)
        batch = {"depth": (limit1 + 1).astype(np.int16), "limit1": limit1,
                 "prmu": prmu}
    assert ckpt.problem_meta(ours) == jax_ckpt.problem_meta(theirs)
    for writer, path in ((ckpt, tmp_path / "ours.npz"),
                         (jax_ckpt, tmp_path / "theirs.npz")):
        writer.save(str(path), ours if writer is ckpt else theirs, batch,
                    best=777, tree=1234, sol=56)
        for reader, prob in ((ckpt, ours), (jax_ckpt, theirs)):
            c = reader.load(str(path), prob)
            assert (c.best, c.tree, c.sol, c.hosts) == (777, 1234, 56, 1)
            assert sorted(c.batch) == sorted(batch)
            for k, v in batch.items():
                np.testing.assert_array_equal(c.batch[k], v)
        with np.load(path) as data:
            assert json.loads(bytes(data["header"]).decode())["version"] == 3
    # The same file: the same header and the same arrays, dtypes included.
    with np.load(tmp_path / "ours.npz") as a, np.load(tmp_path / "theirs.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(bytes(a["header"]).decode()) == \
            json.loads(bytes(b["header"]).decode())
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_load_refuses_what_it_cannot_resume(tmp_path):
    path = str(tmp_path / "x.npz")
    prob = NQueensProblem(9)
    ckpt.save(path, prob, prob.root(), best=10**9, tree=0, sol=0)
    with pytest.raises(ValueError, match="checkpoint is for"):
        ckpt.load(path, NQueensProblem(10))
    with pytest.raises(ValueError, match="checkpoint is for"):
        ckpt.load(path, PFSPProblem(inst=14))
    # Another p_times matrix of the same shape.
    ptm_b = PTM.copy()
    ptm_b[0, 0] += 1
    ckpt.save(path, _pfsp(), _pfsp().root(), best=10**9, tree=0, sol=0)
    ckpt.load(path, _pfsp())
    with pytest.raises(ValueError, match="checkpoint is for"):
        ckpt.load(path, PFSPProblem(lb="lb1", ub=0, p_times=ptm_b))
    # A v1 PFSP file: its meta cannot prove the matrix.
    meta = {k: v for k, v in ckpt.problem_meta(_pfsp()).items()
            if k != "ptimes_sha"}
    header = {"version": 1, "meta": meta, "best": 10**9, "tree": 5, "sol": 1,
              "fields": sorted(_pfsp().root())}
    with open(path, "wb") as f:
        np.savez_compressed(
            f, header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
            **{f"field_{k}": v for k, v in _pfsp().root().items()})
    with pytest.raises(ValueError, match="v1 PFSP"):
        ckpt.load(path, _pfsp())
    # One host's file of a two-host cut.
    ckpt.save(path, prob, prob.root(), best=10**9, tree=0, sol=0, hosts=2,
              cut_tag="run:3")
    with pytest.raises(ValueError, match="per-host files"):
        ckpt.load(path, prob)
    assert ckpt.load(path, prob, expect_hosts=2).cut_tag == "run:3"


def test_committed_v1_fixture_resumes_to_the_goldens():
    prob = NQueensProblem(9)
    c = ckpt.load(str(FIXTURE), prob)
    assert (c.tree, c.sol) == (734, 0)
    fields = prob.node_fields()
    assert all(v.dtype == fields[k][1] for k, v in c.batch.items())
    done = resident_search(prob, m=8, M=64, K=2, device="cpu",
                           resume_from=str(FIXTURE))
    assert done.complete and done.phases[0].tree == 734
    assert (done.explored_tree, done.explored_sol) == NQ[9]


@pytest.mark.parametrize("writer,reader", [("auto", "0"), ("0", "auto")])
def test_narrow_writer_and_reader_cross(tmp_path, monkeypatch, writer, reader):
    path = tmp_path / f"x{writer}{reader}.npz"
    monkeypatch.setenv("TTS_NARROW", writer)
    _cut(path, _pfsp(), initial_best=PFSP_OPT)
    monkeypatch.setenv("TTS_NARROW", reader)
    prob = _pfsp()
    fields = prob.node_fields()
    c = ckpt.load(str(path), prob)
    assert all(v.dtype == fields[k][1] for k, v in c.batch.items())
    done = resident_search(prob, m=8, M=64, K=2, device="cpu",
                           resume_from=str(path))
    assert done.complete and _counts(done) == PFSP_SEQ


# -- cuts in the resident engine -----------------------------------------------------


@pytest.mark.parametrize("depth", ["1", "2"])
@pytest.mark.parametrize("fused", [True, False])
def test_a_pipelined_cut_saves_counters_that_match_its_frontier(
        tmp_path, monkeypatch, depth, fused):
    # Under TTS_PIPELINE=2 a second dispatch is in flight at the cut: the
    # cut drains it, so its counts are in the saved counters, in the run's
    # own totals, and its work in the saved frontier.
    monkeypatch.setenv("TTS_PIPELINE", depth)
    path = tmp_path / "cut.npz"
    part = _cut(path, NQueensProblem(10), fused=fused)
    saved = ckpt.load(str(path), NQueensProblem(10))
    assert (saved.tree, saved.sol) == (part.explored_tree, part.explored_sol)
    # The steps counted, plus the in-flight one drained at depth 2.
    assert part.dispatches == 2 + (depth == "2")
    done = resident_search(NQueensProblem(10), m=8, M=64, K=2, device="cpu",
                           resume_from=str(path), fused=fused)
    assert (done.explored_tree, done.explored_sol) == NQ[10]
    assert done.phases[0].tree == saved.tree


def test_yield_fn_cuts_as_max_steps_does(tmp_path):
    by_steps = _cut(tmp_path / "steps.npz", NQueensProblem(10))
    calls = []

    def yield_fn():
        calls.append(1)
        return len(calls) == 2

    by_yield = resident_search(NQueensProblem(10), m=8, M=64, K=2,
                               device="cpu", yield_fn=yield_fn,
                               checkpoint_path=str(tmp_path / "yield.npz"))
    assert not by_yield.complete and by_yield.steps == 2
    assert _counts(by_yield) == _counts(by_steps)
    a = ckpt.load(str(tmp_path / "steps.npz"), NQueensProblem(10))
    b = ckpt.load(str(tmp_path / "yield.npz"), NQueensProblem(10))
    assert (a.tree, a.sol, a.best) == (b.tree, b.sol, b.best)
    for k in a.batch:
        np.testing.assert_array_equal(a.batch[k], b.batch[k])


def test_a_cut_without_a_path_writes_nothing(tmp_path):
    part = resident_search(NQueensProblem(10), m=8, M=64, K=2, device="cpu",
                           max_steps=1)
    assert not part.complete and part.steps == 1
    assert part.explored_tree < NQ[10][0]


def test_interval_zero_saves_after_every_dispatch(tmp_path, monkeypatch):
    saves = []
    real = ckpt.save
    monkeypatch.setattr(ckpt, "save",
                        lambda *a, **k: (saves.append(a[4]), real(*a, **k)))
    path = tmp_path / "every.npz"
    res = resident_search(NQueensProblem(10), m=8, M=64, K=2, device="cpu",
                          checkpoint_path=str(path), checkpoint_interval_s=0)
    assert res.complete and (res.explored_tree, res.explored_sol) == NQ[10]
    # One save a consumed dispatch but the last (which ends the search).
    assert len(saves) == res.steps > 5
    # The last file resumes to the goldens.
    done = resident_search(NQueensProblem(10), m=8, M=64, K=2, device="cpu",
                           resume_from=str(path))
    assert (done.explored_tree, done.explored_sol) == NQ[10]


# -- across packages -----------------------------------------------------------------


def _jax_and_port(case):
    if case == "nqueens11":
        return JaxNQueens(11), NQueensProblem(11), None, NQ[11]
    return (JaxPFSP(lb="lb1", ub=0, p_times=PTM), _pfsp(), PFSP_OPT,
            PFSP_SEQ[:2])


@pytest.mark.parametrize("case", ["nqueens11", "pfsp_lb1_ub0"])
def test_a_jax_cut_resumes_in_the_port(tmp_path, case):
    jax_prob, prob, best, golden = _jax_and_port(case)
    path = str(tmp_path / "jax.npz")
    part = jax_resident_search(jax_prob, m=8, M=64, K=2, initial_best=best,
                               max_steps=2, checkpoint_path=path)
    assert not part.complete
    done = resident_search(prob, m=8, M=64, K=2, device="cpu",
                           resume_from=path)
    assert done.complete and (done.explored_tree, done.explored_sol) == golden
    if best is not None:
        assert done.best == best


@pytest.mark.parametrize("case", ["nqueens11", "pfsp_lb1_ub0"])
def test_a_port_cut_resumes_in_jax(tmp_path, case):
    jax_prob, prob, best, golden = _jax_and_port(case)
    path = str(tmp_path / "port.npz")
    part = _cut(path, prob, initial_best=best)
    assert part.explored_tree < golden[0]
    done = jax_resident_search(jax_prob, m=8, M=64, K=2, resume_from=path)
    assert done.complete and (done.explored_tree, done.explored_sol) == golden


# -- the CLI ---------------------------------------------------------------------------


def test_cli_cut_and_resume(tmp_path, capsys):
    path = str(tmp_path / "cli.npz")
    base = ["nqueens", "--N", "10", "--device", "cpu", "--M", "64", "--K", "2",
            "--json"]
    assert cli.main(base + ["--max-steps", "2", "--checkpoint", path]) == 0
    out = capsys.readouterr().out
    assert "Exploration interrupted (checkpointed; resume with --resume)." in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["complete"] is False and rec["steps"] == 2
    assert rec["explored_tree"] < NQ[10][0] and len(rec["phases"]) == 2
    assert cli.main(base + ["--resume", path]) == 0
    out = capsys.readouterr().out
    assert "Exploration terminated." in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == NQ[10]
    assert "complete" not in rec and rec["engine"] == "resident"
    assert cli.main(base[:-1] + ["--max-steps", "1"]) == 0
    assert "Exploration interrupted (no checkpoint written)." in \
        capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--tier", "seq", "--checkpoint", "f.npz"],
    ["--tier", "seq", "--resume", "f.npz"],
    ["--tier", "seq", "--max-steps", "2"],
    ["--tier", "seq", "--K", "4"],
    ["--tier", "seq", "--mt", "8"],
    ["--tier", "seq", "--engine", "offload"],
    ["--tier", "seq", "--device", "cpu"],
    ["--engine", "offload", "--device", "cpu", "--checkpoint", "f.npz"],
    ["--engine", "offload", "--device", "cpu", "--resume", "f.npz"],
    ["--engine", "offload", "--device", "cpu", "--max-steps", "2"],
    ["--engine", "offload", "--device", "cpu", "--K", "4"],
    ["--engine", "offload", "--device", "cpu", "--unfused"],
    ["--device", "cpu", "--max-steps", "0"],
    ["--device", "cpu", "--checkpoint-interval", "-1"],
    ["--device", "cpu", "--resume", "no-such-file.npz"],
])
def test_cli_refusals_exit_2(argv, capsys):
    rc = cli.main(["nqueens", "--N", "8", *argv])
    cap = capsys.readouterr()
    assert rc == 2
    assert cap.err.startswith("Error: ") and "Traceback" not in cap.err
    assert cap.out == ""


def test_cli_refuses_a_resume_file_of_another_problem(tmp_path, capsys):
    path = str(tmp_path / "n9.npz")
    ckpt.save(path, NQueensProblem(9), NQueensProblem(9).root(), best=10**9,
              tree=0, sol=0)
    assert cli.main(["nqueens", "--N", "10", "--device", "cpu", "--resume",
                     path]) == 2
    cap = capsys.readouterr()
    assert cap.err.startswith("Error: checkpoint is for") and cap.out == ""
