"""The port's native host runtime (`tpu_tree_search_torch/native/`, its own
copy of the C++ runtime) against the port's Python path and against the JAX
package's native and Python paths, on the CPU.

  * sequential counts: N-Queens N = 4-10, reduced PFSP under lb1, lb1_d and
    lb2 with ub=0 (an improving incumbent: any traversal-order difference
    changes the tree) and with a fixed incumbent;
  * warm-up frontiers, bit for bit, and drain counts;
  * ``generate_children`` on seeded bound and label planes;
  * shapes past the JAX package's tests, at the C level only: 40 queens (the
    per-slot check past the 32-queen masks) and ta111's 500 jobs (int16
    rows, widened to int32 at the boundary);
  * a failed build raises with the compiler's output; ``TTS_NATIVE=0``
    takes the Python path.

Tolerance: exact equality (integer counts, node values).
"""

from __future__ import annotations

import numpy as np
import pytest

from tpu_tree_search import native as jax_native
from tpu_tree_search.engine.device import drain as jax_drain
from tpu_tree_search.engine.device import warmup as jax_warmup
from tpu_tree_search.engine.sequential import sequential_search as jax_sequential
from tpu_tree_search.pool import SoAPool as JaxPool
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.base import index_batch as jax_index
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch import native
from tpu_tree_search_torch.engine.device import drain, warmup
from tpu_tree_search_torch.engine.sequential import sequential_search
from tpu_tree_search_torch.pool import SoAPool
from tpu_tree_search_torch.problems import INF_BOUND, NQueensProblem, PFSPProblem
from tpu_tree_search_torch.problems.base import index_batch

NQ_SOLUTIONS = {4: 2, 5: 10, 6: 4, 7: 40, 8: 92, 9: 352, 10: 724}


def _python_only(problem):
    """The same problem with its native runtime off (either package)."""
    problem._native_rt = None
    return problem


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


def _jax_native_or_skip():
    if jax_native.load() is None:
        pytest.skip(f"JAX package's native library: {jax_native.load_error()}")


def _pools(problems):
    """A pool of each problem's root (the JAX pool for a JAX problem)."""
    out = []
    for p in problems:
        if isinstance(p, (JaxNQueens, JaxPFSP)):
            pool = JaxPool(p.node_fields())
            pool.push_back(jax_index(p.root(), 0))
        else:
            pool = SoAPool(p.node_fields())
            pool.push_back(index_batch(p.root(), 0))
        out.append(pool)
    return out


def _same_batches(batches, fields):
    for b in batches[1:]:
        for f in fields:
            np.testing.assert_array_equal(b[f].astype(np.int64),
                                          batches[0][f].astype(np.int64))


# -- the sequential tier --------------------------------------------------------


@pytest.mark.parametrize("N", sorted(NQ_SOLUTIONS))
def test_nqueens_sequential_counts_match_python_and_jax(N):
    _jax_native_or_skip()
    got = [_counts(sequential_search(NQueensProblem(N))),
           _counts(sequential_search(_python_only(NQueensProblem(N)))),
           _counts(jax_sequential(JaxNQueens(N))),
           _counts(jax_sequential(_python_only(JaxNQueens(N))))]
    assert got == [got[0]] * 4
    assert got[0][1] == NQ_SOLUTIONS[N]


@pytest.mark.parametrize("lb", ["lb1", "lb1_d", "lb2"])
@pytest.mark.parametrize("incumbent", ["ub0", "fixed"])
def test_pfsp_sequential_counts_match_python_and_jax(lb, incumbent):
    _jax_native_or_skip()
    ptm = taillard.reduced_instance(14, jobs=7, machines=5)
    best = None if incumbent == "ub0" else 1_000_000
    got = [_counts(sequential_search(PFSPProblem(lb=lb, ub=0, p_times=ptm),
                                     initial_best=best)),
           _counts(sequential_search(
               _python_only(PFSPProblem(lb=lb, ub=0, p_times=ptm)),
               initial_best=best)),
           _counts(jax_sequential(JaxPFSP(lb=lb, ub=0, p_times=ptm),
                                  initial_best=best)),
           _counts(jax_sequential(
               _python_only(JaxPFSP(lb=lb, ub=0, p_times=ptm)),
               initial_best=best))]
    assert got == [got[0]] * 4


# -- the host phases ------------------------------------------------------------


def test_nqueens_warmup_frontier_and_drain_match_python_and_jax():
    _jax_native_or_skip()
    probs = [NQueensProblem(9), _python_only(NQueensProblem(9)), JaxNQueens(9),
             _python_only(JaxNQueens(9))]
    pools = _pools(probs)
    outs = [(warmup if isinstance(p, NQueensProblem) else jax_warmup)(
        p, pool, INF_BOUND, 50) for p, pool in zip(probs, pools)]
    assert outs == [outs[0]] * 4
    assert len({pool.size for pool in pools}) == 1 and pools[0].size >= 50
    _same_batches([pool.as_batch() for pool in pools], ("depth", "board"))
    drained = [(drain if isinstance(p, NQueensProblem) else jax_drain)(
        p, pool, INF_BOUND) for p, pool in zip(probs, pools)]
    assert drained == [drained[0]] * 4
    assert all(pool.size == 0 for pool in pools)


@pytest.mark.parametrize("lb", ["lb1", "lb1_d", "lb2"])
def test_pfsp_warmup_frontier_and_drain_match_python_and_jax(lb):
    _jax_native_or_skip()
    ptm = taillard.reduced_instance(3, jobs=8, machines=5)
    probs = [PFSPProblem(lb=lb, ub=0, p_times=ptm),
             _python_only(PFSPProblem(lb=lb, ub=0, p_times=ptm)),
             JaxPFSP(lb=lb, ub=0, p_times=ptm),
             _python_only(JaxPFSP(lb=lb, ub=0, p_times=ptm))]
    pools = _pools(probs)
    outs = [(warmup if isinstance(p, PFSPProblem) else jax_warmup)(
        p, pool, INF_BOUND, 60) for p, pool in zip(probs, pools)]
    assert outs == [outs[0]] * 4
    _same_batches([pool.as_batch() for pool in pools],
                  ("depth", "limit1", "prmu"))
    drained = [(drain if isinstance(p, PFSPProblem) else jax_drain)(
        p, pool, outs[0][2]) for p, pool in zip(probs, pools)]
    assert drained == [drained[0]] * 4


# -- generate_children -----------------------------------------------------------


def _random_pfsp_parents(rng, jobs, count, dtype=np.int32):
    prmu = np.tile(np.arange(jobs, dtype=np.int32), (count, 1))
    for row in prmu:
        rng.shuffle(row)
    limit1 = rng.integers(-1, jobs - 1, size=count).astype(np.int32)
    return {"depth": (limit1 + 1).astype(np.int16), "limit1": limit1.astype(np.int16),
            "prmu": prmu.astype(dtype)}


def _random_boards(rng, N, count):
    board = np.tile(np.arange(N, dtype=np.uint8), (count, 1))
    for row in board:
        rng.shuffle(row)
    return {"depth": rng.integers(0, N + 1, size=count).astype(np.int16),
            "board": board}


def _generate(problems, parents, count, plane, best):
    out = []
    for p in problems:
        r = p.generate_children(parents, count, plane, best)
        out.append(((r.tree_inc, r.sol_inc, r.best), r.children))
    assert [o[0] for o in out] == [out[0][0]] * len(out)
    _same_batches([o[1] for o in out], list(out[0][1]))
    return out[0][0]


def test_pfsp_generate_children_matches_python_and_jax():
    _jax_native_or_skip()
    rng = np.random.default_rng(7)
    jobs = 9
    ptm = taillard.reduced_instance(2, jobs=jobs, machines=4)
    probs = [PFSPProblem(lb="lb1", ub=0, p_times=ptm),
             _python_only(PFSPProblem(lb="lb1", ub=0, p_times=ptm)),
             JaxPFSP(lb="lb1", ub=0, p_times=ptm)]
    leaves = 0
    for _ in range(20):
        count = int(rng.integers(1, 40))
        parents = _random_pfsp_parents(rng, jobs, count, np.int8)
        bounds = rng.integers(0, 2000, size=(count, jobs)).astype(np.int32)
        leaves += _generate(probs, parents, count, bounds,
                            int(rng.integers(500, 1500)))[1]
    assert leaves > 0  # some chunks held leaf parents


def test_nqueens_generate_children_matches_python_and_jax():
    _jax_native_or_skip()
    rng = np.random.default_rng(11)
    probs = [NQueensProblem(10), _python_only(NQueensProblem(10)),
             JaxNQueens(10)]
    for _ in range(10):
        count = int(rng.integers(1, 60))
        labels = rng.integers(0, 2, size=(count, 10)).astype(np.uint8)
        _generate(probs, _random_boards(rng, 10, count), count, labels,
                  INF_BOUND)


# -- shapes past 32 queens and past 100 jobs, at the C level ---------------------


def test_nqueens_past_32_queens_matches_python():
    # 40 queens: the C runtime's diagonal masks hold 32 queens; past that it
    # runs the per-slot check. Warm-up frontier and generate_children.
    nat, py = NQueensProblem(40), _python_only(NQueensProblem(40))
    pools = _pools([nat, py])
    outs = [warmup(p, pool, INF_BOUND, 400) for p, pool in zip([nat, py], pools)]
    assert outs[0] == outs[1] and pools[0].size >= 400
    _same_batches([pool.as_batch() for pool in pools], ("depth", "board"))
    rng = np.random.default_rng(40)
    labels = rng.integers(0, 2, size=(64, 40)).astype(np.uint8)
    _generate([nat, py], _random_boards(rng, 40, 64), 64, labels, INF_BOUND)


def test_pfsp_past_100_jobs_matches_python():
    # ta111: 500 jobs, int16 rows in the pool, int32 across the boundary.
    nat, py = PFSPProblem(inst=111, lb="lb1"), _python_only(
        PFSPProblem(inst=111, lb="lb1"))
    assert nat.node_fields()["prmu"][1] == np.int16
    pools = _pools([nat, py])
    outs = [warmup(p, pool, nat.initial_ub, 600)
            for p, pool in zip([nat, py], pools)]
    assert outs[0] == outs[1] and pools[0].size >= 600
    _same_batches([pool.as_batch() for pool in pools],
                  ("depth", "limit1", "prmu"))
    rng = np.random.default_rng(111)
    parents = _random_pfsp_parents(rng, 500, 16, np.int16)
    bounds = rng.integers(5000, 9000, size=(16, 500)).astype(np.int32)
    _generate([nat, py], parents, 16, bounds, 7000)


# -- the build --------------------------------------------------------------------


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'the compiler refuses this source' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="the compiler refuses this source"):
        native.build()
    # Not loaded yet in this process: load() builds, and raises the same.
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.load()
    with pytest.raises(RuntimeError, match="native build failed"):
        NQueensProblem(6)._native()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build()


def test_tts_native_0_takes_the_python_path(monkeypatch):
    monkeypatch.setenv("TTS_NATIVE", "0")
    assert not native.enabled() and native.load() is None
    prob = NQueensProblem(7)
    assert prob._native() is None and prob.native_sequential(INF_BOUND) is None
    assert _counts(sequential_search(prob))[:2] == (551, 40)
    monkeypatch.delenv("TTS_NATIVE")
    assert native.enabled() and NQueensProblem(7)._native() is not None
