"""The port's sequential tier (`tpu_tree_search_torch/engine/sequential.py`)
against the classical counts, brute force and the JAX package, on the CPU.

  * N-Queens: the classical tree and solution counts, with and without the
    native runtime;
  * reduced PFSP: the optimum equals the brute-force best makespan over
    every permutation, under lb1, lb1_d and lb2, with and without the
    native runtime;
  * one full golden the native runtime runs in seconds: ta014 lb2 ub=1,
    144,639 / 0 / 1377;
  * tree, sol and best equal to the JAX ``sequential_search``.

Tolerance: exact equality.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from tpu_tree_search.engine.sequential import sequential_search as jax_sequential
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.engine import sequential_search
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

# (tree, sol) of the reference's sequential N-Queens (`tests/test_sequential.py`).
NQ_GOLDEN = {6: (152, 4), 8: (2056, 92), 10: (35538, 724), 11: (166925, 2680)}


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


def _python_only(problem):
    problem._native_rt = None
    return problem


def brute_force_makespan(ptm: np.ndarray) -> int:
    """The least makespan over every permutation (the flowshop recurrence)."""
    m, n = ptm.shape
    best = None
    for perm in itertools.permutations(range(n)):
        front = np.zeros(m, dtype=np.int64)
        for job in perm:
            front[0] += ptm[0, job]
            for k in range(1, m):
                front[k] = max(front[k], front[k - 1]) + ptm[k, job]
        best = int(front[-1]) if best is None else min(best, int(front[-1]))
    return best


@pytest.mark.parametrize("N,runtime", [(N, "native") for N in sorted(NQ_GOLDEN)]
                         + [(6, "python"), (8, "python")])
def test_nqueens_classical_counts(N, runtime):
    prob = NQueensProblem(N)
    if runtime == "python":
        _python_only(prob)
    res = sequential_search(prob)
    assert (res.explored_tree, res.explored_sol) == NQ_GOLDEN[N]
    assert len(res.phases) == 1 and res.phases[0].tree == NQ_GOLDEN[N][0]
    assert res.engine is None and res.complete


@pytest.mark.parametrize("lb", ["lb1", "lb1_d", "lb2"])
@pytest.mark.parametrize("runtime", ["native", "python"])
def test_reduced_pfsp_optimum_is_the_brute_force_one(lb, runtime):
    ptm = taillard.reduced_instance(21, jobs=6, machines=4)
    prob = PFSPProblem(lb=lb, ub=0, p_times=ptm)
    if runtime == "python":
        _python_only(prob)
    assert sequential_search(prob).best == brute_force_makespan(ptm)


def test_ta014_lb2_golden_on_the_native_runtime():
    res = sequential_search(PFSPProblem(inst=14, lb="lb2", ub=1))
    assert _counts(res) == (144639, 0, 1377)


@pytest.mark.parametrize("lb,variant", [(None, None), ("lb1", "full"),
                                        ("lb1_d", "full"), ("lb2", "full"),
                                        ("lb2", "nabeshima")])
def test_matches_jax_sequential_search(lb, variant):
    if lb is None:
        ours, theirs = NQueensProblem(9), JaxNQueens(9)
    else:
        ptm = taillard.reduced_instance(14, jobs=8, machines=5)
        ours = PFSPProblem(lb=lb, ub=0, p_times=ptm, lb2_variant=variant)
        theirs = JaxPFSP(lb=lb, ub=0, p_times=ptm, lb2_variant=variant)
    assert _counts(sequential_search(ours)) == _counts(jax_sequential(theirs))
