"""The sequential tier — the correctness anchor (the port of
`tpu_tree_search/engine/sequential.py`).

Exact semantics of the reference's sequential tiers
(`nqueens_chpl.chpl:92-113`, `pfsp_chpl.chpl:191-215`): a single deque,
pop-back DFS, host decompose. Every other tier reproduces this tier's
exploredTree/exploredSol (and optimum, for PFSP with ub=1). It runs on the
host only: the whole search in one call of the native runtime, or the
Python pop-back DFS under ``TTS_NATIVE=0``. Telemetry: one ``explored``
sample (phase 1) and one flight-recorder heartbeat at the end, as the JAX
tier (`tpu_tree_search/engine/sequential.py:30,57`).
"""

from __future__ import annotations

import time

from ..obs import events as ev
from ..obs import flightrec as fr
from ..pool.pool import SoAPool
from ..problems.base import INF_BOUND, Problem, batch_length, index_batch
from .results import PhaseStats, SearchResult


def sequential_search(problem: Problem,
                      initial_best: int | None = None) -> SearchResult:
    best = (initial_best if initial_best is not None
            else getattr(problem, "initial_ub", INF_BOUND))
    problem._native()  # a first call builds it: outside the timed phases
    fr.arm("seq")
    t0 = time.perf_counter()
    native = problem.native_sequential(best)
    if native is not None:
        tree, sol, best = native
    else:
        pool = SoAPool(problem.node_fields())
        pool.push_back(index_batch(problem.root(), 0))
        tree = sol = 0
        while True:
            node = pool.pop_back()
            if node is None:
                break
            res = problem.decompose(node, best)
            tree += res.tree_inc
            sol += res.sol_inc
            best = res.best
            for i in range(batch_length(res.children)):
                pool.push_back(index_batch(res.children, i))
    elapsed = time.perf_counter() - t0
    ev.counter("explored", tree=tree, sol=sol, phase=1)
    fr.heartbeat("seq", seq=1, best=best, tree=tree, sol=sol)
    return SearchResult(explored_tree=tree, explored_sol=sol, best=best,
                        elapsed=elapsed, phases=[PhaseStats(elapsed, tree, sol)])
