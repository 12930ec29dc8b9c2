"""The port's chunked-offload tier (``device_search(device="cpu")``,
`tpu_tree_search_torch/engine/device.py`) against the JAX ``device_search``
on CPU JAX.

  * N-Queens N = 8-10, and a reduced ta014 corner under lb1, lb1_d and lb2
    (staged, the default, and single-pass), each with ub=0 (an improving
    incumbent, where the pop/dispatch/consume order decides the tree) and
    with the optimum as a fixed incumbent, with ``overlap`` on and off:
    tree, sol, best and the diagnostics (evaluations, H2D, D2H,
    double-buffered dispatches) identical;
  * the staged lb2 evaluator's plane against the single-pass one on the
    slots the host reads;
  * with no device given, ``device_search`` raises on a machine without
    CUDA.

Tolerance: exact equality.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tpu_tree_search.engine.device import device_search as jax_device_search
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.engine.device import DeviceOffloader, device_search
from tpu_tree_search_torch.problems import INF_BOUND, NQueensProblem, PFSPProblem

PTM = taillard.reduced_instance(14, jobs=10, machines=5)
OPT = 609  # the reduced corner's optimum (tests/test_torch_resident.py)
m, M = 8, 64


def _outcome(res):
    d = res.diagnostics
    return (res.explored_tree, res.explored_sol, res.best, d.kernel_launches,
            d.host_to_device, d.device_to_host, d.double_buffered)


@functools.lru_cache(maxsize=None)
def jax_offload(problem: str, lb: str, incumbent: str, overlap: bool):
    """The JAX ``device_search`` outcome, once a configuration."""
    if problem == "nqueens":
        prob = JaxNQueens(int(lb))
    else:
        prob = JaxPFSP(lb=lb, ub=0, p_times=PTM)
    best = OPT if incumbent == "fixed" else None
    return _outcome(jax_device_search(prob, m=m, M=M, initial_best=best,
                                      overlap=overlap))


@pytest.mark.parametrize("N", [8, 9, 10])
@pytest.mark.parametrize("overlap", [True, False])
def test_nqueens_matches_jax_device_search(N, overlap):
    res = device_search(NQueensProblem(N), m=m, M=M, device="cpu",
                        overlap=overlap)
    assert _outcome(res) == jax_offload("nqueens", str(N), "none", overlap)
    assert res.engine == "offload" and len(res.phases) == 3


@pytest.mark.parametrize("lb,staged", [("lb1", True), ("lb1_d", True),
                                       ("lb2", True), ("lb2", False)])
@pytest.mark.parametrize("incumbent", ["ub0", "fixed"])
@pytest.mark.parametrize("overlap", [True, False])
def test_pfsp_matches_jax_device_search(lb, staged, incumbent, overlap):
    res = device_search(PFSPProblem(lb=lb, ub=0, p_times=PTM), m=m, M=M,
                        device="cpu", overlap=overlap, staged=staged,
                        initial_best=OPT if incumbent == "fixed" else None)
    assert _outcome(res) == jax_offload("pfsp", lb, incumbent, overlap)
    assert res.staged == (lb == "lb2" and staged)
    if overlap:
        assert res.diagnostics.double_buffered > 0


@pytest.mark.parametrize("best", [INF_BOUND, OPT, 640])
def test_staged_lb2_plane_prunes_as_the_single_pass_plane(best):
    # Slots the host reads: the open ones. Where the staged plane reports
    # lb1 (not a candidate) the value is at or above the folded incumbent,
    # so the host prunes it as it prunes the single-pass lb2 value.
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    prob = PFSPProblem(lb="lb2", ub=0, p_times=PTM)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    warmup(prob, pool, INF_BOUND, 300)
    chunk = pool.as_batch()
    count = chunk["prmu"].shape[0]
    planes = {}
    for staged in (True, False):
        off = DeviceOffloader(prob, torch.device("cpu"), staged=staged)
        _, planes[staged] = off.evaluate(chunk, count, best)
    limit1 = chunk["limit1"].astype(np.int64)
    open_ = np.arange(PTM.shape[1])[None, :] > limit1[:, None]
    a, b = planes[True][open_], planes[False][open_]
    assert np.array_equal(a < best, b < best)
    assert np.all(a <= b)  # lb1 <= lb2 where the stage stopped at lb1
    assert np.array_equal(a[b < best], b[b < best])


def test_device_search_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_search(NQueensProblem(6), m=m, M=M)
