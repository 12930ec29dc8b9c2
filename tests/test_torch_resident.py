"""The port's device-resident engine against the JAX engines.

On reduced instances (ta014's 10-job, 5-machine corner), run on the CPU
through the plain versions of the kernels:

  * with a fixed incumbent (the optimum) the port's ``resident_search`` —
    fused and unfused — explores exactly the tree of the JAX
    ``sequential_search`` (the `tests/test_resident.py` pattern);
  * with ub=0 (an improving incumbent) it explores exactly the tree of the
    JAX ``resident_search`` at the same m, M and K;
  * from one frontier (``pool_from_numpy``), one dispatch of K cycles leaves
    the same live pool rows, size, best, tree and sol as one step of the JAX
    resident program;
  * a frontier past the fan-out headroom takes the capacity-stall fallback
    and still matches.

The same holds for PFSP lb1_d (against the JAX sequential tier under lb1_d;
it always runs the unfused cycle), for PFSP lb2 in its three forms (fused,
staged unfused, single-pass unfused; the sequential tier under each pair
variant, the JAX resident engine and its one-dispatch step) and for N-Queens (the goldens for N=8 and
10, the JAX resident engine at the same m, M and K, one dispatch against the
JAX N-Queens program's step, and the stall fallback).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_tree_search.engine.resident import _make_program
from tpu_tree_search.engine.resident import resident_search as jax_resident_search
from tpu_tree_search.engine.sequential import sequential_search
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.engine import resident as resident_mod
from tpu_tree_search_torch.engine.device import warmup
from tpu_tree_search_torch.engine.resident import (
    NQueensResident,
    PFSPResident,
    make_program,
    pool_from_numpy,
    resident_search,
)
from tpu_tree_search_torch.ops import lb2_kernel
from tpu_tree_search_torch.pool import SoAPool
from tpu_tree_search_torch.problems import INF_BOUND, NQueensProblem
from tpu_tree_search_torch.problems import PFSPProblem as TorchPFSP
from tpu_tree_search_torch.problems.base import index_batch

PTM = taillard.reduced_instance(14, jobs=10, machines=5)


@pytest.fixture(scope="module")
def seq_fixed():
    """(optimum, sequential result under the fixed optimal incumbent)."""
    opt = sequential_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM)).best
    seq = sequential_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM),
                            initial_best=opt)
    return opt, seq


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


@pytest.mark.parametrize("fused", [True, False])
def test_fixed_incumbent_matches_sequential(seq_fixed, fused):
    opt, seq = seq_fixed
    res = resident_search(TorchPFSP(lb="lb1", ub=0, p_times=PTM), m=8, M=256,
                          K=64, initial_best=opt, device="cpu", fused=fused)
    assert _counts(res) == _counts(seq)
    assert res.best == opt and res.fused is fused
    # The counts tests/test_torch_cuda.py pins for the same search on a card.
    assert _counts(seq) == (2074, 90, 609)


@pytest.mark.parametrize("fused", [True, False])
def test_improving_incumbent_matches_jax_resident(fused):
    want = jax_resident_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM),
                               m=8, M=64, K=16)
    res = resident_search(TorchPFSP(lb="lb1", ub=0, p_times=PTM), m=8, M=64,
                          K=16, device="cpu", fused=fused)
    assert _counts(res) == _counts(want)


def _frontier(target):
    prob = TorchPFSP(lb="lb1", ub=0, p_times=PTM)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    warmup(prob, pool, INF_BOUND, target)
    return pool.as_batch()


@pytest.mark.parametrize("cycle", ["fused", "dense", "scatter"])
@pytest.mark.parametrize("incumbent", ["inf", "opt"])
def test_one_dispatch_matches_jax_step(seq_fixed, cycle, incumbent):
    best = INF_BOUND if incumbent == "inf" else seq_fixed[0]
    m, M, K, capacity = 8, 64, 6, 4096
    fr = _frontier(200)
    k = fr["prmu"].shape[0]
    jprog = _make_program(PFSPProblem(lb="lb1", ub=0, p_times=PTM), m, M, K,
                          capacity, None)
    out = jprog.step(jprog.init_state(fr, best))
    j_vals, j_aux, j_size, j_best = (np.asarray(x) for x in out[:4])
    j_tree, j_sol, j_cycles = (int(x) for x in out[4:7])

    prog = PFSPResident(TorchPFSP(lb="lb1", ub=0, p_times=PTM), m, M, K,
                        capacity, "cpu", fused=cycle == "fused")
    if cycle != "fused":
        prog.compact = cycle  # the unfused cycle's compaction mode
    state = pool_from_numpy(fr["prmu"], fr["limit1"], k, best, capacity, "cpu")
    prog.step(state)
    tree, sol, cycles, size, best_t = prog.read_scalars(state)
    assert (tree, sol, cycles, size, best_t) == (
        j_tree, j_sol, j_cycles, int(j_size), int(j_best))
    assert cycles == K  # the frontier outlives the dispatch
    live = int(j_size)
    assert np.array_equal(state.pool_vals[:live].numpy().astype(np.int32),
                          j_vals[:live].astype(np.int32))
    assert np.array_equal(state.pool_aux[:live].numpy().astype(np.int32),
                          j_aux[:live].astype(np.int32))


@pytest.mark.parametrize("fused", [True, False])
def test_capacity_stall_fallback_keeps_counts(seq_fixed, fused):
    opt, seq = seq_fixed
    # A 400-node warm frontier plus one M*n = 320 fan-out exceeds the
    # 700-row pool.
    res = resident_search(TorchPFSP(lb="lb1", ub=0, p_times=PTM), m=8, M=32,
                          K=16, capacity=700, warmup_target=400,
                          initial_best=opt, device="cpu", fused=fused)
    assert res.stall_fallbacks >= 1
    assert res.diagnostics.host_to_device > 1
    assert _counts(res) == _counts(seq)


@pytest.mark.parametrize("mode", ["dense", "scatter"])
def test_unfused_overflow_branch_matches_jax_resident(monkeypatch, mode):
    # Under ub=inf a 300-node warm frontier keeps more than the survivor
    # budget S = 64*n of a 128-parent chunk, which takes the overflow push.
    # The branch is chosen on the device: the counter block counts it.
    calls = []
    compact = resident_mod.compact_ids

    def spy(keep, S, m):
        calls.append(m)
        return compact(keep, S, m)

    monkeypatch.setattr(resident_mod, "compact_ids", spy)
    monkeypatch.setattr(resident_mod, "resolve_compact_mode",
                        lambda problem, M, n: mode)
    want = jax_resident_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM), m=8,
                               M=128, K=16, warmup_target=300)
    monkeypatch.setenv("TTS_OBS", "1")
    res = resident_search(TorchPFSP(lb="lb1", ub=0, p_times=PTM), m=8, M=128,
                          K=16, warmup_target=300, device="cpu", fused=False)
    assert calls and set(calls) == {mode}
    assert res.obs["device_counters"]["overflow"] > 0
    assert _counts(res) == _counts(want)


def test_unported_bounds_raise():
    # Every bound runs on the device tier now. The lb2 kernels take 101 jobs
    # (once refused); what they do not take (more than MAX_JOBS
    # jobs) is refused, naming ROADMAP.md, never handed to the plain
    # version.
    rng = np.random.default_rng(0)
    for n, taken in ((101, True), (lb2_kernel.MAX_JOBS + 1, False)):
        ptm = rng.integers(1, 100, (2, n))
        prog = PFSPResident(TorchPFSP(lb="lb2", ub=0, p_times=ptm), 8, 64, 4,
                            1 << 16, "cpu")
        for source in ("lb2_bounds", "lb2_self_bounds", "cycle_lb2"):
            if taken:
                assert lb2_kernel.johnson_operands(source, prog.tables).route == 0
                continue
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                lb2_kernel.johnson_operands(source, prog.tables)


# -- PFSP lb2 ------------------------------------------------------------------

# The three lb2 forms of the resident engine: the fused cycle, the staged
# unfused evaluator (the default unfused one) and the single-pass one.
LB2_FORMS = {"fused": dict(fused=True), "staged": dict(fused=False),
             "unstaged": dict(fused=False, staged=False)}


def test_lb2_runs_fused_by_default_and_staged_unfused():
    prob = TorchPFSP(lb="lb2", ub=0, p_times=PTM)
    fused = PFSPResident(prob, 8, 64, 4, 4096, "cpu")
    assert fused.fused and not fused.staged
    assert fused.tables.johnson is not None
    unfused = PFSPResident(prob, 8, 64, 4, 4096, "cpu", fused=False)
    assert not unfused.fused and unfused.staged
    single = make_program(prob, 8, 64, 4, 4096, "cpu", fused=False, staged=False)
    assert not single.fused and not single.staged
    # staged only concerns the unfused lb2 cycle.
    lb1 = PFSPResident(TorchPFSP(lb="lb1", ub=0, p_times=PTM), 8, 64, 4, 4096,
                       "cpu", fused=False)
    assert not lb1.staged


@pytest.fixture(scope="module")
def seq_lb2(seq_fixed):
    """The JAX sequential tier under lb2 and the fixed optimal incumbent."""
    return sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM),
                             initial_best=seq_fixed[0])


@pytest.mark.parametrize("form", LB2_FORMS)
def test_lb2_fixed_incumbent_matches_sequential(seq_fixed, seq_lb2, form):
    res = resident_search(TorchPFSP(lb="lb2", ub=0, p_times=PTM), m=8, M=256,
                          K=64, initial_best=seq_fixed[0], device="cpu",
                          **LB2_FORMS[form])
    assert _counts(res) == _counts(seq_lb2)
    assert (res.fused, res.staged) == (form == "fused", form == "staged")
    # lb2 prunes more than lb1; tests/test_torch_cuda.py pins these counts
    # for the same search on a card.
    assert _counts(seq_lb2) == (326, 0, 609)


@pytest.fixture(scope="module")
def jax_lb2_resident():
    return jax_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM),
                               m=8, M=64, K=16)


@pytest.mark.parametrize("form", LB2_FORMS)
def test_lb2_improving_incumbent_matches_jax_resident(seq_fixed, jax_lb2_resident,
                                                      form):
    res = resident_search(TorchPFSP(lb="lb2", ub=0, p_times=PTM), m=8, M=64,
                          K=16, device="cpu", **LB2_FORMS[form])
    assert _counts(res) == _counts(jax_lb2_resident)
    assert res.best == seq_fixed[0]


@pytest.mark.parametrize("variant", ["nabeshima", "lageweg"])
def test_lb2_variants_match_sequential(seq_fixed, variant):
    opt = seq_fixed[0]
    seq = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM,
                                        lb2_variant=variant), initial_best=opt)
    for form in ("fused", "staged"):
        res = resident_search(TorchPFSP(lb="lb2", ub=0, p_times=PTM,
                                        lb2_variant=variant),
                              m=8, M=256, K=64, initial_best=opt, device="cpu",
                              **LB2_FORMS[form])
        assert _counts(res) == _counts(seq)
    if variant == "nabeshima":  # pinned by tests/test_torch_package.py's CLI run
        assert _counts(seq) == (1294, 0, 609)


@pytest.mark.parametrize("form", ["fused", "staged"])
def test_lb2_one_dispatch_matches_jax_step(seq_fixed, form):
    m, M, K, capacity = 8, 64, 6, 4096
    fr = _frontier(200)
    k = fr["prmu"].shape[0]
    jprog = _make_program(PFSPProblem(lb="lb2", ub=0, p_times=PTM), m, M, K,
                          capacity, None)
    out = jprog.step(jprog.init_state(fr, seq_fixed[0]))
    j_vals, j_aux, j_size, j_best = (np.asarray(x) for x in out[:4])
    j_tree, j_sol, j_cycles = (int(x) for x in out[4:7])
    prog = PFSPResident(TorchPFSP(lb="lb2", ub=0, p_times=PTM), m, M, K,
                        capacity, "cpu", **LB2_FORMS[form])
    state = pool_from_numpy(fr["prmu"], fr["limit1"], k, seq_fixed[0], capacity,
                            "cpu")
    prog.step(state)
    assert prog.read_scalars(state) == (j_tree, j_sol, j_cycles, int(j_size),
                                        int(j_best))
    live = int(j_size)
    assert live > 0
    assert np.array_equal(state.pool_vals[:live].numpy().astype(np.int32),
                          j_vals[:live].astype(np.int32))
    assert np.array_equal(state.pool_aux[:live].numpy().astype(np.int32),
                          j_aux[:live].astype(np.int32))


@pytest.mark.parametrize("form", LB2_FORMS)
def test_lb2_capacity_stall_fallback_keeps_counts(form):
    # lb2 prunes the 10-job corner to 326 nodes, too few to fill a pool, so
    # this runs the 12-job corner: a 400-node warm frontier plus one
    # M*n = 384 fan-out exceeds the 828-row pool.
    ptm = taillard.reduced_instance(14, jobs=12, machines=5)
    opt = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=ptm)).best
    seq = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=ptm),
                            initial_best=opt)
    res = resident_search(TorchPFSP(lb="lb2", ub=0, p_times=ptm), m=8, M=32,
                          K=16, capacity=828, warmup_target=400,
                          initial_best=opt, device="cpu", **LB2_FORMS[form])
    assert res.stall_fallbacks >= 1
    assert res.diagnostics.host_to_device > 1
    assert _counts(res) == _counts(seq)
    assert _counts(seq) == (12838, 0, 699)


# -- PFSP lb1_d ----------------------------------------------------------------


@pytest.fixture(scope="module")
def seq_lb1_d(seq_fixed):
    """The JAX sequential tier under lb1_d and the fixed optimal incumbent."""
    return sequential_search(PFSPProblem(lb="lb1_d", ub=0, p_times=PTM),
                             initial_best=seq_fixed[0])


@pytest.mark.parametrize("fused", [True, False])
def test_lb1_d_matches_sequential_and_runs_unfused(seq_fixed, seq_lb1_d, fused):
    opt, _ = seq_fixed
    res = resident_search(TorchPFSP(lb="lb1_d", ub=0, p_times=PTM), m=8, M=256,
                          K=64, initial_best=opt, device="cpu", fused=fused)
    assert _counts(res) == _counts(seq_lb1_d)
    # lb1_d has no fused cycle (neither has the JAX megakernel), and its
    # bound equals lb1's on every open slot, so its tree is lb1's.
    assert res.fused is False and res.compact == "dense"
    assert _counts(seq_lb1_d) == (2074, 90, 609)


def test_lb1_d_capacity_stall_fallback_keeps_counts(seq_fixed, seq_lb1_d):
    res = resident_search(TorchPFSP(lb="lb1_d", ub=0, p_times=PTM), m=8, M=32,
                          K=16, capacity=700, warmup_target=400,
                          initial_best=seq_fixed[0], device="cpu")
    assert res.stall_fallbacks >= 1
    assert _counts(res) == _counts(seq_lb1_d)


# -- N-Queens ------------------------------------------------------------------

NQ_GOLDEN = {8: (2056, 92), 10: (35538, 724)}


def _nq_counts(res):
    return res.explored_tree, res.explored_sol


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("N", [8, 10])
def test_nqueens_matches_goldens(N, fused):
    res = resident_search(NQueensProblem(N), m=8, M=64, K=16, device="cpu",
                          fused=fused)
    assert _nq_counts(res) == NQ_GOLDEN[N]
    assert res.fused is fused
    assert res.compact == (None if fused else "dense")
    assert sum(p.tree for p in res.phases) == res.explored_tree


@pytest.fixture(scope="module")
def jax_nqueens_10():
    return jax_resident_search(JaxNQueens(10), m=8, M=64, K=16)


@pytest.mark.parametrize("fused", [True, False])
def test_nqueens_matches_jax_resident(jax_nqueens_10, fused):
    res = resident_search(NQueensProblem(10), m=8, M=64, K=16, device="cpu",
                          fused=fused)
    assert _nq_counts(res) == _nq_counts(jax_nqueens_10)
    assert [(p.tree, p.sol) for p in res.phases] == [
        (p.tree, p.sol) for p in jax_nqueens_10.phases]


def _nq_frontier(N, target):
    prob = NQueensProblem(N)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    warmup(prob, pool, INF_BOUND, target)
    return pool.as_batch()


@pytest.mark.parametrize("cycle", ["fused", "dense"])
def test_nqueens_one_dispatch_matches_jax_step(cycle):
    N, m, M, K, capacity = 8, 8, 64, 10, 4096
    fr = _nq_frontier(N, 120)
    k = fr["board"].shape[0]
    jprog = _make_program(JaxNQueens(N), m, M, K, capacity, None)
    out = jprog.step(jprog.init_state(fr, INF_BOUND))
    j_vals, j_aux, j_size, j_best = (np.asarray(x) for x in out[:4])
    j_tree, j_sol, j_cycles = (int(x) for x in out[4:7])

    prog = NQueensResident(NQueensProblem(N), m, M, K, capacity, "cpu",
                           fused=cycle == "fused")
    state = pool_from_numpy(fr["board"], fr["depth"], k, INF_BOUND, capacity,
                            "cpu", prog.vals_dtype, prog.aux_dtype)
    prog.step(state)
    tree, sol, cycles, size, best = prog.read_scalars(state)
    assert (tree, sol, cycles, size, best) == (
        j_tree, j_sol, j_cycles, int(j_size), int(j_best))
    assert cycles == K and sol > 0  # the frontier outlives the dispatch
    live = int(j_size)
    assert np.array_equal(state.pool_vals[:live].numpy(), j_vals[:live])
    assert np.array_equal(state.pool_aux[:live].numpy().astype(np.int32),
                          j_aux[:live].astype(np.int32))
    batch, rsize, _ = prog.residual(state)
    assert rsize == live and set(batch) == {"board", "depth"}
    assert batch["depth"].dtype == NQueensProblem(N).node_fields()["depth"][1]


@pytest.mark.parametrize("fused", [True, False])
def test_nqueens_capacity_stall_fallback_keeps_counts(fused):
    # A 400-node warm frontier plus one M*N = 320 fan-out exceeds the
    # 700-row pool.
    res = resident_search(NQueensProblem(10), m=8, M=32, K=16, capacity=700,
                          warmup_target=400, device="cpu", fused=fused)
    assert res.stall_fallbacks >= 1
    assert res.diagnostics.host_to_device > 1
    assert _nq_counts(res) == NQ_GOLDEN[10]


def test_make_program_dispatches_on_the_problem():
    # Survivor budgets: half the slot grid for N-Queens, a quarter for PFSP.
    nq = make_program(NQueensProblem(8), 8, 256, 4, 8192, "cpu")
    assert isinstance(nq, NQueensResident)
    assert (nq.vals_dtype, nq.aux_dtype, nq.S) == (torch.uint8, torch.int8, 1024)
    pf = make_program(TorchPFSP(lb="lb1", ub=0, p_times=PTM), 8, 256, 4, 8192, "cpu")
    assert isinstance(pf, PFSPResident) and pf.S == 256 * 10 // 4
    with pytest.raises(TypeError):
        make_program(object(), 8, 64, 4, 4096, "cpu")

