"""The port's mesh-resident tier (`tpu_tree_search_torch/parallel/resident_mesh.py`,
`ops/mesh.py`) against the JAX package, on the CPU (the plain cycles and
``mesh_balance_plain``; the JAX tier on the suite's eight virtual CPU
devices).

  * N-Queens N=10 equals the sequential tier at D = 8, and the diffusion
    spreads the work (no shard above 80%, `tests/test_resident_mesh.py`);
    at D = 2 and 4 every shard's tree equals the JAX mesh's;
  * reduced PFSP lb1/lb2 at a fixed incumbent equal the sequential tier;
    with an improving incumbent (ub=0) the counts and the optimum equal
    the JAX mesh's (the pmin fold after every round);
  * the saturation fallback keeps the counts; D = 1 equals
    ``resident_search``; the unfused cycles equal the fused ones;
  * one dispatch of the port's ``MeshProgram`` against the JAX
    ``_MeshResidentProgram.step`` on the same stride-partitioned frontier:
    sizes, incumbent, each shard's tree, sol and cycles, and every live row
    of every shard, in order;
  * ``mesh_balance_plain`` against a numpy model of the JAX round (the
    gathered sizes, ``jnp.roll`` and ``dynamic_update_slice``), D = 1, 2
    and 4, a gift of T whose kept rows overlap the rows they move to;
  * a JAX mesh cut resumes on the port's mesh, a port mesh cut on the
    JAX resident engine, to the goldens; a second same-class mesh search
    reuses its cached program;
  * the serve daemon runs a mesh job (N=8, D=2) to its goldens.

Tolerance: exact equality (counts, node values).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_tree_search.engine.resident import resident_search as jax_resident
from tpu_tree_search.engine.sequential import sequential_search as jax_seq
from tpu_tree_search.parallel import resident_mesh as JM
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.engine.sequential import sequential_search
from tpu_tree_search_torch.ops import mesh as MS
from tpu_tree_search_torch.ops.cycle import ST_LEN
from tpu_tree_search_torch.parallel.resident_mesh import (
    get_mesh_program,
    mesh_resident_search,
)
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

PTM = taillard.reduced_instance(14, jobs=10, machines=5)


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


def test_nqueens_parity_and_balance():
    seq = sequential_search(NQueensProblem(10))
    res = mesh_resident_search(NQueensProblem(10), m=8, M=128, K=8, rounds=2,
                               D=8, device="cpu")
    assert _counts(res)[:2] == _counts(seq)[:2] == (35538, 724)
    per = np.asarray(res.per_worker_tree)
    assert per.size == 8 and per.max() < 0.8 * per.sum()
    assert res.engine == "mesh" and res.dispatches > 0


@pytest.mark.parametrize("D", [2, 4])
def test_nqueens_shards_equal_the_jax_mesh(D):
    want = JM.mesh_resident_search(JaxNQueens(10), m=8, M=128, K=8, rounds=2,
                                   D=D)
    res = mesh_resident_search(NQueensProblem(10), m=8, M=128, K=8, rounds=2,
                               D=D, device="cpu")
    assert _counts(res)[:2] == _counts(want)[:2]
    assert res.per_worker_tree == list(want.per_worker_tree)


@pytest.mark.parametrize("lb", ["lb1", "lb2"])
def test_pfsp_fixed_incumbent_parity(lb):
    opt = jax_seq(JaxPFSP(lb=lb, ub=0, p_times=PTM)).best
    seq = sequential_search(PFSPProblem(lb=lb, ub=0, p_times=PTM),
                            initial_best=opt)
    res = mesh_resident_search(PFSPProblem(lb=lb, ub=0, p_times=PTM), m=8,
                               M=128, K=8, D=4, device="cpu",
                               initial_best=opt)
    assert _counts(res) == _counts(seq)


def test_improving_incumbent_equals_the_jax_mesh():
    want = JM.mesh_resident_search(JaxPFSP(lb="lb1", ub=0, p_times=PTM), m=8,
                                   M=128, K=8, D=2)
    res = mesh_resident_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM), m=8,
                               M=128, K=8, D=2, device="cpu")
    assert _counts(res) == _counts(want)
    assert res.best == jax_seq(JaxPFSP(lb="lb1", ub=0, p_times=PTM)).best
    assert res.per_worker_tree == list(want.per_worker_tree)


def test_saturation_fallback_keeps_the_counts():
    # Every shard's share (about 1,500 nodes) past its fan-out headroom
    # (2000 - 64*10) with no shard starving: the dispatch runs no cycle and
    # balancing moves nothing, so the host offload runs until it fits.
    res = mesh_resident_search(NQueensProblem(10), m=8, M=64, K=4, rounds=1,
                               capacity=2000, warmup_target=6000, D=4,
                               device="cpu")
    assert (res.explored_tree, res.explored_sol) == (35538, 724)
    assert res.stall_fallbacks >= 1
    d = res.diagnostics
    assert d.host_to_device > 1 and d.device_to_host >= d.host_to_device - 1


def test_single_shard_equals_resident_search():
    res = mesh_resident_search(NQueensProblem(9), m=8, M=128, K=8, D=1,
                               device="cpu")
    ref = resident_search(NQueensProblem(9), m=8, M=128, K=8, device="cpu")
    assert _counts(res)[:2] == _counts(ref)[:2] == (8393, 352)
    assert res.per_worker_tree == [ref.phases[1].tree]


@pytest.mark.parametrize("lb", ["lb1_d", "lb2"])
def test_unfused_shards_equal_the_fused_ones(lb):
    opt = jax_seq(JaxPFSP(lb="lb1", ub=0, p_times=PTM)).best
    fused = mesh_resident_search(PFSPProblem(lb="lb1" if lb == "lb1_d" else lb,
                                             ub=0, p_times=PTM),
                                 m=8, M=128, K=8, D=2, device="cpu",
                                 initial_best=opt)
    unfused = mesh_resident_search(PFSPProblem(lb=lb, ub=0, p_times=PTM), m=8,
                                   M=128, K=8, D=2, device="cpu",
                                   initial_best=opt, fused=False)
    assert not unfused.fused and unfused.staged == (lb == "lb2")
    assert _counts(unfused) == _counts(fused)
    assert unfused.per_worker_tree == fused.per_worker_tree


def _jax_frontier(prob, target):
    from tpu_tree_search.engine.device import warmup
    from tpu_tree_search.pool import SoAPool
    from tpu_tree_search.problems.base import index_batch

    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    _, _, best = warmup(prob, pool, getattr(prob, "initial_ub", 2**31 - 1),
                        target)
    return pool.as_batch(), best


@pytest.mark.parametrize("kind", ["nqueens", "lb1"])
def test_one_dispatch_equals_the_jax_step(kind):
    D, m, M, K, rounds = 4, 8, 64, 4, 2
    if kind == "nqueens":
        jprob, prob = JaxNQueens(9), NQueensProblem(9)
    else:
        jprob = JaxPFSP(lb="lb1", ub=0, p_times=PTM)
        prob = PFSPProblem(lb="lb1", ub=0, p_times=PTM)
    n = prob.child_slots
    capacity, T = 4 * M * n, 2 * m
    frontier, best = _jax_frontier(jprob, 300)
    import jax

    mesh = JM.make_dp_mp_mesh(jax.devices(), D, 1)
    jprog = JM.get_mesh_program(jprob, mesh, m, M, K, rounds, T, capacity)
    shards = [{k: v[w::D] for k, v in frontier.items()} for w in range(D)]
    out = jprog.step(jprog.init_state(shards, best))
    tree, sol, cycles, sizes, jbest, tree_vec, _ = jprog.read_scalars(out)
    jvals = np.asarray(out[0]).reshape(D, capacity, -1)
    jaux = np.asarray(out[1]).reshape(D, capacity)

    prog = get_mesh_program(prob, D, m, M, K, rounds, T, capacity, "cpu")
    try:
        prog.upload(frontier, best)
        rows, _, _ = prog.enqueue()()
        assert [r[0] for r in rows] == sizes.tolist()
        assert {r[1] for r in rows} == {jbest}
        assert [r[2] for r in rows] == np.asarray(tree_vec).tolist()
        assert sum(r[3] for r in rows) == sol
        assert sum(r[4] for r in rows) == cycles
        assert tree == sum(r[2] for r in rows)
        # Every live row of every shard, in order: the port's cycle pushes
        # survivors in the JAX (parent, slot) order, and the balance keeps
        # the live prefix's order.
        for d in range(D):
            s = int(sizes[d])
            np.testing.assert_array_equal(
                prog.pool_vals[d, :s].numpy().astype(np.int64),
                jvals[d, :s].astype(np.int64))
            np.testing.assert_array_equal(
                prog.pool_aux[d, :s].numpy().astype(np.int64),
                jaux[d, :s].astype(np.int64))
    finally:
        prog.release()


def _numpy_round(sizes, best, vals, aux, m, T, Mn):
    """The JAX round's balance on numpy copies (`resident_mesh.py:204-265`):
    every shard's gift from the gathered sizes, the ``jnp.roll`` shed and
    the whole-block ``dynamic_update_slice`` append."""
    D, C = aux.shape
    out_v, out_a, out_sz = vals.copy(), aux.copy(), list(sizes)
    for me in range(D):
        sz = sizes[me]
        right, left = (me + 1) % D, (me - 1) % D
        give = inc = 0
        if D > 1:
            if sizes[right] < m and sz >= 2 * m and sizes[right] + T + Mn <= C:
                give = min(sz // 2, T)
            if sz < m and sizes[left] >= 2 * m and sz + T + Mn <= C:
                inc = min(sizes[left] // 2, T)
        v, a = vals[me], aux[me]
        if give:
            v, a = np.roll(v, -give, axis=0), np.roll(a, -give)
        after = sz - give
        if D > 1 and sz + T + Mn <= C:
            v, a = v.copy(), a.copy()
            v[after:after + T] = vals[left][:T]
            a[after:after + T] = aux[left][:T]
        out_v[me], out_a[me], out_sz[me] = v, a, after + inc
    return out_sz, min(best), out_v, out_a


@pytest.mark.parametrize("sizes,T,first,last", [
    ([3000], 1024, True, True),
    ([5000, 3], 1024, True, False),
    ([3000, 0], 1024, False, True),      # the gift is T; kept rows overlap
    ([9000, 10, 80, 0], 512, False, False),
    ([900, 100, 60, 50], 512, True, True),  # no gift
    ([40, 40, 3, 3], 4096, True, False),  # no room for T + M*n: no gift
    ([2000, 0, 3000, 5, 900, 0, 1500, 1], 512, True, False),  # D / 2 gifts
])
def test_balance_plain_equals_the_jax_round(sizes, T, first, last):
    D, C, n, m, Mn = len(sizes), 12000, 7, 25, 4000
    rng = np.random.default_rng(sum(sizes) + T)
    vals = rng.integers(0, n, (D, C, n)).astype(np.int8)
    aux = rng.integers(-1, n, (D, C)).astype(np.int8)
    st = rng.integers(0, 1000, (D, ST_LEN)).astype(np.int32)
    st[:, 0] = sizes
    want_sz, want_best, want_v, want_a = _numpy_round(
        sizes, st[:, 1].tolist(), vals, aux, m, T, Mn)
    t_st, t_v, t_a = (torch.from_numpy(x.copy()) for x in (st, vals, aux))
    MS.mesh_balance_plain(t_st, t_v, t_a, m, T, Mn, first, last)
    assert t_st[:, 0].tolist() == want_sz
    assert set(t_st[:, 1].tolist()) == {want_best}
    for d in range(D):
        s = want_sz[d]
        np.testing.assert_array_equal(t_v[d, :s].numpy(), want_v[d, :s])
        np.testing.assert_array_equal(t_a[d, :s].numpy(), want_a[d, :s])
    # The dispatch's sums: a first round starts them, a later one adds to
    # them, the last writes them back where the counts are read.
    sums = st[:, 2:5].astype(np.int64) + (0 if first else st[:, 10:13])
    assert t_st[:, 10:13].numpy().tolist() == sums.tolist()
    if last:
        assert t_st[:, 2:5].numpy().tolist() == sums.tolist()
    assert t_st[:, 24:26].abs().sum() == 0


@pytest.mark.parametrize("D", [2, 3, 4, 5, 8])
def test_at_most_half_the_shards_give(D):
    # The balance scratch stages D // 2 shards: a donor's right neighbour
    # is a receiver and no shard both gives and takes, so no round has
    # more donors than that.
    m, T, Mn, C = 25, 512, 1000, 5000
    rng = np.random.default_rng(D)
    most = 0
    alternate = [3000, 0] * (D // 2) + [25] * (D % 2)  # D // 2 donors
    for i in range(500):
        sizes = alternate if i == 0 else rng.choice(
            [0, 3, 24, 25, 49, 50, 400, 3000], D).tolist()
        give, take = MS.balance_plan(sizes, m, T, Mn, C)
        assert not any(g and t for g, t in zip(give, take))
        assert [bool(t) for t in take] == [bool(g) for g in give[-1:] + give[:-1]]
        most = max(most, sum(map(bool, give)))
    assert most == D // 2
    vals = torch.zeros((D, 64, 7), dtype=torch.int8)
    scratch = MS.MeshScratch.make(vals, torch.zeros((D, 64), dtype=torch.int8))
    assert scratch.stage_vals.shape == (D // 2, 64, 7)
    assert scratch.stage_aux.shape == (D // 2, 64) and scratch.plan.shape == (D, 4)
    assert scratch.nbytes == (D // 2) * 64 * 8 + D * 16


def test_pool_bytes_count_the_mesh_scratch():
    from types import SimpleNamespace

    from tpu_tree_search_torch.serve.pool import resident_pool_bytes

    D, C, n = 4, 64, 7
    inner = SimpleNamespace(vals_dtype=torch.int8, aux_dtype=torch.int8,
                            capacity=C)
    scratch = MS.MeshScratch.make(torch.zeros((D, C, n), dtype=torch.int8),
                                  torch.zeros((D, C), dtype=torch.int8))
    prog = SimpleNamespace(inner=inner, D=D, scratch=scratch)
    problem = SimpleNamespace(child_slots=n, _mesh_programs={"k": prog})
    assert resident_pool_bytes(problem) == D * C * (n + 1) + scratch.nbytes
    prog.scratch = None  # off the card: the plain step needs no scratch
    assert resident_pool_bytes(problem) == D * C * (n + 1)


def test_jax_mesh_cut_resumes_on_the_port_mesh(tmp_path):
    path = str(tmp_path / "jax_mesh.npz")
    part = JM.mesh_resident_search(JaxNQueens(10), m=8, M=64, K=2, D=4,
                                   max_steps=1, checkpoint_path=path)
    assert not part.complete
    res = mesh_resident_search(NQueensProblem(10), m=8, M=64, K=4, D=2,
                               device="cpu", resume_from=path)
    assert (res.explored_tree, res.explored_sol) == (35538, 724)
    back = str(tmp_path / "port_mesh.npz")
    cut = mesh_resident_search(NQueensProblem(10), m=8, M=64, K=2, D=4,
                               device="cpu", max_steps=1, checkpoint_path=back)
    assert not cut.complete
    done = jax_resident(JaxNQueens(10), m=8, M=64, K=4, resume_from=back)
    assert (done.explored_tree, done.explored_sol) == (35538, 724)


def test_a_second_search_reuses_the_cached_program():
    prob = NQueensProblem(8)
    a = mesh_resident_search(prob, m=5, M=64, D=2, device="cpu")
    (prog,) = prob._mesh_programs.values()
    b = mesh_resident_search(prob, m=5, M=64, D=2, device="cpu")
    assert prob._mesh_programs and list(prob._mesh_programs.values()) == [prog]
    assert _counts(a)[:2] == _counts(b)[:2] == (2056, 92)
    assert not prog.busy
    from tpu_tree_search_torch.engine.resident import release_programs

    assert release_programs(prob) == 1 and not prob._mesh_programs


def test_serve_runs_a_mesh_job(tmp_path):
    import json
    import time
    import urllib.request

    from tpu_tree_search_torch.serve.server import ServeDaemon

    d = ServeDaemon(port=0, state_dir=str(tmp_path / "state"), device="cpu")
    d.start()
    try:
        spec = {"problem": "nqueens", "N": 8, "M": 64, "tier": "mesh", "D": 2}
        req = urllib.request.Request(
            d.url + "/submit", data=json.dumps(spec).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            sub = json.loads(r.read().decode())
        assert "D2" in sub["class"]
        deadline = time.monotonic() + 120
        while True:
            with urllib.request.urlopen(d.url + f"/job/{sub['id']}",
                                        timeout=30) as r:
                rec = json.loads(r.read().decode())
            if rec["state"] in ("done", "failed", "cancelled"):
                break
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert rec["state"] == "done", rec
        res = rec["result"]
        assert (res["explored_tree"], res["explored_sol"]) == (2056, 92)
        assert rec["spec"]["tier"] == "mesh" and rec["spec"]["D"] == 2
    finally:
        d.scheduler.drain(timeout_s=30.0)
        d.close()
