"""The port's lb2 pair axis (``--mp``) and ``parallel/mesh.py`` against the
JAX package, on the CPU (the plain versions; the JAX package on the
suite's eight virtual CPU devices).

  * ``MeshEvaluator`` against the JAX one: N-Queens labels, PFSP bounds for
    (lb, mp) in (lb1, 1), (lb1_d, 1), (lb2, 1), (lb2, 2), (lb2, 4) on the
    open child slots, and the leaf fold with and without padding rows
    (the cases of `tests/test_mesh.py`);
  * ``PFSPDeviceTables.mp_padded`` against the JAX tables' array for
    array; the plain pair blocks, maxed, against the full plain lb2 and
    self bound;
  * one mesh dispatch at D = 4, mp = 2 against the JAX
    ``_MeshResidentProgram.step`` over ``make_dp_mp_mesh(jax.devices(), 4,
    2)``, row for row; the mesh at mp = 2 against the JAX mesh's counts and
    the sequential tier; the refusals off lb2; a JAX mp = 2 mesh cut
    resumed on the port's mesh;
  * ``dist_mesh`` with two virtual hosts at mp = 2 against the JAX counts;
    a serve job with ``spec.mp = 2``;
  * the unfused cycle of fixed shapes against the cycle it replaced (pop,
    the chunk cycle of `ops/cycle.py`, the survivors pushed at the new
    size) at a cycle that fits the survivor budget and one that
    overflows it.

Tolerance: exact equality (counts, node values, bounds on open slots).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tpu_tree_search.parallel import dist_mesh as JDM
from tpu_tree_search.parallel import mesh as JMesh
from tpu_tree_search.parallel import resident_mesh as JM
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.engine import resident as R
from tpu_tree_search_torch.engine.sequential import sequential_search
from tpu_tree_search_torch.ops import pfsp_device as PD
from tpu_tree_search_torch.ops.cycle import cycle_chunk_plain
from tpu_tree_search_torch.parallel import mesh as M
from tpu_tree_search_torch.parallel.dist_mesh import dist_mesh_search
from tpu_tree_search_torch.parallel.resident_mesh import (
    get_mesh_program,
    mesh_resident_search,
)
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

PTM8 = taillard.reduced_instance(14, jobs=8, machines=5)
PTM21 = taillard.reduced_instance(21, jobs=8, machines=6)
# 1,467 nodes under an improving incumbent, 326 at the optimum.
PTM10 = taillard.reduced_instance(14, jobs=10, machines=5)
CPU8 = ["cpu"] * 8


def _random_parents(jobs, B, depth, limit1, seed=0):
    rng = np.random.default_rng(seed)
    prmu = np.tile(np.arange(jobs, dtype=np.int32), (B, 1))
    for i in range(B):
        rng.shuffle(prmu[i])
    return {"depth": np.full((B,), depth, dtype=np.int32),
            "limit1": np.full((B,), limit1, dtype=np.int32), "prmu": prmu}


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


# -- MeshEvaluator ---------------------------------------------------------------


def test_nqueens_mesh_evaluator_equals_jax():
    B = 16
    parents = {"depth": np.full((B,), 3, dtype=np.int32),
               "board": np.tile(np.arange(10, dtype=np.uint8), (B, 1))}
    want, _ = JMesh.MeshEvaluator(JaxNQueens(N=10), JMesh.make_mesh(8))(
        parents, B, 0)
    ev = M.MeshEvaluator(NQueensProblem(10), M.make_mesh(8, devices=CPU8))
    got, best = ev(parents, B, 0)
    assert ev.pad_to_mesh(13) == 16 and best == 2**31 - 1
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("lb,mp", [("lb1", 1), ("lb1_d", 1), ("lb2", 1),
                                   ("lb2", 2), ("lb2", 4)])
def test_pfsp_mesh_evaluator_equals_jax(lb, mp):
    parents = _random_parents(8, 16, depth=3, limit1=2)
    want, wbest = JMesh.MeshEvaluator(
        JaxPFSP(lb=lb, ub=0, p_times=PTM8), JMesh.make_mesh(8, mp=mp))(
        parents, 16, 10**9)
    ev = M.MeshEvaluator(PFSPProblem(lb=lb, ub=0, p_times=PTM8),
                         M.make_mesh(8, mp=mp, devices=CPU8))
    assert (ev.dp, ev.mp) == (8 // mp, mp)
    got, best = ev(parents, 16, 10**9)
    open_ = np.arange(8) > 2
    np.testing.assert_array_equal(got.numpy()[:, open_],
                                  np.asarray(want)[:, open_])
    assert best == wbest == 10**9


@pytest.mark.parametrize("count", [16, 11])
def test_pfsp_leaf_fold_equals_jax(count):
    # count < 16: the rows past it are padding, leaf-shaped, and must not
    # reach the incumbent (`tests/test_mesh.py`).
    parents = _random_parents(8, 16, depth=7, limit1=6)
    want = JMesh.MeshEvaluator(JaxPFSP(lb="lb1", ub=0, p_times=PTM8),
                               JMesh.make_mesh(8))(parents, count, 10**9)[1]
    ev = M.MeshEvaluator(PFSPProblem(lb="lb1", ub=0, p_times=PTM8),
                         M.make_mesh(8, devices=CPU8))
    got, best = ev(parents, count, 10**9)
    assert best == want
    assert best == got.numpy()[:count, 7].min()


def test_mesh_evaluator_refusals():
    with pytest.raises(ValueError, match="not divisible by mp"):
        M.make_mesh(6, mp=4, devices=CPU8)
    with pytest.raises(ValueError, match="splits the lb2 Johnson pair loop"):
        M.MeshEvaluator(PFSPProblem(lb="lb1", ub=0, p_times=PTM8),
                        M.make_mesh(8, mp=2, devices=CPU8))
    ev = M.MeshEvaluator(NQueensProblem(6), M.make_mesh(4, devices=CPU8))
    with pytest.raises(ValueError, match="multiple of dp=4"):
        ev({"depth": np.zeros(6, np.int32),
            "board": np.zeros((6, 6), np.uint8)}, 6, 0)


# -- the pair blocks -------------------------------------------------------------


@pytest.mark.parametrize("inst,mp", [(14, 2), (14, 4), (21, 3), (21, 7)])
def test_mp_padded_equals_jax(inst, mp):
    want = JaxPFSP(inst=inst, lb="lb2", ub=1).device_tables().mp_padded(mp)
    tables = PFSPProblem(inst=inst, lb="lb2", ub=1).device_tables("cpu")
    got = tables.mp_padded(mp)
    assert got is tables.mp_padded(mp)  # cached
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    P_local = got[0].shape[0] // mp
    blocks = tables.pair_blocks(mp)
    assert [b.johnson.pair_count for b in blocks] == [P_local] * mp
    for i, b in enumerate(blocks):
        np.testing.assert_array_equal(
            b.johnson.host["pairs"], got[0][i * P_local:(i + 1) * P_local])


@pytest.mark.parametrize("mp", [2, 3, 4])
def test_plain_pair_blocks_max_to_the_full_bounds(mp):
    tables = PFSPProblem(inst=14, lb="lb2", ub=1).device_tables("cpu")
    rng = np.random.default_rng(mp)
    B, n = 24, 20
    prmu = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(B)])
                            .astype(np.int8))
    limit1 = torch.from_numpy(rng.integers(-1, n - 1, B).astype(np.int8))
    full = PD.lb2_chunk(prmu, limit1, tables)
    assert torch.equal(PD.lb2_bounds_mp(prmu, limit1, tables, mp), full)
    assert torch.equal(PD.lb2_chunk_mp(prmu, limit1, tables, mp), full)
    self_full = PD.lb2_self_chunk(prmu, limit1, B, tables)
    assert torch.equal(PD.lb2_self_bounds_mp(prmu, limit1, B, tables, mp),
                       self_full)
    # Each block alone is at most the full bound.
    for blk in tables.pair_blocks(mp):
        assert bool((PD.lb2_chunk(prmu, limit1, blk) <= full).all())


# -- the mesh tier under mp ------------------------------------------------------


def test_one_mp_dispatch_equals_the_jax_step():
    from tpu_tree_search.engine.device import warmup
    from tpu_tree_search.pool import SoAPool
    from tpu_tree_search.problems.base import index_batch

    D, mp, m, M_, K, rounds = 4, 2, 8, 64, 4, 2
    jprob = JaxPFSP(lb="lb2", ub=0, p_times=PTM21)
    prob = PFSPProblem(lb="lb2", ub=0, p_times=PTM21)
    n = prob.child_slots
    capacity, T = 4 * M_ * n, 2 * m
    pool = SoAPool(jprob.node_fields())
    pool.push_back(index_batch(jprob.root(), 0))
    _, _, best = warmup(jprob, pool, 2**31 - 1, 300)
    frontier = pool.as_batch()
    mesh = JM.make_dp_mp_mesh(jax.devices(), D, mp)
    jprog = JM.get_mesh_program(jprob, mesh, m, M_, K, rounds, T, capacity)
    shards = [{k: v[w::D] for k, v in frontier.items()} for w in range(D)]
    out = jprog.step(jprog.init_state(shards, best))
    tree, sol, cycles, sizes, jbest, tree_vec, _ = jprog.read_scalars(out)
    jvals = np.asarray(out[0]).reshape(D, capacity, -1)
    jaux = np.asarray(out[1]).reshape(D, capacity)

    prog = get_mesh_program(prob, D, m, M_, K, rounds, T, capacity, "cpu",
                            mp=mp)
    try:
        assert prog.mp == 2 and not prog.inner.fused and prog.inner.staged
        prog.upload(frontier, best)
        rows, _, _ = prog.enqueue()()
        assert [r[0] for r in rows] == sizes.tolist()
        assert {r[1] for r in rows} == {jbest}
        assert [r[2] for r in rows] == np.asarray(tree_vec).tolist()
        assert (sum(r[3] for r in rows), sum(r[4] for r in rows)) == (sol,
                                                                       cycles)
        assert tree == sum(r[2] for r in rows)
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


@pytest.mark.parametrize("staged", [True, False])
def test_mp_mesh_equals_jax_and_the_sequential_tier(staged):
    opt = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM21)).best
    seq = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM21),
                            initial_best=opt)
    want = JM.mesh_resident_search(JaxPFSP(lb="lb2", ub=0, p_times=PTM21),
                                   m=8, M=64, K=8, D=4, mp=2,
                                   initial_best=opt)
    res = mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM21),
                               m=8, M=64, K=8, D=4, mp=2, device="cpu",
                               initial_best=opt, staged=staged)
    assert _counts(res) == _counts(want) == _counts(seq)
    assert res.per_worker_tree == list(want.per_worker_tree)
    assert (res.mp, res.fused, res.staged) == (2, False, staged)
    # An improving incumbent: the pmin fold after every round, as in JAX.
    want = JM.mesh_resident_search(JaxPFSP(lb="lb2", ub=0, p_times=PTM10),
                                   m=4, M=32, K=4, D=4, mp=2)
    res = mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                               m=4, M=32, K=4, D=4, mp=2, device="cpu",
                               staged=staged)
    assert _counts(res) == _counts(want)
    assert res.per_worker_tree == list(want.per_worker_tree)


def test_mp_refusals_are_the_jax_ones():
    prob = PFSPProblem(lb="lb1", ub=0, p_times=PTM8)
    with pytest.raises(ValueError, match="splits the lb2 Johnson pair loop"):
        mesh_resident_search(prob, m=8, M=64, D=2, mp=2, device="cpu")
    with pytest.raises(ValueError, match="splits the lb2 Johnson pair loop"):
        mesh_resident_search(NQueensProblem(8), m=8, M=64, D=2, mp=2,
                             device="cpu")
    with pytest.raises(ValueError, match="mp must be >= 1"):
        mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM8),
                             mp=0, device="cpu")
    with pytest.raises(ValueError, match="splits the lb2 Johnson pair loop"):
        R.new_program(NQueensProblem(8), 8, 64, 4, 4096, "cpu", mp=2)


def test_jax_mp_mesh_cut_resumes_on_the_port(tmp_path):
    # At the optimum as the incumbent the counts of a cut and its resume
    # add up to the sequential tier's, whatever D and mp the resume takes.
    seq = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10))
    path = str(tmp_path / "jax_mp.npz")
    part = JM.mesh_resident_search(JaxPFSP(lb="lb2", ub=0, p_times=PTM10),
                                   m=4, M=8, K=1, D=2, mp=2, max_steps=1,
                                   checkpoint_path=path,
                                   initial_best=seq.best)
    assert not part.complete and 0 < part.explored_tree
    want = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                             initial_best=seq.best)
    res = mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                               m=4, M=32, K=8, D=4, mp=4, device="cpu",
                               resume_from=path, initial_best=seq.best)
    assert res.complete and _counts(res) == _counts(want)


def test_dist_mesh_mp_equals_jax():
    opt = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10)).best
    want = JDM.dist_mesh_search(JaxPFSP(lb="lb2", ub=0, p_times=PTM10), m=4,
                                M=32, K=4, D=2, mp=2, num_hosts=2,
                                initial_best=opt)
    res = dist_mesh_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10), m=4,
                           M=32, K=4, D=2, mp=2, num_hosts=2, device="cpu",
                           initial_best=opt)
    assert _counts(res) == _counts(want)
    assert res.mp == 2 and not res.fused


def test_serve_runs_an_mp_job(tmp_path):
    import json
    import time
    import urllib.request

    from tpu_tree_search_torch.serve.jobs import validate_spec
    from tpu_tree_search_torch.serve.server import ServeDaemon

    with pytest.raises(ValueError, match="pfsp lb='lb2' only"):
        validate_spec({"problem": "nqueens", "N": 8, "tier": "mesh",
                       "mp": 2}, "cpu")
    d = ServeDaemon(port=0, state_dir=str(tmp_path / "state"), device="cpu")
    d.start()
    try:
        spec = {"problem": "pfsp", "inst": 14, "lb": "lb2", "ub": 1,
                "M": 64, "K": 1, "tier": "mesh", "D": 2, "mp": 2,
                "max_steps": 1}
        req = urllib.request.Request(
            d.url + "/submit", data=json.dumps(spec).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            sub = json.loads(r.read().decode())
        assert "mp2" in sub["class"]
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
        assert rec["spec"]["mp"] == 2 and rec["result"]["explored_tree"] > 0
    finally:
        d.scheduler.drain(timeout_s=30.0)
        d.close()


# -- the unfused cycle of fixed shapes -------------------------------------------


def _old_cycle(prog, vals, aux, size, best):
    """The cycle the fixed-shape one replaced, on host copies: pop the back
    min(size, M) nodes, the chunk cycle (`ops/cycle.py`
    ``cycle_chunk_plain``: the survivors in (parent, slot) order), the
    survivors pushed at the new size."""
    M, C = prog.M, prog.capacity
    cnt = min(size, M)
    start = size - cnt
    start2 = min(max(start, 0), C - M)
    idx = start2 + torch.arange(M)
    valid = (idx >= start) & (idx < size)
    rows, caux, tree_inc, sol_inc, best_t = cycle_chunk_plain(
        vals[start2:start2 + M].clone(), aux[start2:start2 + M].to(torch.int32),
        valid, torch.tensor(best, dtype=torch.int32), prog.tables)
    t = int(tree_inc)
    vals[start:start + t] = rows[:t].to(vals.dtype)
    aux[start:start + t] = caux[:t].to(aux.dtype)
    return start + t, int(best_t), t, int(sol_inc)


@pytest.mark.parametrize("M_,overflow", [(128, True), (16, False)])
def test_fixed_shape_cycle_equals_the_old_loop(monkeypatch, M_, overflow):
    monkeypatch.setenv("TTS_OBS", "1")
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.pool.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    prob = PFSPProblem(lb="lb1", ub=0, p_times=PTM8)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    _, _, best = warmup(prob, pool, 2**31 - 1, 300 if overflow else 40)
    prog = R.new_program(prob, 8, M_, 4, 4 * M_ * 8, "cpu", fused=False)
    state = prog.own_state(pool.as_batch(), best)
    vals, aux = state.pool_vals.clone(), state.pool_aux.clone()
    size0 = pool.size
    want = _old_cycle(prog, vals, aux, size0, best)
    prog._unfused_cycle(state)
    st = state.st.tolist()
    assert (st[0], st[1], st[2], st[3], st[4]) == (want[0], want[1], want[2],
                                                   want[3], 1)
    ctr = st[16:24]
    assert (ctr[4] == 1) is overflow and want[2] > 0
    assert ctr[7] == (prog.M * 8 if overflow else prog.S)
    assert torch.equal(state.pool_vals[:want[0]], vals[:want[0]])
    assert torch.equal(state.pool_aux[:want[0]], aux[:want[0]])
    # The push writes nothing outside its window [start, start + M*n).
    end = size0 - min(size0, M_) + M_ * 8
    assert torch.equal(state.pool_vals[end:], vals[end:])
    # A slot whose condition fails runs no cycle (the host rounds' test,
    # the graphs' while and if nodes): its state and pool stay as they are.
    state.st[0] = prog.m - 1  # size < m
    before = (state.st.clone(), state.pool_vals.clone())
    prog.host_rounds([state], state.st[None], False)
    assert torch.equal(state.pool_vals, before[1])
    assert state.st[0] == before[0][0] and state.st[4] == 0
    prog.close()
