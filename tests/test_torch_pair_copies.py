"""The mesh's shard copies under the lb2 pair axis (``--mp`` over several
device positions) and their pair exchange, on the CPU: each shard has a
copy at each distinct position of its (dp, mp) grid row, which bounds the
pair blocks placed there and joins its peers' planes through the plain
exchange (copies in host threads, a barrier, ``torch.maximum``).

  * the copy layout against ``mp_grid`` and the JAX ``make_dp_mp_mesh``
    rows, and the groups a ``MeshProgram`` builds from it;
  * the plain exchange: the max over the copies, the live count, the two
    parity slots over many exchanges, and a missing peer raising within
    the timeout;
  * the pair blocks' evaluators with a copy's blocks and exchange against
    the full bounds, and the contracts ``check`` holds the copies to;
  * the mesh over ``cpu,cpu,cpu,cpu`` and over ``cpu,cpu`` at D = 2,
    mp = 2 (staged and single-pass) against the JAX
    ``mesh_resident_search`` at mp = 2 on the suite's virtual CPU devices,
    shard for shard, and dispatch by dispatch against the one-position
    program (every state row and live row); a copy's diverged row raising;
  * ``dist_mesh`` at mp = 2 over two CPU positions a host against the JAX
    tier; cuts resumed across the two packages both ways;
  * the CLI's ``--stats-file`` and ``--profile``.

Tolerance: exact equality (counts, shard trees, bounds, rows).
"""

from __future__ import annotations

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpu_tree_search.parallel import dist_mesh as JDM
from tpu_tree_search.parallel import resident_mesh as JM
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.analysis import program_audit as PA
from tpu_tree_search_torch.analysis.contracts import get
from tpu_tree_search_torch.engine.device import warmup
from tpu_tree_search_torch.engine.sequential import sequential_search
from tpu_tree_search_torch.ops import pfsp_device as PD
from tpu_tree_search_torch.ops.pair_exchange import ST_XERR, PairExchange
from tpu_tree_search_torch.parallel.dist_mesh import dist_mesh_search
from tpu_tree_search_torch.parallel.resident_mesh import (
    MeshProgram,
    copy_layout,
    get_mesh_program,
    loop_rows,
    mesh_resident_search,
    mp_grid,
)
from tpu_tree_search_torch.pool.pool import SoAPool
from tpu_tree_search_torch.problems import PFSPProblem
from tpu_tree_search_torch.problems.base import index_batch

# 1,467 nodes under an improving incumbent, 326 at the optimum.
PTM10 = taillard.reduced_instance(14, jobs=10, machines=5)
PTM8 = taillard.reduced_instance(14, jobs=8, machines=5)


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


# -- the layout ------------------------------------------------------------------


@pytest.mark.parametrize("D,mp,G", [(2, 2, 4), (2, 2, 2), (1, 3, 2), (4, 2, 8)])
def test_copy_layout_follows_mp_grid(D, mp, G):
    grid = mp_grid(D, mp, G)
    # The JAX layout where the list is long enough (`make_dp_mp_mesh`).
    if D * mp <= len(jax.devices()) and D * mp <= G:
        want = np.asarray([d.id for d in np.asarray(
            JM.make_dp_mp_mesh(jax.devices()[:G], D, mp).devices).reshape(-1)]
        ).reshape(D, mp) - jax.devices()[0].id
        assert grid == want.tolist()
    layout = copy_layout(grid)
    for row, copies in zip(grid, layout):
        # One copy a distinct position, in the order of its first block;
        # the blocks at a position are those the grid places there.
        assert [p for p, _ in copies] == list(dict.fromkeys(row))
        assert sorted(i for _, blocks in copies for i in blocks) == list(range(mp))
        for p, blocks in copies:
            assert all(row[i] == p for i in blocks)
    prob = PFSPProblem(lb="lb2", ub=0, p_times=PTM8)
    prog = MeshProgram(prob, D, 4, 16, 2, 2, 8, 4 * 16 * 8, devices=["cpu"] * G,
                       mp=mp)
    try:
        positions = sorted({p for copies in layout for p, _ in copies})
        assert len(prog.groups) == len(positions)
        for g, p in zip(prog.groups, positions):
            want = [(d, i, blocks) for d, copies in enumerate(layout)
                    for i, (q, blocks) in enumerate(copies) if q == p]
            several = [len(layout[d]) > 1 for d, _, _ in want]
            assert [(c.shard, c.index) for c in g.copies] == [w[:2] for w in want]
            for c, prog_c, (_, _, blocks), many in zip(g.copies, g.programs, want,
                                                       several):
                assert prog_c.blocks == (tuple(blocks) if many else None)
                assert (prog_c.exchange is not None) == many
                assert prog_c.exchange is c.endpoint
        assert prog.copied == any(len(c) > 1 for c in layout)
    finally:
        prog.close()


# -- the plain exchange ----------------------------------------------------------


def _run_copies(fns, timeout=30):
    out, errors = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 -- the test reads it
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    return out, errors


@pytest.mark.parametrize("copies", [2, 3])
def test_plain_exchange_is_the_max_over_the_copies(copies):
    rng = np.random.default_rng(copies)
    x = PairExchange(["cpu"] * copies, 64)
    ends = [x.endpoint(i) for i in range(copies)]
    for step in range(5):  # both parity slots, twice over
        planes = [torch.from_numpy(rng.integers(-50, 50, (8, 6)).astype(np.int32))
                  for _ in range(copies)]
        count = None if step % 2 == 0 else torch.tensor(13, dtype=torch.int32)
        got, errors = _run_copies([
            lambda i=i: ends[i](planes[i], count) for i in range(copies)])
        assert not errors
        full = torch.stack(planes).amax(0)
        for i, g in enumerate(got):
            if count is None:
                assert torch.equal(g, full)
            else:
                flat, own = g.reshape(-1), planes[i].reshape(-1)
                assert torch.equal(flat[:13], full.reshape(-1)[:13])
                assert torch.equal(flat[13:], own[13:])


def test_plain_exchange_raises_on_a_missing_peer():
    x = PairExchange(["cpu", "cpu"], 16, timeout_s=0.3)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="never posted"):
        x.endpoint(0)(torch.zeros(16, dtype=torch.int32))
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(ValueError, match="2 to 33 copies"):
        PairExchange(["cpu"], 16)


@pytest.mark.parametrize("mp", [2, 3, 4])
def test_copies_of_the_evaluators_max_to_the_full_bounds(mp):
    tables = PFSPProblem(inst=14, lb="lb2", ub=1).device_tables("cpu")
    rng = np.random.default_rng(mp)
    B, n = 24, 20
    prmu = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(B)])
                            .astype(np.int8))
    limit1 = torch.from_numpy(rng.integers(-1, n - 1, B).astype(np.int8))
    layout = copy_layout(mp_grid(1, mp, 2))[0]
    x = PairExchange(["cpu", "cpu"], B * n)
    ends = [x.endpoint(i) for i in range(2)]
    child, errors = _run_copies([
        lambda i=i: PD.lb2_bounds_mp(prmu, limit1, tables, mp,
                                     blocks=layout[i][1], exchange=ends[i])
        for i in range(2)])
    assert not errors
    full = PD.lb2_chunk(prmu, limit1, tables)
    assert all(torch.equal(c, full) for c in child)
    count = torch.tensor(B - 5, dtype=torch.int32)
    selfb, errors = _run_copies([
        lambda i=i: PD.lb2_self_bounds_mp(prmu, limit1, count, tables, mp,
                                          layout[i][1], ends[i])
        for i in range(2)])
    assert not errors
    want = PD.lb2_self_chunk(prmu, limit1, B, tables)
    assert all(torch.equal(s[:B - 5], want[:B - 5]) for s in selfb)


# -- the contracts ---------------------------------------------------------------


@pytest.mark.parametrize("mp,copy", [(2, 0), (2, 1), (4, 0), (4, 1)])
def test_each_copy_launches_its_blocks_and_one_exchange(mp, copy):
    art = PA.pair_blocks_artifact(mp, "cpu", copy)
    assert art["exchange"] and art["blocks"] == copy_layout(mp_grid(1, mp, 2))[0][copy][1]
    for kind in ("child", "self"):
        routes = [e.name for e in art[kind] if e.kind == "route"]
        assert routes[-1] == "pair_exchange_cuda"
        assert len(routes) == len(art["blocks"]) + 1
    assert get("lb2-pair-blocks-one-launch").run(art, None) == []
    # A copy that bounded every block (or skipped the exchange) is found.
    bad = dict(art, child=art["child"][:-1])
    assert get("lb2-pair-blocks-one-launch").run(bad, None)


def test_mesh_copies_contract_finds_host_nodes_and_missing_exchanges():
    c = get("mesh-copies-device-only")
    body = [("slot_gate", "kernel"), ("conditional", "conditional")]
    gate = [("_Z9xchg_postPKi", "kernel"), ("_Z9xchg_waitPKj", "kernel"),
            ("_Z8xchg_maxPi", "kernel")]
    good = {"nodes": {"group0.round0.body": body,
                      "group0.round0.round0.gate0": gate}}
    assert c.run(good, None) == []
    host = {"nodes": {"group0.round0.body": body + [("memcpy_host", "memcpy_host")],
                      "group0.round0.round0.gate0": gate}}
    assert any("host nodes" in f for f in c.run(host, None))
    lost = {"nodes": {"group0.round0.round0.gate0": gate[:1] + gate[2:]}}
    assert any("exchange kernels" in f for f in c.run(lost, None))


# -- the mesh --------------------------------------------------------------------


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu"] * 2])
def test_copies_mesh_equals_jax_shard_for_shard(devices, staged):
    opt = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10)).best
    want = JM.mesh_resident_search(JaxPFSP(lb="lb2", ub=0, p_times=PTM10),
                                   m=4, M=32, K=4, D=2, mp=2,
                                   initial_best=opt)
    res = mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                               m=4, M=32, K=4, D=2, mp=2, devices=devices,
                               initial_best=opt, staged=staged)
    assert _counts(res) == _counts(want)
    assert res.per_worker_tree == list(want.per_worker_tree)
    assert (res.mp, res.fused, res.staged) == (2, False, staged)
    # An improving incumbent: the exchange keeps every copy's prune in step.
    want = JM.mesh_resident_search(JaxPFSP(lb="lb2", ub=0, p_times=PTM10),
                                   m=4, M=32, K=4, D=2, mp=2)
    res = mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                               m=4, M=32, K=4, D=2, mp=2, devices=devices,
                               staged=staged)
    assert _counts(res) == _counts(want)
    assert res.per_worker_tree == list(want.per_worker_tree)


def _frontier(prob, target):
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    _, _, best = warmup(prob, pool, 2**31 - 1, target)
    return pool.as_batch(), best


@pytest.mark.parametrize("G", [2, 4])
def test_copies_equal_one_position_dispatch_by_dispatch(G):
    prob = PFSPProblem(lb="lb2", ub=0, p_times=PTM10)
    D, m, M, K, rounds = 2, 4, 32, 2, 2
    capacity, T = 4 * M * prob.child_slots, 2 * m
    frontier, best = _frontier(prob, 200)
    one = get_mesh_program(prob, D, m, M, K, rounds, T, capacity, "cpu", mp=2)
    two = get_mesh_program(prob, D, m, M, K, rounds, T, capacity, mp=2,
                           devices=["cpu"] * G)
    try:
        assert len(one.groups) == 1 and len(two.groups) == (2 if G == 2 else 4)
        assert two.copied and not one.copied
        one.upload(frontier, best)
        two.upload(frontier, best)
        for _ in range(4):
            rows1, _, _ = one.enqueue()()
            rows2, _, _ = two.enqueue()()
            assert loop_rows(rows1) == loop_rows(rows2)
            for d, copy, state in two.copy_states():
                s = rows1[d][0]
                assert torch.equal(one.states[d].pool_vals[:s], state.pool_vals[:s])
                assert torch.equal(one.states[d].pool_aux[:s], state.pool_aux[:s])
                assert int(state.st[ST_XERR]) == 0
        # A copy whose row left its primary's is found at the read.
        rows = two.copy_st.tolist()
        rows[0][1][0] += 1
        with pytest.raises(RuntimeError, match="diverged"):
            two.check_copies(rows)
        rows = two.copy_st.tolist()
        rows[1][0][ST_XERR] = 1
        with pytest.raises(RuntimeError, match="never posted"):
            two.check_copies(rows)
        assert two.failed
    finally:
        one.release()
        two.release()
    # A failed program is closed at its release, never served again.
    assert two.cache_key is None and two.states == []
    assert one.cache_key is not None


def test_copies_of_groups_holding_other_shards():
    # D = 3, mp = 2 over three positions: grid [[0, 1], [2, 0], [1, 2]], so
    # each position holds copies of two different shards, and a shard's
    # copies sit beside different shards; the copies stay in step.
    assert mp_grid(3, 2, 3) == [[0, 1], [2, 0], [1, 2]]
    opt = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10)).best
    want = mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                                m=4, M=32, K=4, D=3, mp=2, device="cpu",
                                initial_best=opt)
    res = mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                               m=4, M=32, K=4, D=3, mp=2, devices=["cpu"] * 3,
                               initial_best=opt)
    assert _counts(res) == _counts(want)
    assert res.per_worker_tree == want.per_worker_tree
    assert res.dispatches == want.dispatches


def test_dist_mesh_copies_equal_jax():
    opt = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10)).best
    want = JDM.dist_mesh_search(JaxPFSP(lb="lb2", ub=0, p_times=PTM10), m=4,
                                M=32, K=4, D=2, mp=2, num_hosts=2,
                                initial_best=opt)
    # Two CPU positions a host: each host's shards copied on both.
    res = dist_mesh_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10), m=4,
                           M=32, K=4, D=2, mp=2, num_hosts=2,
                           devices=["cpu"] * 4, initial_best=opt)
    assert _counts(res) == _counts(want)
    assert res.mp == 2 and not res.fused


def test_cuts_resume_across_the_packages(tmp_path):
    seq = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10))
    want = sequential_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                             initial_best=seq.best)
    # The JAX mp mesh's cut, resumed on the port's copies.
    path = str(tmp_path / "jax.npz")
    part = JM.mesh_resident_search(JaxPFSP(lb="lb2", ub=0, p_times=PTM10),
                                   m=4, M=8, K=1, D=2, mp=2, max_steps=1,
                                   checkpoint_path=path,
                                   initial_best=seq.best)
    assert not part.complete
    res = mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                               m=4, M=32, K=4, D=2, mp=2, devices=["cpu"] * 4,
                               resume_from=path, initial_best=seq.best)
    assert res.complete and _counts(res) == _counts(want)
    # The copies' cut (read from the primaries), resumed on the JAX mesh.
    path = str(tmp_path / "port.npz")
    part = mesh_resident_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM10),
                                m=4, M=8, K=1, D=2, mp=2, devices=["cpu"] * 4,
                                max_steps=2, checkpoint_path=path,
                                initial_best=seq.best)
    assert not part.complete and part.explored_tree > 0
    res = JM.mesh_resident_search(JaxPFSP(lb="lb2", ub=0, p_times=PTM10),
                                  m=4, M=32, K=4, D=2, mp=2, resume_from=path,
                                  initial_best=seq.best)
    assert res.complete and _counts(res) == _counts(want)


# -- the CLI ---------------------------------------------------------------------


def test_cli_copies_mesh_and_stats_file(tmp_path, capsys):
    stats = tmp_path / "stats.dat"
    argv = ["pfsp", "--inst", "14", "--lb", "lb2", "--ub", "1", "--tier", "mesh",
            "--device", "cpu,cpu,cpu,cpu", "--mp", "2", "--M", "64", "--K", "2",
            "--max-steps", "2", "--json", "--stats-file", str(stats)]
    recs = []
    for _ in range(2):
        assert cli.main(argv) == 0
        recs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    lines = [json.loads(ln) for ln in stats.read_text().splitlines()]
    assert len(lines) == 2
    drop = ("elapsed_s", "phases", "graph_build_s", "dispatch_device_s")
    for line, rec in zip(lines, recs):
        assert {k: v for k, v in line.items() if k not in drop} == {
            k: v for k, v in rec.items() if k not in drop}
        assert line["mp"] == 2 and line["D"] == 2 and line["explored_tree"] > 0


def test_cli_profile_writes_a_trace_and_refuses_torch_trace(tmp_path, capsys):
    out = tmp_path / "prof"
    assert cli.main(["nqueens", "--N", "8", "--device", "cpu", "--M", "64",
                     "--profile", str(out)]) == 0
    trace = json.loads((out / "torch_profile.json").read_text())
    assert trace["traceEvents"]
    capsys.readouterr()
    assert cli.main(["nqueens", "--N", "8", "--device", "cpu", "--profile",
                     str(out), "--torch-trace", str(tmp_path / "t")]) == 2
    err = capsys.readouterr().err
    assert err.startswith("Error: ") and "pick one" in err
