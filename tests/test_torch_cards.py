"""Mesh shards and multi workers on a list of device positions
(``devices=[...]``, ``--device a,b``), on the CPU: two positions naming
the CPU make two groups, the path that several cards take (the rounds a
group, the cross-group balance: the states and first T rows gathered on
the first position, the plan there, each group's gifts and sheds on its
own device).

  * one mesh dispatch over ``["cpu", "cpu"]`` at D = 4 leaves, in every
    shard, the live rows and the state row of the one-group program at
    D = 4 (the balance plan depends only on sizes and incumbents), and so
    do three more; whole searches equal the one-group counts and shard
    trees, fused, unfused and under mp = 2;
  * ``shard_moves`` against ``mesh_balance_plain``'s gifts;
  * the CLI: ``--tier mesh`` and ``--tier multi`` over ``--device
    cpu,cpu``, and the refusals (one device for the single-device tier, a
    card that is not there);
  * the (dp, mp) grid of device positions against the JAX
    ``make_dp_mp_mesh`` layout.

Each whole search is held against the JAX package on the same inputs: the
JAX ``mesh_resident_search`` (counts and shard trees) on the suite's
virtual CPU devices, the JAX ``multidevice_search`` and the JAX sequential
tier (counts). Tolerance: exact equality (counts, node values).
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from tpu_tree_search.engine.sequential import sequential_search as jax_seq
from tpu_tree_search.parallel import resident_mesh as JM
from tpu_tree_search.parallel.multidevice import (
    multidevice_search as jax_multidevice,
)
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine.device import warmup
from tpu_tree_search_torch.ops import mesh as MS
from tpu_tree_search_torch.ops.cycle import ST_LEN
from tpu_tree_search_torch.parallel.multidevice import multidevice_search
from tpu_tree_search_torch.parallel.resident_mesh import (
    get_mesh_program,
    mesh_resident_search,
    mp_grid,
)
from tpu_tree_search_torch.pool.pool import SoAPool
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem
from tpu_tree_search_torch.problems.base import index_batch
from tpu_tree_search_torch.problems.pfsp import taillard

PTM = taillard.reduced_instance(21, jobs=8, machines=6)


def _frontier(prob, target):
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    _, _, best = warmup(prob, pool, getattr(prob, "initial_ub", 2**31 - 1),
                        target)
    return pool.as_batch(), best


@pytest.mark.parametrize("kind", ["nqueens", "lb2_mp2"])
def test_two_groups_equal_one_dispatch_by_dispatch(kind):
    if kind == "nqueens":
        prob, mp = NQueensProblem(9), 1
    else:
        prob, mp = PFSPProblem(lb="lb2", ub=0, p_times=PTM), 2
    D, m, M, K, rounds = 4, 8, 64, 2, 2
    capacity, T = 4 * M * prob.child_slots, 2 * m
    frontier, best = _frontier(prob, 300)
    one = get_mesh_program(prob, D, m, M, K, rounds, T, capacity, "cpu",
                           mp=mp)
    two = get_mesh_program(prob, D, m, M, K, rounds, T, capacity, mp=mp,
                           devices=["cpu", "cpu"])
    try:
        assert len(one.groups) == 1
        # mp = 2 over two positions: each shard has a copy at each, which
        # bounds the pair block placed there (the copies of one position
        # form a group).
        assert [g.shards for g in two.groups] == (
            [[0, 2], [1, 3]] if mp == 1 else [[0, 1, 2, 3]] * 2)
        one.upload(frontier, best)
        two.upload(frontier, best)
        for _ in range(3):
            rows1, _, _ = one.enqueue()()
            rows2, _, _ = two.enqueue()()
            assert rows1 == rows2
            for d in range(D):
                s = rows1[d][0]
                a, b = one.states[d], two.states[d]
                assert torch.equal(a.pool_vals[:s], b.pool_vals[:s])
                assert torch.equal(a.pool_aux[:s], b.pool_aux[:s])
    finally:
        one.release()
        two.release()


@pytest.mark.parametrize("kw", [{}, {"fused": False}])
def test_two_groups_equal_one_whole_search(kw):
    one = mesh_resident_search(NQueensProblem(9), m=8, M=128, K=8, D=4,
                               device="cpu", **kw)
    two = mesh_resident_search(NQueensProblem(9), m=8, M=128, K=8, D=4,
                               devices=["cpu", "cpu"], **kw)
    want = JM.mesh_resident_search(JaxNQueens(9), m=8, M=128, K=8, D=4)
    assert (two.explored_tree, two.explored_sol) == (
        want.explored_tree, want.explored_sol)
    assert two.per_worker_tree == list(want.per_worker_tree)
    assert two.per_worker_tree == one.per_worker_tree
    assert two.dispatches == one.dispatches


def test_shard_moves_equal_the_plain_balance():
    # Sizes with two gifts (shards 0 and 2 give to 1 and 3).
    D, C, n, m, T, Mn = 4, 3000, 7, 25, 512, 1000
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.integers(0, n, (D, C, n)).astype(np.int8))
    aux = torch.from_numpy(rng.integers(-1, n, (D, C)).astype(np.int8))
    st = torch.from_numpy(rng.integers(0, 100, (D, ST_LEN)).astype(np.int32))
    st[:, 0] = torch.tensor([1500, 3, 900, 0])
    want_st, want_v, want_a = st.clone(), vals.clone(), aux.clone()
    MS.mesh_balance_plain(want_st, want_v, want_a, m, T, Mn, True, False)
    plan = torch.zeros((D, 4), dtype=torch.int32)
    left = torch.tensor([(d - 1) % D for d in range(D)])
    lv, la = vals[:, :T][left].clone(), aux[:, :T][left].clone()
    MS.mesh_plan(st, plan, m, T, Mn, C, True, False)
    assert torch.equal(st, want_st)
    assert plan[:, 1].tolist() == [512, 0, 450, 0]
    MS.shard_moves(vals, aux, plan, lv, la)
    for d in range(D):
        s = int(want_st[d, 0])
        assert torch.equal(vals[d, :s], want_v[d, :s])
        assert torch.equal(aux[d, :s], want_a[d, :s])


def test_multi_workers_on_two_positions():
    res = multidevice_search(NQueensProblem(10), m=8, M=128,
                             devices=["cpu", "cpu"])
    want = jax_multidevice(JaxNQueens(10), m=8, M=128, D=2)
    assert (res.explored_tree, res.explored_sol) == (
        want.explored_tree, want.explored_sol)
    assert len(res.per_worker_tree) == len(want.per_worker_tree) == 2


@pytest.mark.parametrize("tier", ["mesh", "multi"])
def test_cli_takes_a_device_list(tier, capsys):
    assert cli.main(["nqueens", "--N", "9", "--tier", tier, "--device",
                     "cpu,cpu", "--M", "64", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_seq(JaxNQueens(9))
    assert (rec["explored_tree"], rec["explored_sol"]) == (
        want.explored_tree, want.explored_sol)
    assert rec["D"] == 2 and rec["device"] == "cpu"


def test_device_list_refusals(capsys):
    assert cli.main(["nqueens", "--N", "8", "--device", "cpu,cpu"]) == 2
    assert "runs on one device" in capsys.readouterr().err
    with pytest.raises(ValueError, match="the device list is empty"):
        mesh_resident_search(NQueensProblem(8), D=2, devices=[])
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="cards or the CPU"):
            mesh_resident_search(NQueensProblem(8), D=2,
                                 devices=["cpu", "cuda"])
    else:  # a card that is not there raises, as --device cuda does
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_resident_search(NQueensProblem(8), D=2,
                                 devices=["cuda:0", "cuda:1"])


@pytest.mark.parametrize("D,mp,G", [(4, 2, 8), (2, 4, 8), (4, 1, 4),
                                    (2, 2, 4)])
def test_mp_grid_is_the_jax_layout(D, mp, G):
    # The port places replica (d, i) on position (d*mp + i) % G; where the
    # JAX package has D*mp devices it is its make_dp_mp_mesh grid.
    devs = jax.devices()[:G]
    mesh = JM.make_dp_mp_mesh(devs, D, mp)
    ids = {dev.id: k for k, dev in enumerate(devs)}
    want = np.vectorize(lambda dev: ids[dev.id])(mesh.devices).reshape(D, mp)
    assert mp_grid(D, mp, G) == want.tolist()
