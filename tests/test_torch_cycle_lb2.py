"""The port's lb2 cycle against the JAX one-kernel lb2 cycle, bit for bit.

``cycle_chunk_plain`` under ``lb2_chunk`` (the make_cycle lb2 contract on one
popped chunk, with the unstaged keep ``open & ~leaf & lb2 < best``) is held
to the Pallas megakernel ``megakernel._lb2_cycle_call`` in interpret mode at
M=64, fed the pair-group-padded ordered tables exactly as ``make_cycle``
passes them: the live survivor rows and their limit1+1, tree_inc, sol_inc
and the folded incumbent, with a finite and an INF incumbent and with a
partial chunk. ``cycle_lb2_plain`` — the in-pool cycle, kernel 8's plain
version — is held to the chunk form and to the loop condition. Tolerance 0:
everything is integer. Kernel 8 is compared with ``cycle_lb2_plain`` on the
card in `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.ops import megakernel as MK
from tpu_tree_search.ops import pfsp_device as jdev
from tpu_tree_search.problems import PFSPProblem
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.ops import cycle as C
from tpu_tree_search_torch.ops.pfsp_device import lb2_chunk
from tpu_tree_search_torch.problems import PFSPProblem as TorchPFSP

INF = 2**31 - 1
CPU = torch.device("cpu")


def _problems(jobs, machines):
    if (jobs, machines) == (20, 10):
        return (PFSPProblem(inst=14, lb="lb2", ub=1),
                TorchPFSP(inst=14, lb="lb2", ub=1))
    ptm = taillard.reduced_instance(14, jobs=jobs, machines=machines)
    return (PFSPProblem(lb="lb2", ub=0, p_times=ptm),
            TorchPFSP(lb="lb2", ub=0, p_times=ptm))


def _chunk(rng, n, M, deep_share=0.25):
    """Random partial permutations; a share of them one swap from complete
    (limit1 = n-2) so that their children are leaves."""
    prmu = np.stack([rng.permutation(n) for _ in range(M)]).astype(np.int32)
    limit1 = rng.integers(-1, n - 2, M).astype(np.int32)
    limit1[rng.random(M) < deep_share] = n - 2
    return prmu, limit1


def _jax_cycle(jprob, prmu, limit1, valid, best):
    """The JAX lb2 megakernel on one chunk, its tables resolved as
    ``make_cycle`` resolves them (pair-group padding included)."""
    t = jdev.PFSPDeviceTables(jprob.lb1_data, jprob.lb2_data)
    n, m, M = jprob.jobs, jprob.machines, prmu.shape[0]
    pg = jdev.lb2_kernel_pair_group(t.pairs.shape[0], n)
    o = t.johnson_ordered_mp(pg)
    call = MK._lb2_cycle_call(n, m, o.lag_o.shape[0], M, pg,
                              bool(t.exact_bf16), True)
    rows, caux, scal = call(
        jnp.asarray(prmu), jnp.asarray(limit1)[:, None],
        jnp.asarray(valid.astype(np.int32))[:, None],
        jnp.asarray([best], dtype=jnp.int32),
        t.ptm_t, t.min_heads[None, :],
        o.p0_o[:, None, :], o.p1_o[:, None, :], o.lag_o[:, None, :],
        o.tails0, o.tails1, o.msel0[:, None, :], o.msel1[:, None, :],
        o.jorder)
    scal = np.asarray(scal)[0]
    return (np.asarray(rows), np.asarray(caux)[:, 0], int(scal[0]),
            int(scal[1]), int(scal[2]))


def _median_leaf_bound(tprob, prmu, limit1):
    n = prmu.shape[1]
    lb = lb2_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                   tprob.device_tables(CPU)).numpy()
    leaf = (np.arange(n)[None, :] > limit1[:, None]) & (limit1[:, None] == n - 2)
    return int(np.median(lb[leaf]))


@pytest.mark.parametrize("jobs,machines,finite,partial", [
    (10, 5, False, False),
    (10, 5, True, True),
    (20, 10, True, False),
    (20, 10, False, True),
])
def test_plain_lb2_chunk_cycle_matches_pallas_megakernel(jobs, machines, finite,
                                                         partial):
    jprob, tprob = _problems(jobs, machines)
    M = 64
    rng = np.random.default_rng(jobs + machines + int(partial) + 100)
    prmu, limit1 = _chunk(rng, jobs, M)
    best = _median_leaf_bound(tprob, prmu, limit1) if finite else INF
    valid = np.ones(M, dtype=bool)
    if partial:
        valid[:] = False
        valid[7:50] = True
    rows_j, caux_j, tree_j, sol_j, best_j = _jax_cycle(jprob, prmu, limit1,
                                                       valid, best)
    rows, caux, tree, sol, best_t = C.cycle_chunk_plain(
        torch.from_numpy(prmu).to(torch.int8), torch.from_numpy(limit1),
        torch.from_numpy(valid), torch.tensor(best, dtype=torch.int32),
        tprob.device_tables(CPU), lb2_chunk)
    assert (int(tree), int(sol), int(best_t)) == (tree_j, sol_j, best_j)
    assert tree_j > 0 and sol_j > 0 and best_j < best
    assert np.array_equal(rows[:tree_j].numpy(), rows_j[:tree_j])
    assert np.array_equal(caux[:tree_j].numpy(), caux_j[:tree_j])


def _pool(rng, n, size, C_rows, dtype=torch.int8):
    prmu, limit1 = _chunk(rng, n, size)
    pool_vals = torch.zeros((C_rows, n), dtype=dtype)
    pool_aux = torch.zeros(C_rows, dtype=dtype)
    pool_vals[:size] = torch.from_numpy(prmu).to(dtype)
    pool_aux[:size] = torch.from_numpy(limit1).to(dtype)
    return pool_vals, pool_aux


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("size", [40, 150])  # partial chunk / full chunk
def test_plain_lb2_pool_cycle_is_pop_chunk_push(size, dtype):
    _, tprob = _problems(10, 5)
    t = tprob.device_tables(CPU)
    n, M, m, K = 10, 64, 8, 4
    C_rows = size + M * n
    pool_vals, pool_aux = _pool(np.random.default_rng(size), n, size, C_rows,
                                dtype)
    before_vals, before_aux = pool_vals.clone(), pool_aux.clone()
    st = C.new_state(size, 700, CPU)
    C.cycle_lb2_plain(pool_vals, pool_aux, st, t, M, m, K)
    cnt = min(size, M)
    start = size - cnt
    rows, caux, tree, sol, best = C.cycle_chunk_plain(
        before_vals[start:size], before_aux[start:size],
        torch.ones(cnt, dtype=torch.bool), torch.tensor(700, dtype=torch.int32),
        t, lb2_chunk)
    tree = int(tree)
    assert tree > 0
    assert st[:C.ST_CYCLES + 1].tolist() == [start + tree, int(best), tree, int(sol), 1]
    assert st[C.ST_ACTIVE] == 1 and st[C.ST_CNT] == cnt and st[C.ST_BASE] == start
    assert torch.equal(pool_vals[:start], before_vals[:start])
    assert torch.equal(pool_vals[start:start + tree].int(), rows[:tree])
    assert torch.equal(pool_aux[start:start + tree].int(), caux[:tree])


def test_lb2_cycle_prunes_at_least_as_much_as_lb1():
    # lb2 >= lb1 on every open slot, so under one incumbent the lb2 cycle
    # keeps a subset of the lb1 cycle's survivors (and the same leaves).
    _, tprob = _problems(10, 5)
    t2 = tprob.device_tables(CPU)
    t1 = TorchPFSP(lb="lb1", ub=0, p_times=tprob.lb1_data.p_times).device_tables(CPU)
    prmu, limit1 = _chunk(np.random.default_rng(5), 10, 64)
    args = (torch.from_numpy(prmu), torch.from_numpy(limit1),
            torch.ones(64, dtype=torch.bool), torch.tensor(700, dtype=torch.int32))
    _, _, tree2, sol2, best2 = C.cycle_chunk_plain(*args, t2, lb2_chunk)
    _, _, tree1, sol1, best1 = C.cycle_chunk_plain(*args, t1)
    assert int(tree2) < int(tree1)
    assert (int(sol2), int(best2)) == (int(sol1), int(best1))


@pytest.mark.parametrize("case", ["below_m", "no_headroom", "cycles_spent"])
def test_plain_lb2_pool_cycle_is_noop_when_condition_false(case):
    _, tprob = _problems(10, 5)
    t = tprob.device_tables(CPU)
    n, M, m, K = 10, 64, 8, 4
    size = {"below_m": m - 1, "no_headroom": 100, "cycles_spent": 100}[case]
    C_rows = 100 + M * n - (1 if case == "no_headroom" else 0)
    pool_vals, pool_aux = _pool(np.random.default_rng(1), n, size, C_rows)
    st = C.new_state(size, INF, CPU)
    if case == "cycles_spent":
        st[C.ST_CYCLES] = K
    before = (pool_vals.clone(), pool_aux.clone(), st.clone())
    C.cycle_lb2_plain(pool_vals, pool_aux, st, t, M, m, K)
    assert torch.equal(pool_vals, before[0]) and torch.equal(pool_aux, before[1])
    assert st[C.ST_ACTIVE] == 0
    st[C.ST_ACTIVE] = before[2][C.ST_ACTIVE]
    assert torch.equal(st, before[2])


def test_lb2_cycle_router_takes_plain_on_cpu_and_kernel_refuses_cpu():
    _, tprob = _problems(10, 5)
    t = tprob.device_tables(CPU)
    pool_vals, pool_aux = _pool(np.random.default_rng(2), 10, 50, 50 + 640)
    st = C.new_state(50, INF, CPU)
    C.cycle_lb2(pool_vals, pool_aux, st, None, t, 64, 8, 4)
    assert int(st[C.ST_CYCLES]) == 1
    with pytest.raises(ValueError):
        C.cycle_lb2_cuda(pool_vals, pool_aux, st, None, t, 64, 8, 4)
