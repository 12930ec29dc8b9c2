"""The port's resident cycle against the JAX one-kernel cycle, bit for bit.

``cycle_chunk_plain`` (the make_cycle contract on one popped chunk) is held
to the Pallas megakernel ``megakernel._lb1_cycle_call`` in interpret mode at
M=64: the live survivor rows and their limit1+1, tree_inc, sol_inc and the
folded incumbent, with a finite and an INF incumbent and with a partial
chunk (``valid`` not all true). ``cycle_lb1_plain`` — the in-pool cycle, the
plain version of the CUDA cycle kernel — is held to the chunk form and to
the loop condition. Tolerance 0: everything is integer. The CUDA cycle is
compared with ``cycle_lb1_plain`` on the card in `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.ops import megakernel as MK
from tpu_tree_search.problems import PFSPProblem
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.ops import cycle as C
from tpu_tree_search_torch.ops.pfsp_device import lb1_chunk
from tpu_tree_search_torch.problems import PFSPProblem as TorchPFSP

INF = 2**31 - 1
CPU = torch.device("cpu")


def _problems(jobs, machines):
    if (jobs, machines) == (20, 10):
        return PFSPProblem(inst=14, lb="lb1", ub=1), TorchPFSP(inst=14, lb="lb1", ub=1)
    ptm = taillard.reduced_instance(14, jobs=jobs, machines=machines)
    return (PFSPProblem(lb="lb1", ub=0, p_times=ptm),
            TorchPFSP(lb="lb1", ub=0, p_times=ptm))


def _chunk(rng, n, M, deep_share=0.25):
    """Random partial permutations; a share of them one swap from complete
    (limit1 = n-2) so that their children are leaves."""
    prmu = np.stack([rng.permutation(n) for _ in range(M)]).astype(np.int32)
    limit1 = rng.integers(-1, n - 2, M).astype(np.int32)
    deep = rng.random(M) < deep_share
    limit1[deep] = n - 2
    return prmu, limit1


def _jax_cycle(jprob, prmu, limit1, valid, best):
    t = jprob.device_tables()
    n, m, M = jprob.jobs, jprob.machines, prmu.shape[0]
    call = MK._lb1_cycle_call(n, m, M, False, True)
    rows, caux, scal = call(
        jnp.asarray(prmu), jnp.asarray(limit1)[:, None],
        jnp.asarray(valid.astype(np.int32))[:, None],
        jnp.asarray([best], dtype=jnp.int32),
        t.ptm_t, t.min_heads[None, :], t.min_tails[None, :])
    scal = np.asarray(scal)[0]
    return np.asarray(rows), np.asarray(caux)[:, 0], int(scal[0]), int(scal[1]), int(scal[2])


def _median_leaf_bound(tprob, prmu, limit1):
    """A finite incumbent that half the chunk's leaves improve on (the
    improved one then prunes part of the interior children)."""
    n = prmu.shape[1]
    lb = lb1_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                   tprob.device_tables(CPU)).numpy()
    leaf = (np.arange(n)[None, :] > limit1[:, None]) & (limit1[:, None] == n - 2)
    return int(np.median(lb[leaf]))


@pytest.mark.parametrize("jobs,machines,finite,partial", [
    (10, 5, False, False),
    (10, 5, True, True),
    (10, 5, False, True),
    (20, 10, True, True),
    (20, 10, False, False),
])
def test_plain_chunk_cycle_matches_pallas_megakernel(jobs, machines, finite, partial):
    jprob, tprob = _problems(jobs, machines)
    M = 64
    rng = np.random.default_rng(jobs + machines + int(partial))
    prmu, limit1 = _chunk(rng, jobs, M)
    best = _median_leaf_bound(tprob, prmu, limit1) if finite else INF
    valid = np.ones(M, dtype=bool)
    if partial:
        valid[:] = False
        valid[7:50] = True
    rows_j, caux_j, tree_j, sol_j, best_j = _jax_cycle(jprob, prmu, limit1, valid, best)
    rows, caux, tree, sol, best_t = C.cycle_chunk_plain(
        torch.from_numpy(prmu).to(torch.int8), torch.from_numpy(limit1),
        torch.from_numpy(valid), torch.tensor(best, dtype=torch.int32),
        tprob.device_tables(CPU))
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


@pytest.mark.parametrize("size", [40, 150])  # partial chunk / full chunk
def test_plain_pool_cycle_is_pop_chunk_push(size):
    _, tprob = _problems(10, 5)
    t = tprob.device_tables(CPU)
    n, M, m, K = 10, 64, 8, 4
    C_rows = size + M * n
    rng = np.random.default_rng(size)
    pool_vals, pool_aux = _pool(rng, n, size, C_rows)
    before_vals, before_aux = pool_vals.clone(), pool_aux.clone()
    st = C.new_state(size, 600, CPU)
    C.cycle_lb1_plain(pool_vals, pool_aux, st, t, M, m, K)
    cnt = min(size, M)
    start = size - cnt
    rows, caux, tree, sol, best = C.cycle_chunk_plain(
        before_vals[start:size], before_aux[start:size],
        torch.ones(cnt, dtype=torch.bool), torch.tensor(600, dtype=torch.int32), t)
    tree = int(tree)
    assert st[:C.ST_CYCLES + 1].tolist() == [start + tree, int(best), tree, int(sol), 1]
    assert st[C.ST_ACTIVE] == 1 and st[C.ST_CNT] == cnt and st[C.ST_BASE] == start
    assert torch.equal(pool_vals[:start], before_vals[:start])
    assert torch.equal(pool_vals[start:start + tree].int(), rows[:tree])
    assert torch.equal(pool_aux[start:start + tree].int(), caux[:tree])


@pytest.mark.parametrize("case", ["below_m", "no_headroom", "cycles_spent"])
def test_plain_pool_cycle_is_noop_when_condition_false(case):
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
    C.cycle_lb1_plain(pool_vals, pool_aux, st, t, M, m, K)
    assert torch.equal(pool_vals, before[0]) and torch.equal(pool_aux, before[1])
    assert st[C.ST_ACTIVE] == 0
    st[C.ST_ACTIVE] = before[2][C.ST_ACTIVE]
    assert torch.equal(st, before[2])


def test_cycle_router_takes_plain_on_cpu_and_kernel_refuses_cpu():
    _, tprob = _problems(10, 5)
    t = tprob.device_tables(CPU)
    pool_vals, pool_aux = _pool(np.random.default_rng(2), 10, 50, 50 + 640)
    st = C.new_state(50, INF, CPU)
    C.cycle_lb1(pool_vals, pool_aux, st, None, t, 64, 8, 4)
    assert int(st[C.ST_CYCLES]) == 1
    with pytest.raises(ValueError):
        C.cycle_lb1_cuda(pool_vals, pool_aux, st, None, t, 64, 8, 4)



@pytest.mark.parametrize("n,words", [(1, 1), (20, 1), (31, 1), (32, 1), (33, 2),
                                     (50, 2), (64, 2), (100, 4)])
def test_mask_words_hold_one_bit_a_slot(n, words):
    assert C.mask_words(n) == words
    assert C.pfsp_plane_words(7, n) == 7 * n + 7 * words


@pytest.mark.parametrize("nbytes,want", [(0, 16), (1, 32), (15, 32), (16, 32),
                                         (17, 48), (640, 656), (480, 496)])
def test_stash_block_bytes_leave_room_for_any_phase(nbytes, want):
    # A block's rows start at their pool address's phase mod 16 (0..15)
    # inside a 16-aligned region.
    got = C.stash_block_bytes(nbytes)
    assert got == want and got % 16 == 0 and got >= nbytes + 15


@pytest.mark.parametrize("M,n,itemsize", [(1024, 20, 1), (49152, 20, 1),
                                          (1000, 50, 4), (50000, 15, 1), (333, 32, 1)])
def test_cycle_scratch_sizes_and_fit(M, n, itemsize):
    pb = 32
    nblk = -(-M // pb)
    words = C.pfsp_plane_words(M, n)
    sz = C.scratch_sizes(M, n, itemsize, pb, words)
    assert sz == dict(chunk_vals=nblk * C.stash_block_bytes(pb * n * itemsize),
                      chunk_aux=M, plane=words, blkcnt=nblk)
    aux = torch.int8 if itemsize == 1 else torch.int32
    s = C.CycleScratch.make(M, n, itemsize, aux, words, pb, CPU)
    assert s.chunk_vals.dtype == torch.uint8 and s.plane.dtype == torch.int32
    assert s.fits(M, n, itemsize, aux, words, pb)
    assert s.fits(M, n, itemsize, aux, words, pb)  # the remembered check
    assert not s.fits(M + pb, n, itemsize, aux, words, pb)
    assert not s.fits(M, n, itemsize, torch.int16, words, pb)
    assert not s.fits(M, n + 1, itemsize, aux, C.pfsp_plane_words(M, n + 1), pb)


def test_new_state_zeroes_all_but_size_and_best():
    st = C.new_state(5, 9, CPU)
    assert st.shape == (C.ST_LEN,) and st.dtype == torch.int32
    assert (int(st[C.ST_SIZE]), int(st[C.ST_BEST])) == (5, 9)
    assert not st[C.ST_TREE:].any()
