"""The port's N-Queens resident cycle against the JAX one-kernel cycle.

``cycle_nqueens_chunk_plain`` (the make_cycle contract on one popped chunk)
is held to the Pallas megakernel ``megakernel._nqueens_cycle_call`` in
interpret mode at M=64 and N in {8, 12}, with a partial ``valid`` and a
share of parents at depth N: the live survivor rows and their depth + 1,
tree_inc, sol_inc and the passed-through incumbent. ``cycle_nqueens_plain``
— the in-pool cycle, the plain version of the CUDA cycle kernel — is held to
the chunk form and to the loop condition. Tolerance 0: everything is
integer. The CUDA cycle is compared with ``cycle_nqueens_plain`` on the card
in `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.ops import megakernel as MK
from tpu_tree_search_torch.ops import cycle as C
from tpu_tree_search_torch.ops import cycle_nqueens as CN

INF = 2**31 - 1


def _chunk(rng, N, M, full_share=0.2):
    board = np.stack([rng.permutation(N) for _ in range(M)]).astype(np.uint8)
    depth = rng.integers(0, N, M).astype(np.int32)
    depth[rng.random(M) < full_share] = N
    return board, depth


def _jax_cycle(board, depth, valid, best, N, g):
    M = board.shape[0]
    call = MK._nqueens_cycle_call(N, g, M, True)
    rows, caux, scal = call(
        jnp.asarray(board.astype(np.int32)), jnp.asarray(depth)[:, None],
        jnp.asarray(valid.astype(np.int32))[:, None],
        jnp.asarray([best], dtype=jnp.int32))
    scal = np.asarray(scal)[0]
    return (np.asarray(rows), np.asarray(caux)[:, 0], int(scal[0]),
            int(scal[1]), int(scal[2]))


@pytest.mark.parametrize("N,g,partial", [
    (8, 1, False),
    (8, 2, True),
    (12, 1, True),
    (12, 1, False),
])
def test_plain_chunk_cycle_matches_pallas_megakernel(N, g, partial):
    M = 64
    rng = np.random.default_rng(N * 10 + g + int(partial))
    board, depth = _chunk(rng, N, M)
    valid = np.ones(M, dtype=bool)
    if partial:
        valid[:] = False
        valid[9:53] = True
    rows_j, caux_j, tree_j, sol_j, best_j = _jax_cycle(board, depth, valid,
                                                       INF, N, g)
    rows, caux, tree, sol, best = CN.cycle_nqueens_chunk_plain(
        torch.from_numpy(board), torch.from_numpy(depth).to(torch.int8),
        torch.from_numpy(valid), torch.tensor(INF, dtype=torch.int32), N, g)
    assert (int(tree), int(sol), int(best)) == (tree_j, sol_j, best_j)
    assert tree_j > 0 and sol_j > 0 and best_j == INF
    assert np.array_equal(rows[:tree_j].numpy(), rows_j[:tree_j])
    assert np.array_equal(caux[:tree_j].numpy(), caux_j[:tree_j])


def _pool(rng, N, size, C_rows):
    board, depth = _chunk(rng, N, size)
    pool_vals = torch.zeros((C_rows, N), dtype=torch.uint8)
    pool_aux = torch.zeros(C_rows, dtype=torch.int8)
    pool_vals[:size] = torch.from_numpy(board)
    pool_aux[:size] = torch.from_numpy(depth).to(torch.int8)
    return pool_vals, pool_aux


@pytest.mark.parametrize("size", [40, 150])  # partial chunk / full chunk
def test_plain_pool_cycle_is_pop_chunk_push(size):
    N, g, M, m, K = 10, 1, 64, 8, 4
    C_rows = size + M * N
    pool_vals, pool_aux = _pool(np.random.default_rng(size), N, size, C_rows)
    before_vals, before_aux = pool_vals.clone(), pool_aux.clone()
    st = C.new_state(size, INF, torch.device("cpu"))
    CN.cycle_nqueens_plain(pool_vals, pool_aux, st, N, g, M, m, K)
    cnt = min(size, M)
    start = size - cnt
    rows, caux, tree, sol, best = CN.cycle_nqueens_chunk_plain(
        before_vals[start:size], before_aux[start:size],
        torch.ones(cnt, dtype=torch.bool), torch.tensor(INF, dtype=torch.int32),
        N, g)
    tree = int(tree)
    assert tree > 0 and int(sol) > 0
    assert st[:C.ST_CYCLES + 1].tolist() == [start + tree, INF, tree, int(sol), 1]
    assert st[C.ST_ACTIVE] == 1 and st[C.ST_CNT] == cnt and st[C.ST_BASE] == start
    assert torch.equal(pool_vals[:start], before_vals[:start])
    assert torch.equal(pool_vals[start:start + tree].int(), rows[:tree])
    assert torch.equal(pool_aux[start:start + tree].int(), caux[:tree])


@pytest.mark.parametrize("case", ["below_m", "no_headroom", "cycles_spent"])
def test_plain_pool_cycle_is_noop_when_condition_false(case):
    N, g, M, m, K = 10, 1, 64, 8, 4
    size = {"below_m": m - 1, "no_headroom": 100, "cycles_spent": 100}[case]
    C_rows = 100 + M * N - (1 if case == "no_headroom" else 0)
    pool_vals, pool_aux = _pool(np.random.default_rng(1), N, size, C_rows)
    st = C.new_state(size, INF, torch.device("cpu"))
    if case == "cycles_spent":
        st[C.ST_CYCLES] = K
    before = (pool_vals.clone(), pool_aux.clone(), st.clone())
    CN.cycle_nqueens_plain(pool_vals, pool_aux, st, N, g, M, m, K)
    assert torch.equal(pool_vals, before[0]) and torch.equal(pool_aux, before[1])
    assert st[C.ST_ACTIVE] == 0
    st[C.ST_ACTIVE] = before[2][C.ST_ACTIVE]
    assert torch.equal(st, before[2])


def test_cycle_router_takes_plain_on_cpu_and_kernel_refuses_cpu():
    pool_vals, pool_aux = _pool(np.random.default_rng(2), 10, 50, 50 + 640)
    st = C.new_state(50, INF, torch.device("cpu"))
    CN.cycle_nqueens(pool_vals, pool_aux, st, None, 10, 1, 64, 8, 4)
    assert int(st[C.ST_CYCLES]) == 1
    with pytest.raises(ValueError):
        CN.cycle_nqueens_cuda(pool_vals, pool_aux, st, None, 10, 1, 64, 8, 4)
