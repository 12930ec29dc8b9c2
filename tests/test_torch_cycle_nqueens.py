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


def _mask_words_model(labels, valid, depth, N):
    """Kernel 4's labels launch on the W-word keep mask: bit k % 32 of word
    k // 32 of a parent is slot k kept (label, valid, depth < N)."""
    W = CN.nq_mask_words(N)
    M = labels.shape[0]
    mask = np.zeros((M, W), dtype=np.uint64)
    for p in range(M):
        if not valid[p] or depth[p] >= N:
            continue
        for k in range(N):
            if labels[p, k]:
                mask[p, k >> 5] |= np.uint64(1) << np.uint64(k & 31)
    return mask


def _emit_model(board, depth, mask, N):
    """Kernel 4's emit from the W-word masks: the offset of a parent is the
    popcount of its predecessors' words, the rank of slot k its parent's
    offset plus the set bits below k in word k // 32 and every bit of the
    words before it (cycle_common.cuh `emit_block_children`)."""
    pop = [sum(bin(int(w)).count("1") for w in mask[p]) for p in range(len(mask))]
    off = np.concatenate([[0], np.cumsum(pop)]).astype(int)
    rows = np.zeros((off[-1], N), dtype=np.int32)
    caux = np.zeros(off[-1], dtype=np.int32)
    for p in range(len(mask)):
        for k in range(N):
            w, bit = k >> 5, k & 31
            if not (int(mask[p, w]) >> bit) & 1:
                continue
            rank = off[p] + bin(int(mask[p, w]) & ((1 << bit) - 1)).count("1")
            rank += sum(bin(int(mask[p, j])).count("1") for j in range(w))
            d = int(depth[p])
            child = board[p].astype(np.int32).copy()
            child[d], child[k] = board[p, k], board[p, d]
            rows[rank] = child
            caux[rank] = d + 1
    return rows, caux


@pytest.mark.parametrize("N", [33, 40, 64])
def test_wide_chunk_cycle_matches_jax_and_mask_model(N):
    # Past 32 queens the kernel keeps W = 2 mask words a parent; the plain
    # chunk cycle equals the JAX resident program's one-cycle step, and a
    # numpy model of the W-word keep mask and its emit equals both.
    from tpu_tree_search.engine.resident import _make_program
    from tpu_tree_search.problems import NQueensProblem as JaxNQueens
    from tpu_tree_search_torch.engine.resident import (NQueensResident,
                                                       pool_from_numpy)
    from tpu_tree_search_torch.ops.nqueens_device import labels_chunk
    from tpu_tree_search_torch.problems import NQueensProblem

    M = 32
    rng = np.random.default_rng(N)
    board, depth = _chunk(rng, N, M)
    depth = np.minimum(depth, 6)  # shallow parents keep many slots
    depth[::7] = N
    valid = np.ones(M, dtype=bool)
    valid[:5] = False
    rows, caux, tree, sol, best = CN.cycle_nqueens_chunk_plain(
        torch.from_numpy(board), torch.from_numpy(depth),
        torch.from_numpy(valid), torch.tensor(INF, dtype=torch.int32), N, 1)
    labels = labels_chunk(torch.from_numpy(board), torch.from_numpy(depth),
                          N, 1).numpy()
    mask = _mask_words_model(labels, valid, depth, N)
    assert CN.nq_mask_words(N) == (2 if N <= 64 else 4) and (mask[:, 1] > 0).any()
    m_rows, m_caux = _emit_model(board, depth, mask, N)
    t = int(tree)
    assert t == len(m_rows) and int(sol) == int((valid & (depth == N)).sum())
    assert np.array_equal(rows[:t].numpy(), m_rows)
    assert np.array_equal(caux[:t].numpy(), m_caux)

    # The whole cycle in a pool: one dispatch of one cycle against JAX's.
    capacity = 4 * M * N
    jprog = _make_program(JaxNQueens(N), 1, M, 1, capacity, None)
    fr = {"board": board[valid], "depth": depth[valid].astype(np.int16)}
    out = jprog.step(jprog.init_state(fr, INF))
    j_vals, j_aux, j_size = (np.asarray(x) for x in out[:3])
    prog = NQueensResident(NQueensProblem(N), 1, M, 1, capacity, "cpu")
    state = pool_from_numpy(fr["board"], fr["depth"], int(valid.sum()), INF,
                            capacity, "cpu", prog.vals_dtype, prog.aux_dtype)
    prog.step(state)
    size = int(j_size)
    assert prog.read_scalars(state)[:4] == (int(out[4]), int(out[5]), 1, size)
    assert np.array_equal(state.pool_vals[:size].numpy(), j_vals[:size])
    assert np.array_equal(state.pool_aux[:size].numpy().astype(np.int32),
                          j_aux[:size].astype(np.int32))
