"""The port's N-Queens problem and safety labels against the JAX package.

``labels_chunk`` (the plain version of the labels kernel) is held to the JAX
jnp core ``nqueens_device.make_core(N, g)`` and to the Pallas kernel
``pallas_kernels.nqueens_labels`` in interpret mode, on the whole (B, N)
plane (both packages write 0 on the slots k < depth). The port's
``NQueensProblem`` is held to the JAX one: fields, root, ``decompose`` and
``generate_children`` on random nodes. Tolerance 0: everything is integer.
Inputs are made with numpy from a seed and handed to both packages. The
kernel itself is compared with ``labels_chunk`` on the card in
`tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.ops import nqueens_device as jnq
from tpu_tree_search.ops import pallas_kernels
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search_torch.ops import nqueens_device as tnq
from tpu_tree_search_torch.ops import nqueens_kernel
from tpu_tree_search_torch.problems import NQueensProblem


def _nodes(rng, N, B, full_share=0.2):
    """Seeded random permutation boards, depth uniform in 0..N with a share
    at N (popped solutions)."""
    board = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.uint8)
    depth = rng.integers(0, N + 1, B).astype(np.int32)
    depth[rng.random(B) < full_share] = N
    return board, depth


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("N", [4, 8, 15])
def test_plain_labels_match_jnp_core(N, g):
    board, depth = _nodes(np.random.default_rng(N * 10 + g), N, 200)
    want = np.asarray(jnq.make_core(N, g)(jnp.asarray(board), jnp.asarray(depth)))
    got = tnq.labels_chunk(torch.from_numpy(board), torch.from_numpy(depth), N, g)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert want.any()  # some safe slots, so the comparison has teeth


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("N", [4, 8, 15])
def test_plain_labels_match_pallas_kernel_interpret(N, g):
    board, depth = _nodes(np.random.default_rng(N * 100 + g), N, 96)
    want = np.asarray(pallas_kernels.nqueens_labels(
        jnp.asarray(board), jnp.asarray(depth), N, g, interpret=True))
    got = tnq.labels_chunk(torch.from_numpy(board), torch.from_numpy(depth), N, g)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_labels_route_cpu_to_plain_in_pool_dtype(dtype):
    board, depth = _nodes(np.random.default_rng(5), 12, 64)
    ref = tnq.labels_chunk(torch.from_numpy(board), torch.from_numpy(depth), 12)
    got = tnq.nqueens_labels(torch.from_numpy(board),
                             torch.from_numpy(depth).to(dtype), 12)
    assert torch.equal(got, ref)
    assert nqueens_kernel.plain is tnq.labels_chunk


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        nqueens_kernel.nqueens_labels_cuda(torch.zeros((4, 8), dtype=torch.uint8),
                                           torch.zeros(4, dtype=torch.int8), 8)


def test_problem_fields_and_root_match_jax():
    jp, tp = JaxNQueens(N=9, g=2), NQueensProblem(N=9, g=2)
    assert (tp.N, tp.g, tp.child_slots) == (jp.N, jp.g, jp.child_slots)
    assert tp.field_specs() == jp.field_specs()
    assert tp.node_fields() == jp.node_fields()
    jr, tr = jp.root(), tp.root()
    assert set(jr) == set(tr)
    for k in jr:
        assert tr[k].dtype == jr[k].dtype and np.array_equal(tr[k], jr[k])
    with pytest.raises(ValueError):
        NQueensProblem(N=0)


def _batch(problem, board, depth):
    fields = problem.node_fields()
    return {"board": board.astype(fields["board"][1]),
            "depth": depth.astype(fields["depth"][1])}


@pytest.mark.parametrize("N", [6, 11])
def test_decompose_matches_jax(N):
    jp, tp = JaxNQueens(N=N), NQueensProblem(N=N)
    board, depth = _nodes(np.random.default_rng(N), N, 60)
    for b in range(board.shape[0]):
        node = {"board": board[b].copy(), "depth": np.int16(depth[b])}
        want = jp.decompose(dict(node), 0)
        got = tp.decompose(dict(node), 0)
        assert (got.tree_inc, got.sol_inc, got.best) == (
            want.tree_inc, want.sol_inc, want.best)
        for k in want.children:
            assert np.array_equal(got.children[k], want.children[k])
            assert got.children[k].dtype == want.children[k].dtype


@pytest.mark.parametrize("N", [6, 11])
def test_generate_children_matches_jax(N):
    jp, tp = JaxNQueens(N=N), NQueensProblem(N=N)
    board, depth = _nodes(np.random.default_rng(N + 1), N, 80)
    count = 70  # a batch with spare rows past count
    labels = tnq.labels_chunk(torch.from_numpy(board), torch.from_numpy(depth),
                              N).numpy()
    want = jp.generate_children(_batch(jp, board, depth), count, labels, 0)
    got = tp.generate_children(_batch(tp, board, depth), count, labels, 0)
    assert (got.tree_inc, got.sol_inc) == (want.tree_inc, want.sol_inc)
    assert got.tree_inc > 0 and got.sol_inc > 0
    for k in want.children:
        assert np.array_equal(got.children[k], want.children[k])
