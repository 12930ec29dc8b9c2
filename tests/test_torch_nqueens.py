"""The port's N-Queens problem and safety labels against the JAX package.

``labels_chunk`` (the plain version of the labels kernel) is held to the JAX
jnp core ``nqueens_device.make_core(N, g)`` and to the Pallas kernel
``pallas_kernels.nqueens_labels`` in interpret mode, on the whole (B, N)
plane (both packages write 0 on the slots k < depth). The port's
``NQueensProblem`` is held to the JAX one: fields, root, ``decompose`` and
``generate_children`` on random nodes. Tolerance 0: everything is integer.
Inputs are made with numpy from a seed and handed to both packages. The
kernel itself is compared with ``labels_chunk`` on the card in
`tests/test_torch_cuda.py`; here a numpy model of its packed compare
(``_packed_labels_model``, in the kernel's order and word arithmetic) is
held to ``labels_chunk`` and to the Pallas kernel in interpret mode.
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


# The kernel's tile (csrc/nqueens_labels.cu TTS_NQL_PARENTS) and 32-bit
# word arithmetic.
NQL_PARENTS = 128
M32 = 0xFFFFFFFF


def _nql_words(N):
    """Packed words of queens a parent (the kernel's NW template)."""
    return 2 if N <= 8 else 4 if N <= 16 else 6 if N <= 24 else 8


def _scalar_label(row, d, k, g):
    """`nq_label` of csrc/nqueens_common.cuh (the wide parents' check)."""
    safe = 1
    for _ in range(g):
        v = int(row[k])
        safe &= all(int(row[i]) not in (v - (d - i), v + (d - i))
                    for i in range(d))
    return safe


def _packed_labels_model(board, depth, N, g, phase=0, fill=0xAB):
    """Kernel 3 in numpy, step by step: each tile of NQL_PARENTS rows staged
    at ``phase`` (the board view's address mod 16) in a buffer of ``fill``
    bytes; each parent's words read as two aligned 32-bit words and a
    funnel shift, its u and w bytes packed (0x7F for unplaced queens and
    the bytes past N), its open slots k >= depth labelled by the XOR and
    zero-byte test (or the scalar check when a byte of the row is 32 or
    more); the other slots 0."""
    B = board.shape[0]
    NW = _nql_words(N)
    out = np.zeros((B, N), dtype=np.uint8)
    for b0 in range(0, B, NQL_PARENTS):
        rows = min(NQL_PARENTS, B - b0)
        stage = np.full(NQL_PARENTS * 4 * NW + 32, fill, dtype=np.uint8)
        stage[phase:phase + rows * N] = board[b0:b0 + rows].ravel()
        w32 = stage.view("<u4")
        for t in range(rows):
            off = phase + t * N
            a, sh = off // 4, (off % 4) * 8
            d = int(depth[b0 + t])
            dd = min(max(d, 0), N)
            x, seen, words = int(w32[a]), 0, []
            for j in range(NW):
                y = int(w32[a + j + 1])
                bw = ((y << 32 | x) >> sh) & M32
                x = y
                in_row = min(max(N - 4 * j, 0), 4)
                placed = min(max(dd - 4 * j, 0), 4)
                pm = (1 << 8 * placed) - 1
                seen |= bw & ((1 << 8 * in_row) - 1)
                dist = ((dd - 4 * j) * 0x01010101 - 0x03020100) & M32
                none = 0x7F7F7F7F & ~pm & M32
                words.append(((((bw + dist) & M32) & pm) | none,
                              (((bw + 0x40404040 - dist) & M32) & pm) | none))
            wide = (seen & 0xE0E0E0E0) != 0
            row = board[b0 + t]
            for k in range(max(d, 0), N):
                if wide:
                    out[b0 + t, k] = _scalar_label(row, d, k, g)
                    continue
                safe = 1
                for _ in range(g):
                    V = int(row[k]) * 0x01010101
                    V2 = V ^ 0x40404040
                    acc = M32
                    for u, w in words:
                        acc &= (((u ^ V) + 0x7F7F7F7F) & M32) & \
                            (((w ^ V2) + 0x7F7F7F7F) & M32)
                    safe &= (acc & 0x80808080) == 0x80808080
                out[b0 + t, k] = safe
    return out


def test_unplaced_byte_matches_no_candidate():
    # 0x7F, the byte of an unplaced queen, equals no candidate v in [0, 32)
    # nor v + 64, and every XOR stays below 0x80 (the zero-byte test's
    # condition), as do those of placed queens' u in [1, 63], w in [32, 95].
    for v in range(32):
        assert 0 < 0x7F ^ v < 0x80 and 0 < 0x7F ^ (v + 64) < 0x80
        assert all(u ^ v < 0x80 for u in range(1, 64))
        assert all(w ^ (v + 64) < 0x80 for w in range(32, 96))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("N", [4, 13, 16, 17, 32])
def test_packed_label_model_matches_plain_and_pallas(N, g):
    # Two tiles and a partial one, every depth from 0 to N (a share at 0
    # and at N), each phase of the board view mod 16 over the cases.
    rng = np.random.default_rng(N * 7 + g)
    B = 2 * NQL_PARENTS + 37
    board, depth = _nodes(rng, N, B)
    depth[rng.random(B) < 0.1] = 0
    depth[:N + 1] = np.arange(N + 1)
    want = tnq.labels_chunk(torch.from_numpy(board), torch.from_numpy(depth),
                            N, g).numpy()
    for phase in (0, 3, 9, 15)[:2 if N > 16 else 4]:
        got = _packed_labels_model(board, depth, N, g, phase)
        assert np.array_equal(got, want), phase
    jax_want = np.asarray(pallas_kernels.nqueens_labels(
        jnp.asarray(board), jnp.asarray(depth), N, g, interpret=True))
    assert np.array_equal(want, jax_want)
    assert want.any() and (want == 0).any()


def test_packed_label_model_takes_any_byte():
    # Rows with bytes of 32 or more (no board of the search) take the scalar
    # check; depths below 0 and past N label every slot, resp. none. The
    # staging fill differs from any row byte, so no byte past N is read as
    # a queen.
    rng = np.random.default_rng(33)
    N, B = 15, NQL_PARENTS + 5
    board = rng.integers(0, 256, (B, N)).astype(np.uint8)
    board[::2] = np.stack([rng.permutation(N) for _ in range(B)])[::2]
    depth = rng.integers(-3, N + 3, B).astype(np.int32)
    want = tnq.labels_chunk(torch.from_numpy(board), torch.from_numpy(depth),
                            N, 2).numpy()
    for fill in (0x00, 0x7F, 0xFF):
        assert np.array_equal(_packed_labels_model(board, depth, N, 2, 5, fill),
                              want)
    inside = (depth >= 0) & (depth <= N)
    jax_want = np.asarray(pallas_kernels.nqueens_labels(
        jnp.asarray(board[inside]), jnp.asarray(depth[inside]), N, 2,
        interpret=True))
    assert np.array_equal(want[inside], jax_want)


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


@pytest.mark.parametrize("N", [33, 40, 64])
def test_plain_labels_match_jax_on_wide_boards(N):
    # Past 32 queens: the kernel's per-slot scalar check (its wide path) has
    # the plain version as its oracle; both JAX forms agree with it.
    board, depth = _nodes(np.random.default_rng(N), N, 64)
    got = tnq.labels_chunk(torch.from_numpy(board), torch.from_numpy(depth),
                           N, 1).numpy()
    want = np.asarray(jnq.make_core(N, 1)(jnp.asarray(board),
                                          jnp.asarray(depth)))
    assert np.array_equal(got, want)
    pallas = np.asarray(pallas_kernels.nqueens_labels(
        jnp.asarray(board), jnp.asarray(depth), N, 1, interpret=True))
    assert np.array_equal(got, pallas)
    assert got.any() and (got == 0).any()
    # The scalar check of csrc/nqueens_common.cuh `nq_label`, slot by slot.
    model = np.zeros_like(got)
    for b in range(board.shape[0]):
        d = int(depth[b])
        for k in range(d, N):
            v = int(board[b, k])
            model[b, k] = all(int(board[b, i]) not in (v - (d - i), v + (d - i))
                              for i in range(d))
    assert np.array_equal(model, got)


def test_problem_refuses_boards_past_uint8():
    assert NQueensProblem(256).N == 256
    with pytest.raises(ValueError, match="uint8"):
        NQueensProblem(257)
    assert nqueens_kernel.MAX_N == 256
