"""The port's CUDA kernels on the card (``cuda`` marker; skipped without a GPU).

This file imports neither JAX nor the JAX package, so it runs on a machine
with the card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest pins JAX to the CPU.) Each kernel is
held to its plain PyTorch version on the same inputs with tolerance 0, and
the searches on the card to the counts of the JAX package's sequential tier
on a reduced PFSP instance (lb1, lb1_d and lb2 in its three forms, and the
streamed cycle) and to the N-Queens N=10 goldens.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.ops import cycle as C
from tpu_tree_search_torch.ops import cycle_nqueens as CN
from tpu_tree_search_torch.ops import (
    lb1_d_kernel,
    lb1_kernel,
    lb2_kernel,
    lb2_self_kernel,
    nqueens_kernel,
)
from tpu_tree_search_torch.ops import tiled as T
from tpu_tree_search_torch.ops.nqueens_device import labels_chunk
from tpu_tree_search_torch.ops.pfsp_device import lb1_chunk, lb2_chunk
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem
from tpu_tree_search_torch.problems.pfsp import taillard

INF = 2**31 - 1
# ta014's 10-job, 5-machine corner under its optimal incumbent 609: tree
# 2074, sol 90 (the JAX package's sequential_search under lb1 and under
# lb1_d, as pinned on the CPU by tests/test_torch_resident.py).
REDUCED = dict(tree=2074, sol=90, best=609)
# The same corner under lb2 (tests/test_torch_resident.py).
REDUCED_LB2 = dict(tree=326, sol=0, best=609)
# N-Queens N=10: the reference's counts (tests/test_torch_resident.py).
NQ10 = dict(tree=35538, sol=724)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _nodes(rng, n, B):
    prmu = np.argsort(rng.random((B, n)), axis=1).astype(np.int32)
    limit1 = rng.integers(-1, n - 2, B).astype(np.int32)
    limit1[rng.random(B) < 0.25] = n - 2
    return prmu, limit1


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("B", [1, 1000])
def test_lb1_kernel_matches_plain(cuda, dtype, B):
    t = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(cuda)
    prmu, limit1 = _nodes(np.random.default_rng(B), 20, B)
    p = torch.from_numpy(prmu).to(cuda).to(dtype)
    lim = torch.from_numpy(limit1).to(cuda).to(dtype)
    got = lb1_kernel.lb1_bounds_cuda(p, lim, t)
    want = lb1_kernel.plain(p, lim, t)
    torch.cuda.synchronize()
    op = torch.from_numpy(np.arange(20)[None, :] > limit1[:, None]).to(cuda)
    assert torch.equal(got[op], want[op])


@pytest.mark.parametrize("size,finite", [(40, False), (700, True), (700, False)])
def test_cycle_kernel_matches_plain(cuda, size, finite):
    t = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(cuda)
    n, M, m, K = 20, 256, 25, 4
    prmu, limit1 = _nodes(np.random.default_rng(size), n, size)
    best = 1500 if finite else INF
    cap = size + M * n
    pv = torch.zeros((cap, n), dtype=torch.int8, device=cuda)
    pa = torch.zeros(cap, dtype=torch.int8, device=cuda)
    pv[:size] = torch.from_numpy(prmu).to(cuda).to(torch.int8)
    pa[:size] = torch.from_numpy(limit1).to(cuda).to(torch.int8)
    pv2, pa2 = pv.clone(), pa.clone()
    st, st2 = C.new_state(size, best, cuda), C.new_state(size, best, cuda)
    scratch = C.cycle_scratch(M, n, torch.int8, cuda)
    for _ in range(3):
        C.cycle_lb1_cuda(pv, pa, st, scratch, t, M, m, K)
        C.cycle_lb1_plain(pv2, pa2, st2, t, M, m, K)
        torch.cuda.synchronize()
        assert torch.equal(st[:C.ST_BASE + 1], st2[:C.ST_BASE + 1])
        live = int(st[C.ST_SIZE])
        assert torch.equal(pv[:live], pv2[:live])
        assert torch.equal(pa[:live], pa2[:live])


# -- the fused cycles' edges: kernel 2's two-word masks, the top bit of the
# N-Queens mask, a last block of fewer parents, no-op cycles past the end ----


def _cycles_match(cuda_cycle, plain_cycle, pv, pa, st, cycles, sync=True):
    """``cycles`` cycles on the card and in plain PyTorch from one pool:
    equal live rows and st[0:9], and st[9:] still 0 (the cycle keeps no
    state past its pop), after each cycle (or, with ``sync`` False, after
    all of them, the card's enqueued back to back before any plain one
    runs). Returns the plain state."""
    pv2, pa2, st2 = pv.clone(), pa.clone(), st.clone()

    def same():
        torch.cuda.synchronize()
        assert torch.equal(st[:C.ST_BASE + 1], st2[:C.ST_BASE + 1])
        assert not st[C.ST_BASE + 1:].any()
        live = int(st[C.ST_SIZE])
        assert torch.equal(pv[:live], pv2[:live])
        assert torch.equal(pa[:live], pa2[:live])

    if sync:
        for _ in range(cycles):
            cuda_cycle(pv, pa, st)
            plain_cycle(pv2, pa2, st2)
            same()
        return st2
    for _ in range(cycles):
        cuda_cycle(pv, pa, st)
    for _ in range(cycles):
        plain_cycle(pv2, pa2, st2)
    same()
    return st2


@pytest.mark.parametrize("N,g,M", [(4, 1, 1000), (15, 4, 1000), (32, 1, 333)])
def test_nqueens_cycle_edges_match_plain(cuda, N, g, M):
    # M = 1000 and 333 leave a last block of fewer than 32 parents; N = 32
    # uses bit 31 of the mask word.
    m, K = 25, 8
    size = M + 77
    board, depth = _boards(np.random.default_rng(N * g + M), N, size, 0.05)
    cap = size + 4 * M * N
    pv = torch.zeros((cap, N), dtype=torch.uint8, device=cuda)
    pa = torch.zeros(cap, dtype=torch.int8, device=cuda)
    pv[:size] = torch.from_numpy(board).to(cuda)
    pa[:size] = torch.from_numpy(depth).to(cuda).to(torch.int8)
    scratch = CN.nqueens_scratch(M, N, cuda)
    st2 = _cycles_match(
        lambda *a: CN.cycle_nqueens_cuda(*a, scratch, N, g, M, m, K),
        lambda *a: CN.cycle_nqueens_plain(*a, N, g, M, m, K),
        pv, pa, C.new_state(size, INF, cuda), 3)
    assert int(st2[C.ST_TREE]) > 0


@pytest.mark.parametrize("inst,dtype,M", [(14, torch.int8, 1000),
                                          (51, torch.int32, 1000),
                                          (51, torch.int32, 96)])
@pytest.mark.parametrize("lb", ["lb1", "lb2"])
def test_pfsp_cycle_edges_match_plain(cuda, lb, inst, dtype, M):
    # ta051 has 50 jobs: two mask words a parent, an int32 pool.
    t = PFSPProblem(inst=inst, lb=lb, ub=1).device_tables(cuda)
    n, m, K = t.jobs, 25, 8
    size = M + 61
    prmu, limit1 = _nodes(np.random.default_rng(inst + M), n, size)
    cap = size + 4 * M * n
    pv = torch.zeros((cap, n), dtype=dtype, device=cuda)
    pa = torch.zeros(cap, dtype=dtype, device=cuda)
    pv[:size] = torch.from_numpy(prmu).to(cuda).to(dtype)
    pa[:size] = torch.from_numpy(limit1).to(cuda).to(dtype)
    scratch = C.cycle_scratch(M, n, dtype, cuda)
    cuda_cycle, plain_cycle = ((C.cycle_lb1_cuda, C.cycle_lb1_plain) if lb == "lb1"
                               else (C.cycle_lb2_cuda, C.cycle_lb2_plain))
    st2 = _cycles_match(
        lambda *a: cuda_cycle(*a, scratch, t, M, m, K),
        lambda *a: plain_cycle(*a, t, M, m, K),
        pv, pa, C.new_state(size, INF, cuda), 3)
    assert int(st2[C.ST_TREE]) > 0


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("problem", ["nqueens", "lb1", "lb2"])
def test_cycles_past_termination_are_exact_noops(cuda, problem, sync):
    # From one root: the search ends (size < m) or reaches K cycles well
    # before the 40 cycles enqueued; the rest must be no-ops that leave the
    # pool and st as they were.
    M, m, K, cycles = 64, 1, 30, 40
    if problem == "nqueens":
        N = 7
        pv = torch.zeros((M * N * 8, N), dtype=torch.uint8, device=cuda)
        pa = torch.zeros(M * N * 8, dtype=torch.int8, device=cuda)
        pv[0] = torch.arange(N, dtype=torch.uint8)
        scratch = CN.nqueens_scratch(M, N, cuda)
        cuda_cycle = lambda *a: CN.cycle_nqueens_cuda(*a, scratch, N, 1, M, m, K)  # noqa: E731
        plain_cycle = lambda *a: CN.cycle_nqueens_plain(*a, N, 1, M, m, K)  # noqa: E731
        best = INF
    else:
        ptm = taillard.reduced_instance(14, jobs=8, machines=5)
        t = PFSPProblem(lb=problem, ub=0, p_times=ptm).device_tables(cuda)
        n = 8
        pv = torch.zeros((M * n * 8, n), dtype=torch.int8, device=cuda)
        pa = torch.full((M * n * 8,), -1, dtype=torch.int8, device=cuda)
        pv[0] = torch.arange(n, dtype=torch.int8)
        scratch = C.cycle_scratch(M, n, torch.int8, cuda)
        cuda_fn, plain_fn = ((C.cycle_lb1_cuda, C.cycle_lb1_plain) if problem == "lb1"
                             else (C.cycle_lb2_cuda, C.cycle_lb2_plain))
        cuda_cycle = lambda *a: cuda_fn(*a, scratch, t, M, m, K)  # noqa: E731
        plain_cycle = lambda *a: plain_fn(*a, t, M, m, K)  # noqa: E731
        best = INF
    st2 = _cycles_match(cuda_cycle, plain_cycle, pv, pa, C.new_state(1, best, cuda),
                        cycles, sync=sync)
    assert int(st2[C.ST_ACTIVE]) == 0 and int(st2[C.ST_CYCLES]) < cycles


@pytest.mark.parametrize("chunk", ["partial", "full"])
def test_lb2_cycle_chunks_match_plain(cuda, chunk):
    t = PFSPProblem(inst=14, lb="lb2", ub=1).device_tables(cuda)
    n, M, m, K = 20, 2048, 25, 8
    size = M // 2 + 3 if chunk == "partial" else M + 517
    prmu, limit1 = _nodes(np.random.default_rng(size), n, size)
    cap = size + 4 * M * n
    pv = torch.zeros((cap, n), dtype=torch.int8, device=cuda)
    pa = torch.zeros(cap, dtype=torch.int8, device=cuda)
    pv[:size] = torch.from_numpy(prmu).to(cuda).to(torch.int8)
    pa[:size] = torch.from_numpy(limit1).to(cuda).to(torch.int8)
    scratch = C.cycle_scratch(M, n, torch.int8, cuda)
    _cycles_match(lambda *a: C.cycle_lb2_cuda(*a, scratch, t, M, m, K),
                  lambda *a: C.cycle_lb2_plain(*a, t, M, m, K),
                  pv, pa, C.new_state(size, 1500, cuda), 3)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("B", [1, 1000])
def test_lb1_d_kernel_matches_plain(cuda, dtype, B):
    t = PFSPProblem(inst=14, lb="lb1_d", ub=1).device_tables(cuda)
    prmu, limit1 = _nodes(np.random.default_rng(B + 7), 20, B)
    p = torch.from_numpy(prmu).to(cuda).to(dtype)
    lim = torch.from_numpy(limit1).to(cuda).to(dtype)
    got = lb1_d_kernel.lb1_d_bounds_cuda(p, lim, t)
    want = lb1_d_kernel.plain(p, lim, t)
    torch.cuda.synchronize()
    op = torch.from_numpy(np.arange(20)[None, :] > limit1[:, None]).to(cuda)
    assert torch.equal(got[op], want[op])


def _boards(rng, N, B, full_share=0.2):
    board = np.argsort(rng.random((B, N)), axis=1).astype(np.uint8)
    depth = rng.integers(0, N + 1, B).astype(np.int32)
    depth[rng.random(B) < full_share] = N
    return board, depth


# (N, g, B): every packed width (N <= 8, 16, 24, 32 take 2, 4, 6, 8 words a
# parent), g in {1, 2, 256} (the round loop), and B = 300,000, past the
# 128-parent tiles of one wave on 132 SMs at 16 blocks an SM (the looping
# grid).
_LABELS = [(8, 1, 1), (15, 3, 1000), (32, 1, 333), (4, 2, 1000),
           (13, 1, 300000), (16, 256, 3000), (17, 2, 1000), (32, 256, 1500),
           (32, 1, 300000)]


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("N,g,B", _LABELS)
def test_nqueens_labels_kernel_matches_plain(cuda, dtype, N, g, B):
    board, depth = _boards(np.random.default_rng(N + g), N, B)
    depth[:min(B, N + 1)] = np.arange(N + 1)[:B]  # depth 0 to N
    b = torch.from_numpy(board).to(cuda)
    d = torch.from_numpy(depth).to(cuda).to(dtype)
    got = nqueens_kernel.nqueens_labels_cuda(b, d, N, g)
    shape = nqueens_kernel.last_shape()
    want = nqueens_kernel.plain(b, d, N, g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert shape["parents"] in (4, 8, 16, 32, 64, 128)
    assert shape["tiles"] == -(-B // shape["parents"])
    assert shape["words"] * 4 >= N and shape["blocks"] <= shape["tiles"]
    if B == 300000:
        assert shape["tiles"] > shape["blocks"]  # the blocks loop over tiles


@pytest.mark.parametrize("B", [600, 5000])
@pytest.mark.parametrize("N", [13, 15, 32])
def test_nqueens_labels_kernel_reads_an_unaligned_view(cuda, N, B):
    # Rows 1: of a larger board (data_ptr not 16-aligned for N % 16 != 0),
    # a share of rows with bytes of 32 or more (the scalar check), and
    # depths below 0 and past N; B = 600 takes tiles of 8 or 4 parents (one
    # thread a slot), B = 5000 tiles of 32 (the item map).
    rng = np.random.default_rng(N + B)
    board, depth = _boards(rng, N, B + 1)
    wild = rng.random(B + 1) < 0.1
    board[wild] = rng.integers(0, 256, (int(wild.sum()), N))
    depth[rng.random(B + 1) < 0.05] = -2
    depth[rng.random(B + 1) < 0.05] = N + 3
    full = torch.from_numpy(board).to(cuda)
    b = full[1:]
    assert b.is_contiguous() and (b.data_ptr() % 16 != 0) == (N % 16 != 0)
    d = torch.from_numpy(depth[1:]).to(cuda).to(torch.int8)
    for g in (1, 2):
        got = nqueens_kernel.nqueens_labels_cuda(b, d, N, g)
        want = nqueens_kernel.plain(b, d, N, g)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("size", [40, 700])
def test_nqueens_cycle_kernel_matches_plain(cuda, size):
    N, g, M, m, K = 12, 1, 256, 25, 4
    board, depth = _boards(np.random.default_rng(size), N, size)
    cap = size + M * N * 3
    pv = torch.zeros((cap, N), dtype=torch.uint8, device=cuda)
    pa = torch.zeros(cap, dtype=torch.int8, device=cuda)
    pv[:size] = torch.from_numpy(board).to(cuda)
    pa[:size] = torch.from_numpy(depth).to(cuda).to(torch.int8)
    pv2, pa2 = pv.clone(), pa.clone()
    st, st2 = C.new_state(size, INF, cuda), C.new_state(size, INF, cuda)
    scratch = CN.nqueens_scratch(M, N, cuda)
    for _ in range(3):
        CN.cycle_nqueens_cuda(pv, pa, st, scratch, N, g, M, m, K)
        CN.cycle_nqueens_plain(pv2, pa2, st2, N, g, M, m, K)
        torch.cuda.synchronize()
        assert torch.equal(st[:C.ST_BASE + 1], st2[:C.ST_BASE + 1])
        live = int(st[C.ST_SIZE])
        assert torch.equal(pv[:live], pv2[:live])
        assert torch.equal(pa[:live], pa2[:live])


@pytest.mark.parametrize("fused", [True, False])
def test_nqueens_search_on_card_matches_goldens(cuda, fused):
    res = resident_search(NQueensProblem(10), m=25, M=1024, K=64, device=cuda,
                          fused=fused)
    assert (res.explored_tree, res.explored_sol) == (NQ10["tree"], NQ10["sol"])
    assert res.fused is fused


def test_lb1_d_search_on_card_matches_sequential_counts(cuda):
    ptm = taillard.reduced_instance(14, jobs=10, machines=5)
    res = resident_search(PFSPProblem(lb="lb1_d", ub=0, p_times=ptm), m=8,
                          M=256, K=64, initial_best=REDUCED["best"], device=cuda)
    assert (res.explored_tree, res.explored_sol, res.best) == (
        REDUCED["tree"], REDUCED["sol"], REDUCED["best"])
    assert res.fused is False


@pytest.mark.parametrize("fused", [True, False])
def test_search_on_card_matches_sequential_counts(cuda, fused):
    ptm = taillard.reduced_instance(14, jobs=10, machines=5)
    res = resident_search(PFSPProblem(lb="lb1", ub=0, p_times=ptm), m=8, M=256,
                          K=64, initial_best=REDUCED["best"], device=cuda,
                          fused=fused)
    assert (res.explored_tree, res.explored_sol, res.best) == (
        REDUCED["tree"], REDUCED["sol"], REDUCED["best"])


def test_kernel_wrappers_raise_on_bad_input(cuda):
    t = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(cuda)
    with pytest.raises(TypeError):
        lb1_kernel.lb1_bounds_cuda(torch.zeros((4, 20), dtype=torch.int16, device=cuda),
                                   torch.zeros(4, dtype=torch.int16, device=cuda), t)
    with pytest.raises(ValueError):
        lb1_kernel.lb1_bounds_cuda(torch.zeros((4, 19), dtype=torch.int8, device=cuda),
                                   torch.zeros(4, dtype=torch.int8, device=cuda), t)
    with pytest.raises(TypeError):
        lb1_d_kernel.lb1_d_bounds_cuda(
            torch.zeros((4, 20), dtype=torch.int16, device=cuda),
            torch.zeros(4, dtype=torch.int16, device=cuda), t)
    # N = 33 is taken (the wide boards' per-slot check); past what a uint8
    # board holds (N > 256) is not.
    board = torch.zeros((4, 33), dtype=torch.uint8, device=cuda)
    d = torch.zeros(4, dtype=torch.int8, device=cuda)
    assert torch.equal(nqueens_kernel.nqueens_labels_cuda(board, d, 33),
                       nqueens_kernel.plain(board, d, 33))
    with pytest.raises(ValueError):  # N > 256
        nqueens_kernel.nqueens_labels_cuda(
            torch.zeros((4, 257), dtype=torch.uint8, device=cuda), d, 257)
    with pytest.raises(TypeError):  # an int16 depth is no pool type
        nqueens_kernel.nqueens_labels_cuda(
            board[:, :8].contiguous(), torch.zeros(4, dtype=torch.int16, device=cuda), 8)


# -- lb2: kernels 6, 7 and 8 ---------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("inst,B", [(14, 1), (14, 1000), (21, 1000), (51, 64),
                                    (81, 16)])
def test_lb2_kernel_matches_plain(cuda, dtype, inst, B):
    # ta021 has P = 190 pairs of 20 machines; ta051's 50 jobs take the
    # tables past 48 KB of shared memory a block (the opt-in launch), and
    # ta081's 100 jobs are the most the lb2 kernels take.
    t = PFSPProblem(inst=inst, lb="lb2", ub=1).device_tables(cuda)
    n = t.jobs
    prmu, limit1 = _nodes(np.random.default_rng(inst + B), n, B)
    p = torch.from_numpy(prmu).to(cuda).to(dtype)
    lim = torch.from_numpy(limit1).to(cuda).to(dtype)
    got = lb2_kernel.lb2_bounds_cuda(p, lim, t)
    want = lb2_kernel.plain(p, lim, t)
    torch.cuda.synchronize()
    op = torch.from_numpy(np.arange(n)[None, :] > limit1[:, None]).to(cuda)
    assert torch.equal(got[op], want[op])


# Kernel 7's cases: (instance, R, n_active). ta014 at n_active 0 to past R
# (one row, a part of a warp, a warp and one, the staged search's first
# launch, all), ta014 at the staged search's R with a small n_active, and
# ta021 (P = 190), ta051 and ta081 (the largest tables, 100 jobs).
LB2_SELF_CASES = [(14, 1000, k) for k in (0, 1, 31, 33, 185, 333, 1000, 1500)] + [
    (14, 49152 * 20, 185), (21, 1000, 185), (21, 1000, 1000), (51, 200, 33),
    (51, 200, 200), (81, 64, 31), (81, 64, 64)]


@pytest.mark.parametrize("depth", ["mixed", "roots", "leaves"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("inst,R,n_active", LB2_SELF_CASES)
def test_lb2_self_kernel_matches_plain(cuda, dtype, inst, R, n_active, depth):
    # Rows with limit1 mixed, -1 ("roots": every job free) or n - 2
    # ("leaves": one free job); n_active as an int and as a device tensor;
    # the rows at or past n_active are not written.
    t = PFSPProblem(inst=inst, lb="lb2", ub=1).device_tables(cuda)
    n = t.jobs
    prmu, limit1 = _depth_nodes(np.random.default_rng(n_active + inst), n, R, depth)
    p = torch.from_numpy(prmu).to(cuda).to(dtype)
    lim = torch.from_numpy(limit1).to(cuda).to(dtype)
    k = min(n_active, R)
    want = lb2_self_kernel.plain(p[:k], lim[:k], k, t)
    for na in (n_active, torch.tensor(n_active, dtype=torch.int32, device=cuda)):
        got = lb2_self_kernel.lb2_self_bounds_cuda(p, lim, na, t)
        torch.cuda.synchronize()
        assert got.shape == (R,) and got.dtype == torch.int32
        assert torch.equal(got[:k], want)


def test_lb2_self_kernel_takes_rows_that_are_no_permutation(cuda):
    # Rows within n_active whose job ids lie outside [0, n) (and limit1 past
    # both ends) launch without a CUDA error, and the valid rows beside them
    # still equal the plain version.
    for inst in (14, 81):
        t = PFSPProblem(inst=inst, lb="lb2", ub=1).device_tables(cuda)
        n = t.jobs
        R = 3000
        prmu, limit1 = _nodes(np.random.default_rng(inst), n, R)
        wild, wlim = prmu.copy(), limit1.copy()
        bad = np.zeros(R, dtype=bool)
        bad[::3] = bad[1::7] = True
        wild[::3, 1] = 120
        wild[1::7, n - 1] = -5
        wlim[::3] = np.where(np.arange(R)[::3] % 2, -4, n + 3)
        for dtype in (torch.int8, torch.int32):
            p = torch.from_numpy(wild).to(cuda).to(dtype)
            lim = torch.from_numpy(wlim).to(cuda).to(dtype)
            got = lb2_self_kernel.lb2_self_bounds_cuda(p, lim, R, t)
            torch.cuda.synchronize()
            ok = torch.from_numpy(~bad).to(cuda)
            want = lb2_self_kernel.plain(torch.from_numpy(prmu).to(cuda),
                                         torch.from_numpy(limit1).to(cuda), R, t)
            assert torch.equal(got[ok], want[ok])


def test_lb2_self_kernel_shape_and_no_host_wait(cuda):
    # The block's threads and shared memory are the Python mirror's; the
    # grid is one wave; with n_active on the device the wrapper makes no
    # synchronising call (torch's sync debug mode raises on one).
    for inst in (14, 21, 51, 81):
        t = PFSPProblem(inst=inst, lb="lb2", ub=1).device_tables(cuda)
        n, m, P = t.jobs, t.machines, t.johnson.pair_count
        shape = lb2_self_kernel.block_shape(n, m, P)
        assert lb2_kernel.block_smem("lb2_self_bounds", t) == shape["smem_bytes"]
        p = torch.zeros((4096, n), dtype=torch.int8, device=cuda)
        p[:] = torch.arange(n, dtype=torch.int8, device=cuda)
        lim = torch.zeros(4096, dtype=torch.int8, device=cuda)
        na = torch.tensor(4096, dtype=torch.int32, device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lb2_self_kernel.lb2_self_bounds_cuda(p, lim, na, t)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sh = lb2_self_kernel.last_shape()
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert {k: sh[k] for k in shape} == shape
        assert sh["blocks"] == min(sh["per_sm"] * sms, -(-32 * 4096 // sh["threads"]))


@pytest.mark.parametrize("nact", [0, 185, 9372, 74171, 49152 * 20 // 4, 49152 * 20])
def test_lb2_self_kernel_takes_the_mirrors_split(cuda, nact):
    # The lanes a row and rows a thread that a launch took, as its block 0
    # wrote them, are the Python mirror's: at the staged ta014 search's
    # counts, a quarter of R and R; (0, 0) when there are no rows.
    t = PFSPProblem(inst=14, lb="lb2", ub=1).device_tables(cuda)
    n, m, P = t.jobs, t.machines, t.johnson.pair_count
    R = 49152 * n
    p = torch.zeros((R, n), dtype=torch.int8, device=cuda)
    p[:] = torch.arange(n, dtype=torch.int8, device=cuda)
    lim = torch.zeros(R, dtype=torch.int8, device=cuda)
    na = torch.tensor(nact, dtype=torch.int32, device=cuda)
    lb2_self_kernel.lb2_self_bounds_cuda(p, lim, na, t)
    sh = lb2_self_kernel.last_shape()
    want = (lb2_self_kernel.split(nact, sh["blocks"], sh["threads"], sh["rows"], P, m)
            if nact else (0, 0))
    assert lb2_self_kernel.last_split() == want


@pytest.mark.parametrize("size,finite", [(40, False), (700, True), (700, False)])
def test_lb2_cycle_kernel_matches_plain(cuda, size, finite):
    t = PFSPProblem(inst=14, lb="lb2", ub=1).device_tables(cuda)
    n, M, m, K = 20, 256, 25, 4
    prmu, limit1 = _nodes(np.random.default_rng(size + 1), n, size)
    best = 1500 if finite else INF
    cap = size + M * n
    pv = torch.zeros((cap, n), dtype=torch.int8, device=cuda)
    pa = torch.zeros(cap, dtype=torch.int8, device=cuda)
    pv[:size] = torch.from_numpy(prmu).to(cuda).to(torch.int8)
    pa[:size] = torch.from_numpy(limit1).to(cuda).to(torch.int8)
    pv2, pa2 = pv.clone(), pa.clone()
    st, st2 = C.new_state(size, best, cuda), C.new_state(size, best, cuda)
    scratch = C.cycle_scratch(M, n, torch.int8, cuda)
    for _ in range(3):
        C.cycle_lb2_cuda(pv, pa, st, scratch, t, M, m, K)
        C.cycle_lb2_plain(pv2, pa2, st2, t, M, m, K)
        torch.cuda.synchronize()
        assert torch.equal(st[:C.ST_BASE + 1], st2[:C.ST_BASE + 1])
        live = int(st[C.ST_SIZE])
        assert torch.equal(pv[:live], pv2[:live])
        assert torch.equal(pa[:live], pa2[:live])


@pytest.mark.parametrize("fused,staged", [(True, True), (False, True),
                                          (False, False)])
def test_lb2_search_on_card_matches_sequential_counts(cuda, fused, staged):
    ptm = taillard.reduced_instance(14, jobs=10, machines=5)
    counters = (C.cycle_lb2_cuda, lb2_self_kernel.lb2_self_bounds_cuda,
                lb2_kernel.lb2_bounds_cuda)
    for fn in counters:
        fn.launches = 0
    res = resident_search(PFSPProblem(lb="lb2", ub=0, p_times=ptm), m=8,
                          M=256, K=64, initial_best=REDUCED_LB2["best"],
                          device=cuda, fused=fused, staged=staged)
    assert (res.explored_tree, res.explored_sol, res.best) == (
        REDUCED_LB2["tree"], REDUCED_LB2["sol"], REDUCED_LB2["best"])
    path = 0 if fused else (1 if staged else 2)
    assert [fn.launches > 0 for fn in counters] == [i == path for i in range(3)]


def test_lb2_kernels_raise_on_what_they_do_not_take(cuda):
    t = PFSPProblem(inst=14, lb="lb2", ub=1).device_tables(cuda)
    with pytest.raises(TypeError):
        lb2_kernel.lb2_bounds_cuda(torch.zeros((4, 20), dtype=torch.int16, device=cuda),
                                   torch.zeros(4, dtype=torch.int16, device=cuda), t)
    with pytest.raises(ValueError):
        lb2_self_kernel.lb2_self_bounds_cuda(
            torch.zeros((4, 19), dtype=torch.int8, device=cuda),
            torch.zeros(4, dtype=torch.int8, device=cuda), 4, t)
    # 101 jobs (once refused) are taken and equal the plain
    # version; past MAX_JOBS jobs is refused.
    rng = np.random.default_rng(0)
    ptm = rng.integers(1, 100, (3, 101))
    mid = PFSPProblem(lb="lb2", ub=0, p_times=ptm).device_tables(cuda)
    prmu, limit1 = _nodes(rng, 101, 64)
    p = torch.from_numpy(prmu).to(cuda).to(torch.int8)
    lim = torch.from_numpy(limit1).to(cuda).to(torch.int8)
    op = torch.from_numpy(np.arange(101)[None, :] > limit1[:, None]).to(cuda)
    got = lb2_kernel.lb2_bounds_cuda(p, lim, mid)
    assert torch.equal(got[op], lb2_kernel.plain(p, lim, mid)[op])
    assert lb2_kernel.last_shape("lb2_bounds")["tables"] == "smem"
    ptm = rng.integers(1, 100, (3, lb2_kernel.MAX_JOBS + 1))
    big = PFSPProblem(lb="lb2", ub=0, p_times=ptm).device_tables(cuda)
    rows = torch.zeros((4, ptm.shape[1]), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lb2_kernel.lb2_bounds_cuda(rows, torch.zeros(4, dtype=torch.int32, device=cuda), big)


def _depth_nodes(rng, n, B, depth):
    """Seeded nodes whose limit1 is mixed (``_nodes``), n - 2 for every
    parent ("leaves": one child, a leaf) or -1 ("roots": n children, every
    job free)."""
    prmu, limit1 = _nodes(rng, n, B)
    if depth != "mixed":
        limit1[:] = n - 2 if depth == "leaves" else -1
    return prmu, limit1


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("depth", ["mixed", "leaves", "roots"])
@pytest.mark.parametrize("B", [1024, 49152])
def test_lb2_kernel_block_shapes_match_plain(cuda, B, depth, dtype):
    # Kernel 6's two block shapes: at B = 1024 every block fits on the card
    # at once (two parents a block, one thread a (parent, pair) task,
    # wavefront fronts); at B = 49152 it does not (32 parents a block,
    # threads that loop). Only the open slots are written and compared.
    t = PFSPProblem(inst=14, lb="lb2", ub=1).device_tables(cuda)
    n = t.jobs
    prmu, limit1 = _depth_nodes(np.random.default_rng(B), n, B, depth)
    p = torch.from_numpy(prmu).to(cuda).to(dtype)
    lim = torch.from_numpy(limit1).to(cuda).to(dtype)
    got = lb2_kernel.lb2_bounds_cuda(p, lim, t)
    want = lb2_kernel.plain(p, lim, t)
    torch.cuda.synchronize()
    assert lb2_kernel.last_shape("lb2_bounds")["fits"] == (B == 1024)
    op = torch.from_numpy(np.arange(n)[None, :] > limit1[:, None]).to(cuda)
    assert torch.equal(got[op], want[op])


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_lb2_kernel_takes_more_than_32_machines(cuda, dtype):
    # 40 machines (P = 780 pairs): past one warp of lanes, so the parent
    # fronts take one thread a parent.
    ptm = np.random.default_rng(40).integers(1, 100, (40, 12))
    t = PFSPProblem(lb="lb2", ub=0, p_times=ptm).device_tables(cuda)
    prmu, limit1 = _nodes(np.random.default_rng(41), 12, 300)
    p = torch.from_numpy(prmu).to(cuda).to(dtype)
    lim = torch.from_numpy(limit1).to(cuda).to(dtype)
    got = lb2_kernel.lb2_bounds_cuda(p, lim, t)
    want = lb2_kernel.plain(p, lim, t)
    torch.cuda.synchronize()
    op = torch.from_numpy(np.arange(12)[None, :] > limit1[:, None]).to(cuda)
    assert torch.equal(got[op], want[op])


@pytest.mark.parametrize("depth", ["mixed", "leaves", "roots"])
@pytest.mark.parametrize("M", [1024, 49152])
def test_lb2_cycle_block_shapes_match_plain(cuda, M, depth):
    # Kernel 8's bounds launch in its two block shapes (as kernel 6), on a
    # full chunk of mixed, leaf-only and root-only parents: equal state and
    # live pool rows after each of two cycles.
    t = PFSPProblem(inst=14, lb="lb2", ub=1).device_tables(cuda)
    n, m, K = t.jobs, 25, 8
    size = M + 517
    prmu, limit1 = _depth_nodes(np.random.default_rng(M + 1), n, size, depth)
    cap = size + 2 * M * n
    pv = torch.zeros((cap, n), dtype=torch.int8, device=cuda)
    pa = torch.zeros(cap, dtype=torch.int8, device=cuda)
    pv[:size] = torch.from_numpy(prmu).to(cuda).to(torch.int8)
    pa[:size] = torch.from_numpy(limit1).to(cuda).to(torch.int8)
    scratch = C.cycle_scratch(M, n, torch.int8, cuda)
    _cycles_match(lambda *a: C.cycle_lb2_cuda(*a, scratch, t, M, m, K),
                  lambda *a: C.cycle_lb2_plain(*a, t, M, m, K),
                  pv, pa, C.new_state(size, 1500, cuda), 2)
    assert lb2_kernel.last_shape("cycle_lb2")["fits"] == (M == 1024)


@pytest.mark.parametrize("finite", [True, False])
def test_lb2_cycle_takes_ta081(cuda, finite):
    # ta081's 100 jobs (P = 190 pairs of 20 machines): the most the lb2
    # kernels take, four free-mask words a (parent, pair) task and a block
    # cut to the parents that fit in shared memory.
    t = PFSPProblem(inst=81, lb="lb2", ub=1).device_tables(cuda)
    n, M, m, K = t.jobs, 96, 25, 8
    size = M + 61
    prmu, limit1 = _nodes(np.random.default_rng(81), n, size)
    cap = size + 3 * M * n
    pv = torch.zeros((cap, n), dtype=torch.int8, device=cuda)
    pa = torch.zeros(cap, dtype=torch.int8, device=cuda)
    pv[:size] = torch.from_numpy(prmu).to(cuda).to(torch.int8)
    pa[:size] = torch.from_numpy(limit1).to(cuda).to(torch.int8)
    scratch = C.cycle_scratch(M, n, torch.int8, cuda)
    best = 7000 if finite else INF
    st2 = _cycles_match(lambda *a: C.cycle_lb2_cuda(*a, scratch, t, M, m, K),
                        lambda *a: C.cycle_lb2_plain(*a, t, M, m, K),
                        pv, pa, C.new_state(size, best, cuda), 2)
    assert int(st2[C.ST_TREE]) > 0


# -- the streamed cycle (kernels 9a, 9b and 9c) and the eval-only pass ---------


def _tiled_check(cuda_cycle, plain_cycle, pv, pa, st, scratch, spec, M, mt,
                 cycles=2):
    """``cycles`` streamed cycles on the card and in plain PyTorch from one
    pool: equal state, live rows and (G, 4) per-tile scalars after each (the
    second cycle runs on the counts and boundary row the first one used)."""
    m, K = 25, 4
    pv2, pa2, st2 = pv.clone(), pa.clone(), st.clone()
    for _ in range(cycles):
        cuda_cycle(pv, pa, st, scratch, spec, M, mt, m, K)
        scal = plain_cycle(pv2, pa2, st2, spec, M, mt, m, K)
        torch.cuda.synchronize()
        assert torch.equal(st[:C.ST_BASE + 1], st2[:C.ST_BASE + 1])
        live = int(st[C.ST_SIZE])
        assert torch.equal(pv[:live], pv2[:live])
        assert torch.equal(pa[:live], pa2[:live])
        assert torch.equal(scratch.scal, scal)
        assert int(st[C.ST_TREE]) > 0


# (lb, Taillard instance, pool dtype, M, mt): mt = 8 (the most tiles, four a
# block of 32 parents) and M / 2 (two tiles); ta021 (20 machines, P = 190
# pairs) and ta051 (50 jobs: two keep-mask words a parent, an int32 pool)
# under lb2.
_TILED_PFSP = [(lb, 14, torch.int8, M, mt) for lb in ("lb1", "lb2")
               for M, mt in ((1024, 16), (1024, 512), (49152, 64), (49152, 8))] + [
    ("lb2", 21, torch.int8, 1024, 16), ("lb2", 21, torch.int8, 49152, 64),
    ("lb2", 51, torch.int32, 1024, 8), ("lb2", 51, torch.int32, 8192, 4096)]


@pytest.mark.parametrize("incumbent", ["finite", "inf"])
@pytest.mark.parametrize("chunk", ["partial", "full"])
@pytest.mark.parametrize("lb,inst,dtype,M,mt", _TILED_PFSP)
def test_tiled_pfsp_kernel_matches_plain(cuda, lb, inst, dtype, M, mt, chunk,
                                         incumbent):
    t = PFSPProblem(inst=inst, lb=lb, ub=1).device_tables(cuda)
    n = t.jobs
    size = M // 2 + 3 if chunk == "partial" else M + 517
    prmu, limit1 = _nodes(np.random.default_rng(M + size + inst), n, size)
    best = INF
    if incumbent == "finite":  # half the chunk's leaves improve on it
        bound = lb1_chunk if lb == "lb1" else lb2_chunk
        lbs = bound(torch.from_numpy(prmu).to(cuda),
                    torch.from_numpy(limit1).to(cuda), t).cpu().numpy()
        leaf = (np.arange(n)[None, :] > limit1[:, None]) & (limit1[:, None] == n - 2)
        best = int(np.median(lbs[leaf]))
    cap = size + 2 * M * n
    pv = torch.zeros((cap, n), dtype=dtype, device=cuda)
    pa = torch.zeros(cap, dtype=dtype, device=cuda)
    pv[:size] = torch.from_numpy(prmu).to(cuda).to(dtype)
    pa[:size] = torch.from_numpy(limit1).to(cuda).to(dtype)
    st = C.new_state(size, best, cuda)
    if lb == "lb1":
        cuda_cycle, plain_cycle = T.tiled_lb1_cuda, T.tiled_lb1_plain
        scratch = T.tiled_lb1_scratch(M, n, mt, dtype, cuda)
    else:
        cuda_cycle, plain_cycle = T.tiled_lb2_cuda, T.tiled_lb2_plain
        scratch = T.tiled_lb2_scratch(M, n, mt, dtype, cuda)
    _tiled_check(cuda_cycle, plain_cycle, pv, pa, st, scratch, t, M, mt)


@pytest.mark.parametrize("chunk", ["partial", "full"])
@pytest.mark.parametrize("M,mt", [(1024, 16), (1024, 512), (50000, 80),
                                  (50000, 8)])
def test_tiled_nqueens_kernel_matches_plain(cuda, M, mt, chunk):
    prob = NQueensProblem(15)
    N = prob.N
    size = M // 2 + 3 if chunk == "partial" else M + 517
    board, depth = _boards(np.random.default_rng(M + size), N, size)
    cap = size + 2 * M * N
    pv = torch.zeros((cap, N), dtype=torch.uint8, device=cuda)
    pa = torch.zeros(cap, dtype=torch.int8, device=cuda)
    pv[:size] = torch.from_numpy(board).to(cuda)
    pa[:size] = torch.from_numpy(depth).to(cuda).to(torch.int8)
    _tiled_check(T.tiled_nqueens_cuda, T.tiled_nqueens_plain, pv, pa,
                 C.new_state(size, INF, cuda),
                 T.tiled_nqueens_scratch(M, N, mt, cuda), prob, M, mt)


def test_tiled_lb2_takes_what_kernel_8_takes(cuda):
    # 100 jobs on 22 machines (P = 231 pairs): the tables plus one parent
    # pass the shared memory a block may hold, so kernels 8 and 9c take the
    # global table route (once refused), and equal their plain
    # versions over three cycles.
    ptm = np.random.default_rng(22).integers(1, 100, (22, 100))
    t = PFSPProblem(lb="lb2", ub=0, p_times=ptm).device_tables(cuda)
    assert lb2_kernel.block_smem("tiled_lb2", t) > lb2_kernel.SMEM_LIMIT
    assert lb2_kernel.johnson_operands("tiled_lb2", t).tables == "global"
    n, M, mt = 100, 64, 16
    prmu, limit1 = _nodes(np.random.default_rng(23), n, 3 * M)
    cap = 3 * M + 2 * M * n
    for tiled in (False, True):
        pv = torch.zeros((cap, n), dtype=torch.int8, device=cuda)
        pa = torch.zeros(cap, dtype=torch.int8, device=cuda)
        pv[:3 * M] = torch.from_numpy(prmu).to(cuda).to(torch.int8)
        pa[:3 * M] = torch.from_numpy(limit1).to(cuda).to(torch.int8)
        if tiled:
            _tiled_check(T.tiled_lb2_cuda, T.tiled_lb2_plain, pv, pa,
                         C.new_state(3 * M, INF, cuda),
                         T.tiled_lb2_scratch(M, n, mt, torch.int8, cuda), t, M,
                         mt)
            assert lb2_kernel.last_shape("tiled_lb2")["tables"] == "global"
        else:
            _cycle_check(C.cycle_lb2_cuda, C.cycle_lb2_plain, pv, pa,
                         C.new_state(3 * M, INF, cuda),
                         C.cycle_scratch(M, n, torch.int8, cuda), t, M)
            assert lb2_kernel.last_shape("cycle_lb2")["tables"] == "global"


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("B,mt", [(1024, 16), (49152, 64)])
@pytest.mark.parametrize("lb", ["lb1", "lb2"])
def test_streamed_eval_pfsp_matches_plain(cuda, lb, B, mt, dtype):
    prob = PFSPProblem(inst=14, lb=lb, ub=1)
    prmu, limit1 = _nodes(np.random.default_rng(B + mt), 20, B)
    p = torch.from_numpy(prmu).to(cuda).to(dtype)
    lim = torch.from_numpy(limit1).to(cuda).to(dtype)
    got = T.streamed_eval_bounds(prob, p, lim, mt)
    want = (lb1_chunk if lb == "lb1" else lb2_chunk)(p, lim, prob.device_tables(cuda))
    torch.cuda.synchronize()
    op = torch.from_numpy(np.arange(20)[None, :] > limit1[:, None]).to(cuda)
    assert torch.equal(got[op], want[op])
    if lb == "lb2":  # any B
        got = T.megakernel_lb2_bounds(p[:1000], lim[:1000], prob.device_tables(cuda))
        assert torch.equal(got[op[:1000]], want[:1000][op[:1000]])


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("B,mt", [(1000, 8), (50000, 80)])
def test_streamed_eval_nqueens_matches_plain(cuda, B, mt, dtype):
    prob = NQueensProblem(15, g=2)
    board, depth = _boards(np.random.default_rng(B), 15, B)
    b = torch.from_numpy(board).to(cuda)
    d = torch.from_numpy(depth).to(cuda).to(dtype)
    got = T.streamed_eval_bounds(prob, b, d, mt)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, labels_chunk(b, d, 15, 2).to(torch.int32))


@pytest.mark.parametrize("lb", ["lb1", "lb2"])
def test_tiled_search_on_card_matches_sequential_counts(cuda, lb):
    ptm = taillard.reduced_instance(14, jobs=10, machines=5)
    want = REDUCED if lb == "lb1" else REDUCED_LB2
    fn = T.tiled_lb1_cuda if lb == "lb1" else T.tiled_lb2_cuda
    fn.launches = 0
    res = resident_search(PFSPProblem(lb=lb, ub=0, p_times=ptm), m=8, M=256,
                          K=64, initial_best=want["best"], device=cuda, mt=16)
    assert (res.explored_tree, res.explored_sol, res.best) == (
        want["tree"], want["sol"], want["best"])
    assert res.megakernel_mt == 16 and fn.launches > 0


def test_tiled_nqueens_search_on_card_matches_goldens(cuda):
    T.tiled_nqueens_cuda.launches = 0
    res = resident_search(NQueensProblem(10), m=25, M=1024, K=64, device=cuda,
                          mt=16)
    assert (res.explored_tree, res.explored_sol) == (NQ10["tree"], NQ10["sol"])
    assert res.megakernel_mt == 16 and T.tiled_nqueens_cuda.launches > 0


# -- kernels 1 and 5: the staged body (csrc/lb1_family.cuh) --------------------

_LB1_FAMILY = {"lb1": (lb1_kernel.lb1_bounds_cuda, lb1_kernel.plain, "lb1_bounds"),
               "lb1_d": (lb1_d_kernel.lb1_d_bounds_cuda, lb1_d_kernel.plain,
                         "lb1_d_bounds")}


def _lb1_family_check(cuda, bound, t, prmu, limit1, dtype, slots="open"):
    """Kernel 1 or 5 on these rows against its plain version, on the open
    slots (or, ``slots="all"``, on every slot); returns the block shape."""
    kernel, plain, source = _LB1_FAMILY[bound]
    n = t.jobs
    p = torch.from_numpy(prmu).to(cuda).to(dtype)
    lim = torch.from_numpy(limit1).to(cuda).to(dtype)
    got = kernel(p, lim, t)
    want = plain(p, lim, t)
    torch.cuda.synchronize()
    if slots == "all":
        assert torch.equal(got, want)
    else:
        op = torch.from_numpy(np.arange(n)[None, :] > limit1[:, None]).to(cuda)
        assert torch.equal(got[op], want[op])
    return lb1_kernel.last_shape(source)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("depth", ["mixed", "leaves", "roots"])
@pytest.mark.parametrize("B", [1, 1024, 49152])
@pytest.mark.parametrize("bound", ["lb1", "lb1_d"])
def test_lb1_family_grid_forms_match_plain(cuda, bound, B, depth, dtype):
    # Kernels 1 and 5 in both grid forms: at B = 1 and 1024 every block of
    # one thread a slot is on the card at once (blocks of fewer parents, so
    # the grid has a block an SM), and the parent prologue is a wavefront
    # over 16 lanes, one of ta014's 10 machines each; at B = 49152 it is
    # not, so 32-parent blocks loop over their slots and warp 0 takes the
    # fronts.
    t = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(cuda)
    prmu, limit1 = _depth_nodes(np.random.default_rng(B + 7), t.jobs, B, depth)
    shape = _lb1_family_check(cuda, bound, t, prmu, limit1, dtype)
    fits = B < 49152
    assert shape["fits"] == fits and shape["lanes"] == (16 if fits else 0)
    assert (shape["parents"], shape["threads"]) == (
        {1: (1, 32), 1024: (4, 96)}[B] if fits else (32, 128))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("B", [1, 300, 49152])
@pytest.mark.parametrize("bound", ["lb1", "lb1_d"])
def test_lb1_family_takes_more_than_32_machines(cuda, bound, B, dtype):
    # 40 machines: more than a warp has lanes, so warp 0 takes the fronts,
    # one thread a parent (at B = 1 and 300 in a block of one warp, which
    # then takes the remaining work too), in both grid forms.
    ptm = np.random.default_rng(40).integers(1, 100, (40, 12))
    t = PFSPProblem(lb="lb1", ub=0, p_times=ptm).device_tables(cuda)
    prmu, limit1 = _nodes(np.random.default_rng(41), 12, B)
    shape = _lb1_family_check(cuda, bound, t, prmu, limit1, dtype)
    assert shape["lanes"] == 0


@pytest.mark.parametrize("B", [1, 700, 4224])
@pytest.mark.parametrize("bound", ["lb1", "lb1_d"])
def test_lb1_family_takes_ta111_int32(cuda, bound, B):
    # 500 jobs and 20 machines: int32 rows, 32 lanes a parent; at
    # B = 4224, 32-parent blocks stage 64 KB of rows (past 48 KB of shared
    # memory).
    t = PFSPProblem(inst=111, lb="lb1", ub=1).device_tables(cuda)
    prmu, limit1 = _nodes(np.random.default_rng(111), t.jobs, B)
    shape = _lb1_family_check(cuda, bound, t, prmu, limit1, torch.int32)
    assert shape["lanes"] == 32
    assert (shape["smem_bytes"] > 48 * 1024) == (B == 4224)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("bound", ["lb1", "lb1_d"])
def test_lb1_family_rows_that_are_no_permutation(cuda, bound, dtype):
    # Repeated in-range ids and limit1 past both ends equal the plain
    # version on every slot; ids outside 0..n-1 are read as job 0 and index
    # nothing past the table (the plain plane of the same rows with those
    # ids set to 0).
    t = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(cuda)
    rng = np.random.default_rng(44)
    prmu = rng.integers(0, 20, (2000, 20)).astype(np.int32)
    limit1 = rng.integers(-3, 22, 2000).astype(np.int32)
    _lb1_family_check(cuda, bound, t, prmu, limit1, dtype, slots="all")
    wild = rng.integers(-128, 128, (2000, 20)).astype(np.int32)
    kernel, plain, _ = _LB1_FAMILY[bound]
    p = torch.from_numpy(wild).to(cuda).to(dtype)
    lim = torch.from_numpy(limit1).to(cuda).to(dtype)
    fixed = torch.where((p >= 0) & (p < 20), p, torch.zeros_like(p))
    got = kernel(p, lim, t)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(fixed, lim, t))


@pytest.mark.parametrize("bound", ["lb1", "lb1_d"])
def test_lb1_family_reads_an_unaligned_chunk(cuda, bound):
    # A chunk that starts mid-pool (the unfused cycle's window): its rows
    # and limit1 sit at any phase mod 16, which the staged copy keeps.
    t = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(cuda)
    prmu, limit1 = _nodes(np.random.default_rng(45), 20, 3001)
    kernel, plain, _ = _LB1_FAMILY[bound]
    p = torch.from_numpy(prmu).to(cuda).to(torch.int8)
    lim = torch.from_numpy(limit1).to(cuda).to(torch.int8)
    op = torch.from_numpy(np.arange(20)[None, :] > limit1[:, None]).to(cuda)
    for start in (1, 3, 7, 13):
        got = kernel(p[start:], lim[start:], t)
        want = plain(p[start:], lim[start:], t)
        torch.cuda.synchronize()
        assert torch.equal(got[op[start:]], want[op[start:]])


# -- the graph dispatch (ops/dispatch.py) ---------------------------------------

_GRAPH_CASES = [("lb1", None), ("lb2", None), ("nqueens", None),
                ("lb1", 32), ("lb2", 32), ("nqueens", 32)]


def _graph_program(cuda, kind, mt, K=7, M=256):
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.engine.resident import make_program
    from tpu_tree_search_torch.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    prob = (NQueensProblem(12) if kind == "nqueens"
            else PFSPProblem(inst=14, lb=kind, ub=1))
    best = INF if kind == "nqueens" else prob.initial_ub
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    warmup(prob, pool, best, 600)
    prog = make_program(prob, 25, M, K, 1 << 16, cuda, mt=mt)
    return prog, pool.as_batch(), best


def _graph_wrapper(kind, mt):
    """The cycle wrapper the graph of (kind, mt) captures, its counts
    zeroed."""
    fn = {("lb1", False): C.cycle_lb1_cuda, ("lb2", False): C.cycle_lb2_cuda,
          ("nqueens", False): CN.cycle_nqueens_cuda,
          ("lb1", True): T.tiled_lb1_cuda, ("lb2", True): T.tiled_lb2_cuda,
          ("nqueens", True): T.tiled_nqueens_cuda}[kind, mt is not None]
    fn.launches = fn.captures = 0
    return fn


@pytest.mark.parametrize("kind,mt", _GRAPH_CASES)
def test_graph_dispatch_matches_k_plain_cycles(cuda, kind, mt):
    K, M = 7, 256
    prog, fr, best = _graph_program(cuda, kind, mt, K, M)
    assert prog.graphed
    state = prog.init_state(fr, best)
    ref = prog.init_state(fr, best)
    prog.host_slots(1)
    wrapper = _graph_wrapper(kind, mt)
    got = prog.enqueue(state)()
    # One capture; the cycle's launches are the body's K runs, counted when
    # the dispatch is read, and timed with events.
    assert (wrapper.captures, wrapper.launches) == (1, K)
    assert int(state.st[C.ST_RUNS]) == K and prog.dispatch_device_s > 0
    ref.st[C.ST_TREE:C.ST_CYCLES + 1] = 0
    for _ in range(K):
        if kind == "nqueens":
            CN.cycle_nqueens_plain(ref.pool_vals, ref.pool_aux, ref.st, 12, 1,
                                   M, 25, K)
        else:
            (C.cycle_lb1_plain if kind == "lb1" else C.cycle_lb2_plain)(
                ref.pool_vals, ref.pool_aux, ref.st, prog.tables, M, 25, K)
    torch.cuda.synchronize()
    size, bst, tree, sol, cycles = ref.st[:C.ST_CYCLES + 1].tolist()
    assert got == (tree, sol, cycles, size, bst)
    assert cycles == K and prog.graph_build_s > 0
    # Every state word through the body's runs: the cycle counts its run
    # and sets the condition itself, so the body is its launches alone.
    g = next(iter(prog._graphs.values()))
    assert g.own_cond and _body_names(g) == _BODY[kind, mt is not None]
    assert state.st[:C.ST_RUNS].tolist() == ref.st[:C.ST_RUNS].tolist()
    assert torch.equal(state.pool_vals[:size], ref.pool_vals[:size])
    assert torch.equal(state.pool_aux[:size], ref.pool_aux[:size])
    prog.close()


@pytest.mark.parametrize("kind,mt", [("nqueens", None), ("nqueens", 32)])
def test_graph_dispatch_ending_before_k_runs_no_extra_body(cuda, kind, mt):
    """N = 8 from a small frontier at K = 64: the loop condition fails
    before the K-th cycle, and the body, whose cycle set the condition, ran
    once a cycle: the state equals the plain dispatch loop's."""
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.engine.resident import make_program
    from tpu_tree_search_torch.ops import dispatch as D
    from tpu_tree_search_torch.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    K, M, m = 64, 64, 5
    prob = NQueensProblem(8)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    warmup(prob, pool, INF, 40)
    fr = pool.as_batch()
    prog = make_program(prob, m, M, K, 1 << 12, cuda, mt=mt)
    state = prog.init_state(fr, INF)
    ref = prog.init_state(fr, INF)
    prog.host_slots(1)
    wrapper = _graph_wrapper(kind, mt)
    got = prog.enqueue(state)()
    ref.st[C.ST_TREE:C.ST_CYCLES + 1] = 0
    ref.st[C.ST_RUNS] = 0
    live = D.loop_active(ref.st.tolist(), m, M * 8, prog.capacity, K)
    while live:
        CN.cycle_nqueens_plain(ref.pool_vals, ref.pool_aux, ref.st, 8, 1, M, m,
                               K)
        live = D.cycle_cond_plain(ref.st, m, M * 8, prog.capacity, K)
    cycles = int(ref.st[C.ST_CYCLES])
    assert 0 < cycles < K and got[2] == cycles
    assert state.st[:C.ST_RUNS + 1].tolist() == ref.st[:C.ST_RUNS + 1].tolist()
    assert wrapper.launches == cycles == int(state.st[C.ST_RUNS])
    prog.close()


def test_graph_dispatch_stops_at_termination(cuda):
    # A frontier below m: the dispatch runs no cycle and changes nothing
    # but the zeroed counters; a graph per K rung, on the same state.
    prog, fr, best = _graph_program(cuda, "lb1", None)
    state = prog.init_state({k: v[:10] for k, v in fr.items()}, best)
    before = state.pool_vals.clone()
    prog.host_slots(2)
    wrapper = _graph_wrapper("lb1", None)
    assert prog.enqueue(state)() == (0, 0, 0, 10, best)
    prog.use_k(4)
    assert prog.enqueue(state)() == (0, 0, 0, 10, best)
    assert len(prog._graphs) == 2
    # Two captures, no cycle launched.
    assert (wrapper.captures, wrapper.launches) == (2, 0)
    assert int(state.st[C.ST_RUNS]) == 0
    assert torch.equal(state.pool_vals, before)
    prog.close()


def test_graph_step_does_not_synchronise(cuda):
    prog, fr, best = _graph_program(cuda, "nqueens", None, K=3)
    state = prog.init_state(fr, best)
    prog.host_slots(2)
    prog.enqueue(state)()  # builds the graph (capture is set-up)
    torch.cuda.set_sync_debug_mode("error")
    try:
        reads = [prog.enqueue(state), prog.enqueue(state)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [r()[2] for r in reads] == [3, 3]
    prog.close()


@pytest.mark.parametrize("kind", ["nqueens", "lb1"])
def test_graph_search_stalls_and_hits_goldens(cuda, kind):
    if kind == "nqueens":
        res = resident_search(NQueensProblem(10), m=8, M=32, K=16,
                              capacity=700, warmup_target=400, device=cuda)
        assert (res.explored_tree, res.explored_sol) == (NQ10["tree"],
                                                         NQ10["sol"])
    else:
        ptm = taillard.reduced_instance(14, jobs=10, machines=5)
        res = resident_search(PFSPProblem(lb="lb1", ub=0, p_times=ptm), m=8,
                              M=32, K=16, capacity=700, warmup_target=400,
                              initial_best=REDUCED["best"], device=cuda)
        assert (res.explored_tree, res.explored_sol, res.best) == (
            REDUCED["tree"], REDUCED["sol"], REDUCED["best"])
    assert res.stall_fallbacks >= 1 and res.fused


@pytest.mark.parametrize("depth", ["1", "3"])
def test_graph_search_k_auto_hits_goldens(cuda, monkeypatch, depth):
    monkeypatch.setenv("TTS_PIPELINE", depth)
    res = resident_search(NQueensProblem(10), m=25, M=1024, K="auto",
                          device=cuda)
    assert (res.explored_tree, res.explored_sol) == (NQ10["tree"], NQ10["sol"])
    assert res.k_auto and res.pipeline_depth == int(depth)
    assert res.graph_build_s > 0 and res.dispatch_device_s > 0


# -- N-Queens past 32 queens (kernels 3, 4 and 9a) --------------------------------


@pytest.mark.parametrize("N", [33, 48, 64, 127, 200])
def test_nqueens_wide_kernels_match_plain(cuda, N):
    # Kernel 3's per-slot path, and kernels 4 and 9a at W = 2, 4 or 8 mask
    # words a parent (int8 depth through N = 127, int32 beyond), against
    # their plain versions, over three cycles of a seeded pool.
    ddt = CN.depth_dtype(N)
    rng = np.random.default_rng(N)
    board, depth = _boards(rng, N, 700)
    depth = np.minimum(depth, rng.integers(0, 8, 700))  # many open slots
    b = torch.from_numpy(board).to(cuda)
    d = torch.from_numpy(depth).to(cuda).to(ddt)
    for g in (1, 2):
        assert torch.equal(nqueens_kernel.nqueens_labels_cuda(b, d, N, g),
                           nqueens_kernel.plain(b, d, N, g))
    assert nqueens_kernel.last_shape()["words"] == 0
    prob = NQueensProblem(N)
    M, m, K, size = 256, 25, 4, 700
    for mt in (None, 32):
        cap = size + 3 * M * N
        pv = torch.zeros((cap, N), dtype=torch.uint8, device=cuda)
        pa = torch.zeros(cap, dtype=ddt, device=cuda)
        pv[:size], pa[:size] = b, d
        pv2, pa2 = pv.clone(), pa.clone()
        st, st2 = C.new_state(size, INF, cuda), C.new_state(size, INF, cuda)
        if mt is None:
            scratch = CN.nqueens_scratch(M, N, cuda)
        else:
            scratch = T.tiled_nqueens_scratch(M, N, mt, cuda)
        for _ in range(3):
            if mt is None:
                CN.cycle_nqueens_cuda(pv, pa, st, scratch, N, 1, M, m, K)
                CN.cycle_nqueens_plain(pv2, pa2, st2, N, 1, M, m, K)
            else:
                T.tiled_nqueens_cuda(pv, pa, st, scratch, prob, M, mt, m, K)
                T.tiled_nqueens_plain(pv2, pa2, st2, prob, M, mt, m, K)
            torch.cuda.synchronize()
            assert torch.equal(st[:C.ST_BASE + 1], st2[:C.ST_BASE + 1])
            live = int(st[C.ST_SIZE])
            assert torch.equal(pv[:live], pv2[:live])
            assert torch.equal(pa[:live], pa2[:live])
        assert int(st[C.ST_TREE]) > 0



# -- lb2 past 100 jobs (kernels 6, 7, 8 and 9c) ----------------------------------


def _cycle_check(cuda_cycle, plain_cycle, pv, pa, st, scratch, t, M, K=4):
    """Three cycles of a single-tile PFSP cycle kernel against its plain
    version on a copy of the pool: the same state and live rows."""
    pv2, pa2, st2 = pv.clone(), pa.clone(), st.clone()
    for _ in range(3):
        cuda_cycle(pv, pa, st, scratch, t, M, 25, K)
        plain_cycle(pv2, pa2, st2, t, M, 25, K)
        torch.cuda.synchronize()
        assert torch.equal(st[:C.ST_BASE + 1], st2[:C.ST_BASE + 1])
        live = int(st[C.ST_SIZE])
        assert torch.equal(pv[:live], pv2[:live])
        assert torch.equal(pa[:live], pa2[:live])
    assert int(st[C.ST_TREE]) > 0


@pytest.mark.parametrize("inst", [91, 101, 111])
def test_lb2_kernels_past_100_jobs_match_plain(cuda, inst):
    # ta091 (200 x 10, the shared-memory route), ta101 (200 x 20) and ta111
    # (500 x 20, the global route), int32 pools: kernels 6, 7, 8 and 9c
    # against their plain versions, max difference 0, each launch on the
    # route that `johnson_operands` picks.
    t = PFSPProblem(inst=inst, lb="lb2", ub=1).device_tables(cuda)
    n = t.jobs
    want_route = "smem" if inst <= 100 else "global"
    for source in ("lb2_bounds", "lb2_self_bounds", "cycle_lb2", "tiled_lb2"):
        J = lb2_kernel.johnson_operands(source, t)
        assert J.tables == want_route
    rng = np.random.default_rng(inst)
    prmu, limit1 = _nodes(rng, n, 96)
    p = torch.from_numpy(prmu).to(cuda)
    lim = torch.from_numpy(limit1).to(cuda)
    op = torch.from_numpy(np.arange(n)[None, :] > limit1[:, None]).to(cuda)
    got = lb2_kernel.lb2_bounds_cuda(p, lim, t)
    assert torch.equal(got[op], lb2_kernel.plain(p, lim, t)[op])
    assert lb2_kernel.last_shape("lb2_bounds")["tables"] == want_route
    got = lb2_self_kernel.lb2_self_bounds_cuda(p, lim, 96, t)
    assert torch.equal(got, lb2_self_kernel.plain(p, lim, 96, t))
    assert lb2_self_kernel.last_shape()["tables"] == want_route
    M, mt = 64, 16
    rows, lim3 = _nodes(rng, n, 3 * M)
    cap = 3 * M + 2 * M * n
    for tiled in (False, True):
        pv = torch.zeros((cap, n), dtype=torch.int32, device=cuda)
        pa = torch.zeros(cap, dtype=torch.int32, device=cuda)
        pv[:3 * M] = torch.from_numpy(rows).to(cuda)
        pa[:3 * M] = torch.from_numpy(lim3).to(cuda)
        st = C.new_state(3 * M, INF, cuda)
        if tiled:
            _tiled_check(T.tiled_lb2_cuda, T.tiled_lb2_plain, pv, pa, st,
                         T.tiled_lb2_scratch(M, n, mt, torch.int32, cuda), t,
                         M, mt)
            assert lb2_kernel.last_shape("tiled_lb2")["tables"] == want_route
        else:
            _cycle_check(C.cycle_lb2_cuda, C.cycle_lb2_plain, pv, pa, st,
                         C.cycle_scratch(M, n, torch.int32, cuda), t, M)
            assert lb2_kernel.last_shape("cycle_lb2")["tables"] == want_route


# -- the offload tier and checkpoints on the card ------------------------------

# The full goldens (bench.py:57-60).
TA014 = {"lb1": (2573652, 2648, 1377), "lb2": (144639, 0, 1377)}
NQ12 = (856188, 14200)
# The bound wrappers the offload tier may launch, by name.
_BOUND_WRAPPERS = {"lb1_bounds": lb1_kernel.lb1_bounds_cuda,
                   "lb1_d_bounds": lb1_d_kernel.lb1_d_bounds_cuda,
                   "lb2_bounds": lb2_kernel.lb2_bounds_cuda,
                   "lb2_self_bounds": lb2_self_kernel.lb2_self_bounds_cuda,
                   "nqueens_labels": nqueens_kernel.nqueens_labels_cuda,
                   "cycle_lb1": C.cycle_lb1_cuda, "cycle_lb2": C.cycle_lb2_cuda,
                   "cycle_nqueens": CN.cycle_nqueens_cuda}


@pytest.mark.parametrize("case,launched", [
    ("lb1", ("lb1_bounds",)),
    ("lb2", ("lb1_bounds", "lb2_self_bounds")),
    ("lb2_single_pass", ("lb2_bounds",)),
    ("nqueens12", ("nqueens_labels",)),
])
def test_offload_tier_hits_goldens_one_launch_a_chunk(cuda, case, launched):
    from tpu_tree_search_torch.engine.device import device_search

    for w in _BOUND_WRAPPERS.values():
        w.launches = 0
    if case == "nqueens12":
        res = device_search(NQueensProblem(12), device=cuda)
        assert (res.explored_tree, res.explored_sol) == NQ12
    else:
        lb = case[:3]
        res = device_search(PFSPProblem(inst=14, lb=lb, ub=1), device=cuda,
                            staged=case != "lb2_single_pass")
        assert (res.explored_tree, res.explored_sol, res.best) == TA014[lb]
    d = res.diagnostics
    assert d.kernel_launches == d.host_to_device == d.device_to_host > 0
    assert {k: w.launches for k, w in _BOUND_WRAPPERS.items()} == {
        k: d.kernel_launches if k in launched else 0 for k in _BOUND_WRAPPERS}


def test_resident_cut_and_resume_on_the_graph(cuda, tmp_path):
    path = str(tmp_path / "ta014.npz")
    part = resident_search(PFSPProblem(inst=14, lb="lb1", ub=1), M=1024, K=4,
                           device=cuda, max_steps=3, checkpoint_path=path)
    assert not part.complete and part.steps == 3 and part.fused
    assert part.graph_build_s > 0
    done = resident_search(PFSPProblem(inst=14, lb="lb1", ub=1), M=1024, K=4,
                           device=cuda, resume_from=path)
    assert done.complete and done.phases[0].tree == part.explored_tree
    assert (done.explored_tree, done.explored_sol, done.best) == TA014["lb1"]


def test_committed_v1_fixture_resumes_on_the_card(cuda):
    from pathlib import Path

    path = Path(__file__).resolve().parent / "data" / "nqueens_n9_v1.ckpt.npz"
    done = resident_search(NQueensProblem(9), m=8, M=64, K=2, device=cuda,
                           resume_from=str(path))
    assert done.complete and done.phases[0].tree == 734
    assert (done.explored_tree, done.explored_sol) == (8393, 352)


# -- telemetry in the dispatch graph (obs/counters.py, obs/phases.py) ----------

# The body's kernels a cycle, by (kind, streamed): the launches, then the
# condition node; armed, the marks sit around and between the launches.
_BODY = {("lb1", False): ["cycle_bounds", "cycle_count", "cycle_emit"],
         ("lb2", False): ["lb2_cycle_bounds", "cycle_count", "cycle_emit"],
         ("nqueens", False): ["nq_cycle_labels", "nq_cycle_emit"],
         ("lb1", True): ["lb1_tiles_bounds", "pfsp_tiles_count",
                         "pfsp_tiles_emit"],
         ("lb2", True): ["lb2_tiles_bounds", "pfsp_tiles_count",
                         "pfsp_tiles_emit"],
         ("nqueens", True): ["nq_tiles_labels", "nq_tiles_emit"]}


def _body_names(graph) -> list[str]:
    """The body's kernels by short name, in graph order."""
    shorts = {s for v in _BODY.values() for s in v} | {
        "dispatch_cond_obs", "dispatch_cond", "phase_mark"}
    out = []
    for mangled in graph.kernels():
        hits = [s for s in shorts if s in mangled]
        out.append(max(hits, key=len) if hits else mangled)
    return out


@pytest.mark.parametrize("armed", ["off", "obs", "phaseprof"])
@pytest.mark.parametrize("kind,mt", _GRAPH_CASES)
def test_armed_graph_counts_as_the_plain_update(cuda, monkeypatch, kind, mt,
                                                armed):
    from tpu_tree_search_torch.obs import counters as OC
    from tpu_tree_search_torch.obs import phases as OP
    from tpu_tree_search_torch.ops import dispatch as D

    monkeypatch.delenv("TTS_OBS", raising=False)
    monkeypatch.delenv("TTS_PHASEPROF", raising=False)
    if armed == "obs":
        monkeypatch.setenv("TTS_OBS", "1")
    if armed == "phaseprof":
        monkeypatch.setenv("TTS_PHASEPROF", "1")
    K, M = 7, 256
    prog, fr, best = _graph_program(cuda, kind, mt, K, M)
    state = prog.init_state(fr, best)
    ref = prog.init_state(fr, best)
    prog.host_slots(1)
    D.dispatch_cond_obs.launches = D.phase_mark_cuda.launches = 0
    got = prog.enqueue(state)(full=True)
    g = next(iter(prog._graphs.values()))
    cycle = _BODY[kind, mt is not None]
    marks = 0
    if armed == "off":
        # The cycle sets the loop condition itself: no condition node.
        assert g.own_cond and _body_names(g) == cycle
        assert got.ctr is None and got.ph is None
    else:
        n = prog.problem.child_slots
        ref.st[C.ST_TREE:C.ST_CYCLES + 1] = 0
        for _ in range(K):
            if kind == "nqueens":
                CN.cycle_nqueens_plain(ref.pool_vals, ref.pool_aux, ref.st, 12,
                                       1, M, 25, K)
            else:
                (C.cycle_lb1_plain if kind == "lb1" else C.cycle_lb2_plain)(
                    ref.pool_vals, ref.pool_aux, ref.st, prog.tables, M, 25, K)
            D.dispatch_cond_obs_plain(ref.st, n, 25, M * n, prog.capacity, K)
        torch.cuda.synchronize()
        assert got.ctr == ref.st[C.ST_CTR:C.ST_CTR + OC.NSLOTS].tolist()
        assert got.ctr[OC.IDX["overflow"]] == 0
        assert got.ctr[OC.IDX["push_rows"]] == K * M * n
        assert D.dispatch_cond_obs.launches == K
        names = _body_names(g)
        if armed == "obs":
            assert names == cycle + ["dispatch_cond_obs"]
            assert got.ph is None
        else:
            marks = len(cycle) + 1
            body = ["phase_mark"]
            for launch in cycle:
                body += [launch, "phase_mark"]
            assert names == body + ["dispatch_cond_obs"]
            ph = got.ph
            assert sum(ph[OP.IDX[s]] for s in OP.CYCLE_SLOTS) == ph[
                OP.IDX["total"]] > 0
            charged = {s for s in OP.CYCLE_SLOTS if ph[OP.IDX[s]] > 0}
            assert charged <= ({"eval", "push"} if kind == "nqueens"
                               else {"eval", "compact", "push"})
            assert ph[OP.IDX["pop"]] == ph[OP.IDX["overflow"]] == 0
            # The seed node outside the body: init, seed, while.
            assert len(g.kernels(body=False)) == 3
    assert D.phase_mark_cuda.launches == marks * K + (marks > 0)
    assert got[:5] == prog.read_scalars(state)
    prog.close()


def test_unfused_step_marks_and_counts_on_the_card(cuda, monkeypatch):
    from tpu_tree_search_torch.ops import dispatch as D

    monkeypatch.setenv("TTS_PHASEPROF", "1")
    D.phase_mark_cuda.launches = 0
    res = resident_search(NQueensProblem(10), m=8, M=64, K=16, device=cuda,
                          fused=False)
    assert (res.explored_tree, res.explored_sol) == (NQ10["tree"], NQ10["sol"])
    ph = res.phase_profile
    assert sum(ph[s] for s in ("pop", "eval", "compact", "push",
                               "overflow")) == ph["total"] > 0
    c = res.obs["device_counters"]
    assert c["pushed"] == res.phases[1].tree
    # Five marks a cycle (loop, pop, eval, compact, push) and a seed a
    # dispatch.
    cycles = res.diagnostics.kernel_launches
    assert D.phase_mark_cuda.launches == 5 * cycles + res.dispatches
    assert all(r.get("pct_of_peak", 0) <= 100 for r in res.roofline["phases"])


def test_globaltimer_steps(cuda):
    from tpu_tree_search_torch.ops import dispatch as D

    step = D.globaltimer_step_ns(cuda)
    assert step["step_ns"] is not None and 0 < step["step_ns"] <= 1000


# -- the program cache and the batched graph (engine/batched.py) ----------------


def test_second_search_builds_no_dispatch_graph(cuda):
    """The program (and its state) is cached on the problem: a second
    same-class search reuses its graphs."""
    from tpu_tree_search_torch.engine.resident import release_programs

    prob = NQueensProblem(10)
    first = resident_search(prob, m=25, M=1024, K=64, device=cuda)
    (prog,) = prob._resident_programs.values()
    graphs = dict(prog._graphs)
    second = resident_search(prob, m=25, M=1024, K=64, device=cuda)
    assert first.graph_build_s > 0 and second.graph_build_s == 0
    assert prog._graphs == graphs and len(graphs) == 1
    for res in (first, second):
        assert (res.explored_tree, res.explored_sol) == (NQ10["tree"],
                                                         NQ10["sol"])
    assert release_programs(prob) == 1 and not prog._graphs


def _batch_case(cuda, kind, B=4, K=4, M=256, C_=1 << 16):
    """A B-slot program of ``kind`` and one frontier a slot: a full one, a
    smaller one, an empty slot and one below m (retired)."""
    from tpu_tree_search_torch.engine.batched import make_batched_program

    prog, fr, best = _graph_program(cuda, kind, None, K, M)
    prog.close()
    prob = prog.problem
    cut = {k: v[:300] for k, v in fr.items()}
    low = {k: v[:10] for k, v in fr.items()}
    fronts = [fr, cut, None, low][:B]
    bp = make_batched_program(prob, B, 25, M, K, C_, cuda)
    for i, f in enumerate(fronts):
        bp.make_slot(i, f, best if f is not None else 0)
    return bp, fronts, best


@pytest.mark.parametrize("kind", ["lb1", "lb2", "nqueens"])
def test_batched_graph_matches_b_solo_graphs(cuda, kind):
    """One batched K = 4 dispatch (kernels 2, 8 or 4 captured a slot) against
    each slot's solo graph dispatch: equal counts, state words (all but
    ST_ACTIVE, the cycle's own flag) and live pool rows; each wrapper's
    launches are the slots' summed cycles, batch_cond's the rounds."""
    from tpu_tree_search_torch.engine.resident import make_program
    from tpu_tree_search_torch.ops import dispatch as D

    K, M = 4, 256
    bp, fronts, best = _batch_case(cuda, kind, K=K, M=M)
    wrapper = _graph_wrapper(kind, None)
    D.batch_cond.launches = D.batch_init.launches = 0
    reads = bp.step()
    launches = wrapper.launches
    assert bp.graph_build_s > 0 and len(bp._graphs) == 1
    assert wrapper.captures == 4  # one a slot
    cycles = [r[2] for r in reads]
    assert cycles[0] == K and cycles[1] >= 1 and cycles[2:] == [0, 0]
    assert launches == sum(cycles)
    assert (D.batch_init.launches, D.batch_cond.launches) == (1, max(cycles))
    solo = make_program(bp.problem, 25, M, K, 1 << 16, cuda)
    solo.host_slots(1)
    words = [i for i in range(C.ST_LEN) if i != C.ST_ACTIVE]
    for i, f in enumerate(fronts):
        if f is None:
            assert reads[i][3] == 0
            continue
        state = solo.init_state(f, best)
        assert solo.enqueue(state)() == reads[i][:5]
        size = reads[i][3]
        assert torch.equal(bp.st[i, words], state.st[words])
        assert torch.equal(bp.states[i].pool_vals[:size],
                           state.pool_vals[:size])
        assert torch.equal(bp.states[i].pool_aux[:size],
                           state.pool_aux[:size])
    solo.close()
    bp.close()


@pytest.mark.parametrize("obs", ["0", "1"])
def test_batch_cond_kernels_match_their_plain_versions(cuda, monkeypatch, obs):
    """The batched graph on the card (batch_init, the slots' cycles,
    batch_cond or with TTS_OBS=1 batch_cond_obs) against the same batch on
    the CPU (the plain cycles, batch_init_plain, batch_cond_plain): every
    slot's words, the counter block included, and its live rows."""
    from tpu_tree_search_torch.engine.batched import make_batched_program

    monkeypatch.setenv("TTS_OBS", obs)
    bp, fronts, best = _batch_case(cuda, "lb1")
    ref = make_batched_program(bp.problem, 4, 25, 256, 4, 1 << 16, "cpu")
    for i, f in enumerate(fronts):
        ref.make_slot(i, f, best if f is not None else 0)
    for _ in range(2):
        got, want = bp.step(), ref.step()
        assert got == want
    words = [i for i in range(C.ST_LEN) if i != C.ST_ACTIVE]
    assert torch.equal(bp.st[:, words].cpu(), ref.st[:, words])
    for i, r in enumerate(want):
        assert torch.equal(bp.states[i].pool_vals[:r[3]].cpu(),
                           ref.states[i].pool_vals[:r[3]])
    if obs == "1":
        assert bp.obs and got[0][5][0] > 0
        assert bp._graphs and "batch_cond_obs" in "".join(
            next(iter(bp._graphs.values())).kernels())
    bp.close()
    ref.close()


def test_admission_builds_no_graph(cuda):
    """Splicing new frontiers into the slots copies into their tensors: the
    next dispatch runs the same graph."""
    bp, fronts, best = _batch_case(cuda, "nqueens")
    bp.step()
    graphs, build_s = dict(bp._graphs), bp.graph_build_s
    for i in range(4):
        bp.make_slot(i, fronts[0], best)
    reads = bp.step()
    assert bp._graphs == graphs and bp.graph_build_s == build_s
    assert [r[:4] for r in reads] == [reads[0][:4]] * 4
    bp.close()


def test_batched_search_goldens_and_summed_runs(cuda):
    """batched_search on the card: every job at the N=10 goldens, and kernel
    4's launches are the jobs' summed device cycles (a solo run's times
    three)."""
    from tpu_tree_search_torch.engine.batched import batched_search

    solo = resident_search(NQueensProblem(10), m=25, M=1024, K=16,
                           device=cuda)
    CN.cycle_nqueens_cuda.launches = 0
    got = batched_search(NQueensProblem(10), 3, 2, m=25, M=1024, K=16,
                         device=cuda)
    assert [(r.explored_tree, r.explored_sol) for r in got] == \
        [(NQ10["tree"], NQ10["sol"])] * 3
    assert CN.cycle_nqueens_cuda.launches == \
        3 * solo.diagnostics.kernel_launches


# -- the multi-device tiers (parallel/) and the thread-safe build ----------------


def _mesh_state(dev, D, n, sizes, seed):
    g = torch.Generator().manual_seed(seed)
    st = torch.randint(0, 1000, (D, C.ST_LEN), generator=g, dtype=torch.int32)
    st[:, 0] = torch.tensor(sizes, dtype=torch.int32)
    vals = torch.randint(0, n, (D, 5000, n), generator=g, dtype=torch.int8)
    aux = torch.randint(-1, n - 1, (D, 5000), generator=g, dtype=torch.int8)
    return st.to(dev), vals.to(dev), aux.to(dev)


@pytest.mark.parametrize("sizes,first,last", [
    ([3000], True, True),
    ([2000, 0], True, False),           # a gift of T; kept rows overlap
    ([2500, 10, 90, 0], False, True),   # two gifts
    ([900, 100, 60, 50], False, False),  # none
    ([2000, 0, 3000, 5, 900, 0, 1500, 1], True, False),  # D / 2 staging slots
])
def test_mesh_balance_matches_plain(cuda, sizes, first, last):
    """The balance step's three launches against ``mesh_balance_plain``:
    every word of every shard and every live row."""
    from tpu_tree_search_torch.ops import mesh as MS

    D, n, m, T, Mn = len(sizes), 15, 25, 1024, 1000
    st, vals, aux = _mesh_state(cuda, D, n, sizes, len(sizes))
    ref = [t.clone() for t in (st, vals, aux)]
    MS.mesh_balance_cuda(st, vals, aux, MS.MeshScratch.make(vals, aux), m, T,
                         Mn, first, last)
    MS.mesh_balance_plain(*ref, m, T, Mn, first, last)
    torch.cuda.synchronize()
    assert torch.equal(st, ref[0])
    for d in range(D):
        s = int(ref[0][d, 0])
        assert torch.equal(vals[d, :s], ref[1][d, :s])
        assert torch.equal(aux[d, :s], ref[2][d, :s])


@pytest.mark.parametrize("kind", ["nqueens", "lb1", "lb2"])
def test_mesh_graph_dispatch_matches_the_plain_program(cuda, kind):
    """One mesh dispatch on the card (the graph: rounds of batch_init, the
    shards' cycles, mesh_balance) against the same program on the CPU (the
    plain cycles and balance): a full shard, a starving one (it takes a
    gift), a partial one and an empty one."""
    from tpu_tree_search_torch.parallel.resident_mesh import MeshProgram

    prog, fr, best = _graph_program(cuda, kind, None, 4, 256)
    prog.close()
    prob = prog.problem
    fronts = [fr, {k: v[:10] for k, v in fr.items()},
              {k: v[:300] for k, v in fr.items()}, None]
    out = []
    for dev in (cuda, torch.device("cpu")):
        mp = MeshProgram(prob, 4, 25, 256, 4, 2, 64, 1 << 15, dev)
        for d, f in enumerate(fronts):
            if f is None:
                mp.st[d].copy_(C.new_state(0, best, dev))
            else:
                mp.inner.load_state(mp.states[d], f, best)
        mp.host_slots(1)
        rows, _, ms = mp.enqueue()()
        out.append((mp, rows, ms))
    (g, grows, gms), (p, prows, pms) = out
    assert grows == prows and gms is not None and pms is None
    assert sum(r[C.ST_CYCLES] for r in grows) > 0
    for d in range(4):
        s = grows[d][0]
        assert torch.equal(g.pool_vals[d, :s].cpu(), p.pool_vals[d, :s])
        assert torch.equal(g.pool_aux[d, :s].cpu(), p.pool_aux[d, :s])
    g.close()
    p.close()


@pytest.mark.parametrize("D", [2, 4])
def test_multi_tier_on_one_card_hits_goldens(cuda, D):
    """D worker threads on the one card, each on its own stream."""
    from tpu_tree_search_torch.parallel.multidevice import multidevice_search

    nq = multidevice_search(NQueensProblem(10), m=25, M=1024, D=D, device=cuda)
    assert (nq.explored_tree, nq.explored_sol) == (NQ10["tree"], NQ10["sol"])
    assert len(nq.per_worker_tree) == D
    ptm = taillard.reduced_instance(14, jobs=10, machines=5)
    for lb in ("lb1", "lb2"):
        want = REDUCED if lb == "lb1" else REDUCED_LB2
        res = multidevice_search(PFSPProblem(lb=lb, ub=0, p_times=ptm), m=25,
                                 M=256, D=D, device=cuda,
                                 initial_best=want["best"])
        assert (res.explored_tree, res.explored_sol, res.best) == (
            want["tree"], want["sol"], want["best"])


def test_mesh_tier_hits_goldens_and_second_search_builds_no_graph(cuda):
    from tpu_tree_search_torch.engine.resident import release_programs
    from tpu_tree_search_torch.parallel.resident_mesh import (
        mesh_resident_search)

    prob = NQueensProblem(10)
    first = mesh_resident_search(prob, m=25, M=1024, D=4, device=cuda)
    (prog,) = prob._mesh_programs.values()
    graphs = dict(prog._graphs)
    second = mesh_resident_search(prob, m=25, M=1024, D=4, device=cuda)
    assert first.graph_build_s > 0 and second.graph_build_s == 0
    assert prog._graphs == graphs and len(graphs) == 1
    for res in (first, second):
        assert (res.explored_tree, res.explored_sol) == (NQ10["tree"],
                                                         NQ10["sol"])
        assert len(res.per_worker_tree) == 4 and res.dispatch_device_s > 0
    assert release_programs(prob) == 1


def test_eight_threads_cold_load_one_library(cuda, monkeypatch, tmp_path):
    """A cold build directory and eight threads asking for one library at
    once: nvcc runs once, every thread gets the same loaded library."""
    import threading

    from tpu_tree_search_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_CALL_LOCKS", {})
    monkeypatch.setattr(_build, "sources",
                        lambda: [_build.CSRC / "mesh_balance.cu"])
    real, calls = _build.build_all, []

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(_build, "build_all", counted)
    barrier = threading.Barrier(8)
    libs = []

    def load():
        barrier.wait()
        libs.append(_build.library("mesh_balance"))

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and len(libs) == 8
    assert all(lib is libs[0] for lib in libs)
    assert not list(tmp_path.glob("*.tmp.so"))


def _skew(warm, host_id, num_hosts):
    return {k: (v if host_id == 0 else v[:0]) for k, v in warm.items()}


@pytest.mark.parametrize("partition", [None, _skew])
def test_dist_virtual_hosts_on_one_card_hit_goldens(cuda, partition):
    """Two virtual hosts of two offload workers each on the one card (a
    stream a worker); the skewed start feeds host 1 by donations."""
    from tpu_tree_search_torch.parallel.dist import dist_search

    res = dist_search(NQueensProblem(10), m=25, M=1024, D=2, num_hosts=2,
                      device=cuda, steal_interval_s=0.005,
                      partition_fn=partition)
    assert (res.explored_tree, res.explored_sol) == (NQ10["tree"], NQ10["sol"])
    assert len(res.per_worker_tree) == 4 and res.diagnostics.kernel_launches > 0
    if partition is not None:
        assert res.comm["blocks_received"] > 0


def test_dist_pfsp_fixed_incumbent_on_the_card(cuda):
    from tpu_tree_search_torch.parallel.dist import dist_search

    ptm = taillard.reduced_instance(14, jobs=10, machines=5)
    for lb, want in (("lb1", REDUCED), ("lb2", REDUCED_LB2)):
        res = dist_search(PFSPProblem(lb=lb, ub=0, p_times=ptm), m=25, M=256,
                          D=2, num_hosts=2, device=cuda,
                          initial_best=want["best"])
        assert (res.explored_tree, res.explored_sol, res.best) == (
            want["tree"], want["sol"], want["best"])


def test_dist_mesh_on_one_card_hits_goldens_under_the_steal_knobs(cuda,
                                                                  monkeypatch):
    """Two virtual hosts of two shards each: the counts, host 0 on the
    program (and the one dispatch graph) a plain mesh search cached, with
    TTS_STEAL, TTS_PODS and TTS_SIM_LAT_* set: the knobs reach no graph."""
    from tpu_tree_search_torch.parallel.dist_mesh import dist_mesh_search
    from tpu_tree_search_torch.parallel.resident_mesh import (
        mesh_resident_search)

    prob = NQueensProblem(10)
    mesh_resident_search(prob, m=25, M=1024, D=2, device=cuda)
    (prog,) = prob._mesh_programs.values()
    graphs = dict(prog._graphs)
    monkeypatch.setenv("TTS_STEAL", "hier")
    monkeypatch.setenv("TTS_PODS", "0,1")
    monkeypatch.setenv("TTS_SIM_LAT_DCN", "0.0001")
    res = dist_mesh_search(prob, m=25, M=1024, D=2, num_hosts=2, device=cuda)
    assert (res.explored_tree, res.explored_sol) == (NQ10["tree"], NQ10["sol"])
    assert list(prob._mesh_programs.values()) == [prog]
    assert prog._graphs == graphs and len(graphs) == 1
    assert res.dispatch_device_s > 0 and res.steal_policy["mode"] == "hier"


def test_dist_mesh_lockstep_cut_resumes_on_the_card(cuda, tmp_path):
    from tpu_tree_search_torch.parallel.dist_mesh import dist_mesh_search

    path = str(tmp_path / "dm.npz")
    kw = dict(m=25, M=256, K=2, rounds=1, D=2, num_hosts=2, device=cuda)
    part = dist_mesh_search(NQueensProblem(10), max_steps=2,
                            checkpoint_path=path, **kw)
    assert not part.complete
    res = dist_mesh_search(NQueensProblem(10), resume_from=path, **kw)
    assert (res.explored_tree, res.explored_sol) == (NQ10["tree"], NQ10["sol"])


# -- the steady-state guard on the card (analysis/guard.py) ----------------------


def test_guard_sync_tamper_raises_and_a_clean_steady_dispatch_passes(cuda):
    """A steady-state graph enqueue passes the guard's sync check; a
    ``.item()`` slipped into one raises ``GuardViolation`` naming the
    dispatch, and the sync debug mode is off again after it."""
    from tpu_tree_search_torch.analysis.guard import (
        GuardViolation,
        SteadyStateGuard,
    )

    prog, fr, best = _graph_program(cuda, "nqueens", None, K=3)
    state = prog.init_state(fr, best)
    prog.host_slots(2)
    g = SteadyStateGuard(prog, "resident step")
    assert g.sync_check
    with g.step():  # warm: builds the graph
        read = prog.enqueue(state)
    read()
    with g.step():
        read = prog.enqueue(state)
    assert read()[2] == 3
    with pytest.raises(GuardViolation, match="synchronising call in "
                       "steady-state dispatch 3"):
        with g.step():
            read = prog.enqueue(state)
            state.st[0].item()
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert g.checked == 2
    prog.close()


def test_guarded_searches_from_two_threads_do_not_raise(cuda):
    """Two guarded resident searches at once, a thread and a stream each:
    one thread's sanctioned reads (the residual download, the final
    synchronize) while the other's guarded enqueue is open raise nothing,
    and both reach the N = 10 counts with checked dispatches."""
    import threading

    results, errors = {}, []

    def run(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(3):
                    res = resident_search(NQueensProblem(10), m=25, M=256, K=2,
                                          device=cuda, guard=True)
                    results.setdefault(i, []).append(res)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and errors == []
    for runs in results.values():
        for res in runs:
            assert (res.explored_tree, res.explored_sol) == (NQ10["tree"],
                                                             NQ10["sol"])
            assert res.guard["checked_dispatches"] >= 1
            assert res.guard["checks"] == ["builds", "sync"]
    assert torch.cuda.get_sync_debug_mode() == 0


# -- the unfused graph, the pair blocks and device positions ---------------------


def test_guarded_unfused_search_is_one_graph_launch_a_dispatch(cuda):
    """The unfused cycle of fixed shapes reads nothing back: a guarded
    N = 12 search checks its steady-state dispatches, each one graph
    launch, and kernel 3 runs once a cycle."""
    from tpu_tree_search_torch.ops.dispatch import DispatchGraph

    nqueens_kernel.nqueens_labels_cuda.launches = 0
    g0 = DispatchGraph.launches
    res = resident_search(NQueensProblem(12), m=25, M=4096, K=8, device=cuda,
                          fused=False, guard=True)
    assert (res.explored_tree, res.explored_sol) == (856188, 14200)
    assert res.guard["checked_dispatches"] > 1
    assert res.guard["checks"] == ["builds", "sync"]
    assert DispatchGraph.launches - g0 == res.dispatches
    assert (nqueens_kernel.nqueens_labels_cuda.launches
            == res.diagnostics.kernel_launches)


@pytest.mark.parametrize("mp", [2, 4])
def test_pair_blocks_equal_their_plain_versions(cuda, mp):
    """Kernels 6 and 7 on each mp pair block against the plain lb2 over the
    block's pairs, and the max of the blocks against the full-pair launch
    (kernel 6 on the open slots), ta014 and ta021."""
    rng = np.random.default_rng(mp)
    for inst in (14, 21):
        tables = PFSPProblem(inst=inst, lb="lb2", ub=1).device_tables(cuda)
        n, B = tables.jobs, 512
        prmu, limit1 = _nodes(rng, n, B)
        p = torch.from_numpy(prmu).to(cuda).to(torch.int8)
        lim = torch.from_numpy(limit1).to(cuda).to(torch.int8)
        open_ = torch.from_numpy(np.arange(n)[None, :] > limit1[:, None]).to(cuda)
        m6 = m7 = None
        for blk in tables.pair_blocks(mp):
            g6 = lb2_kernel.lb2_block_cuda(p, lim, blk)
            assert torch.equal(g6[open_], lb2_chunk(p, lim, blk)[open_])
            g7 = lb2_self_kernel.lb2_self_block_cuda(p, lim, B, blk)
            assert torch.equal(g7, lb2_self_kernel.plain(p, lim, B, blk))
            m6 = g6 if m6 is None else torch.maximum(m6, g6)
            m7 = g7 if m7 is None else torch.maximum(m7, g7)
        assert torch.equal(m6[open_],
                           lb2_kernel.lb2_bounds_cuda(p, lim, tables)[open_])
        assert torch.equal(m7, lb2_self_kernel.lb2_self_bounds_cuda(
            p, lim, B, tables))


def test_two_groups_on_one_card_equal_one_group(cuda):
    """The mesh over the positions cuda:0, cuda:0 (two groups: a graph a
    group and round, the cross-group balance) leaves every shard's state
    row and live rows of the one-group program after each dispatch, and a
    whole search the same counts and shard trees."""
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.parallel.resident_mesh import (
        get_mesh_program, mesh_resident_search)
    from tpu_tree_search_torch.pool.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    prob = NQueensProblem(10)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    _, _, best = warmup(prob, pool, INF, 300)
    a = get_mesh_program(prob, 4, 25, 256, 4, 2, 64, 1 << 15, cuda)
    b = get_mesh_program(prob, 4, 25, 256, 4, 2, 64, 1 << 15,
                         devices=["cuda:0", "cuda:0"])
    try:
        for prog in (a, b):
            prog.host_slots(1)
            prog.upload(pool.as_batch(), best)
        assert [g.shards for g in b.groups] == [[0, 2], [1, 3]]
        for _ in range(3):
            ra, rb = a.enqueue()()[0], b.enqueue()()[0]
            assert ra == rb
            for d in range(4):
                s = ra[d][0]
                assert torch.equal(a.states[d].pool_vals[:s],
                                   b.states[d].pool_vals[:s])
                assert torch.equal(a.states[d].pool_aux[:s],
                                   b.states[d].pool_aux[:s])
    finally:
        a.release()
        b.release()
    one = mesh_resident_search(NQueensProblem(10), m=25, M=256, D=4,
                               device=cuda)
    two = mesh_resident_search(NQueensProblem(10), m=25, M=256, D=4,
                               devices=["cuda:0", "cuda:0"], guard=True)
    assert (two.explored_tree, two.explored_sol) == (NQ10["tree"], NQ10["sol"])
    assert two.per_worker_tree == one.per_worker_tree


@pytest.mark.parametrize("mp", [1, 2])
def test_unfused_mesh_gates_frozen_shards(cuda, mp):
    """The unfused mesh dispatch (each shard's cycle under its own ``if``
    node after a ``slot_gate``) against the same program on the CPU, a
    full shard, a starving one, a partial one and an empty one: equal
    rows; the body holds a gate and an ``if`` node a shard and no cycle
    node outside one, so a frozen shard launches nothing; the wrapper's
    count of the bound kernel (kernel 3; kernel 6 on pair blocks under mp)
    is the shards' runs and the gate's D a round, and a ``torch.profiler``
    trace holds at most as many launches of either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.ops import dispatch as Dp
    from tpu_tree_search_torch.ops.mesh import ST_MESH_COND
    from tpu_tree_search_torch.parallel.resident_mesh import MeshProgram
    from tpu_tree_search_torch.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    if mp == 1:
        prob, best, M, kernel, fn = (NQueensProblem(12), INF, 256,
                                     "nqueens_labels_kernel",
                                     nqueens_kernel.nqueens_labels_cuda)
    else:
        prob = PFSPProblem(inst=14, lb="lb2", ub=1)
        best, M, kernel, fn = (prob.initial_ub, 64, "lb2_bounds_kernel",
                               lb2_kernel.lb2_block_cuda)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    warmup(prob, pool, best, 600)
    fr = pool.as_batch()
    fronts = [fr, {k: v[:10] for k, v in fr.items()},
              {k: v[:300] for k, v in fr.items()}, None]
    out = []
    for dev in (cuda, torch.device("cpu")):
        prog = MeshProgram(prob, 4, 25, M, 4, 2, 64, 1 << 15, dev,
                           fused=False, staged=False, mp=mp)
        for d, f in enumerate(fronts):
            if f is None:
                prog.st[d].copy_(C.new_state(0, best, dev))
            else:
                prog.inner.load_state(prog.states[d], f, best)
        prog.host_slots(1)
        if dev.type == "cuda":
            # The graph is built inside the trace (CUPTI misses node
            # launches of a graph built before the trace began).
            fn.launches = Dp.slot_gate.launches = 0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                rows = prog.enqueue()()[0]
                torch.cuda.synchronize()
            traced = {k: sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA and k in e.key)
                      for k in (kernel, "slot_gate")}
            # Each round's while body: a gate and an if node a shard, then
            # batch_cond; no cycle node outside an if node.
            body = prog.graph().kernels()
            assert body.count("-") == 4 and sum(
                "slot_gate" in k for k in body) == 4 and len(body) == 9
        else:
            rows = prog.enqueue()()[0]
        out.append((prog, rows))
    (g, grows), (p, prows) = out
    try:
        assert grows == prows
        runs = sum(r[C.ST_RUNS] for r in grows)
        assert 0 < runs < 4 * grows[0][ST_MESH_COND]  # some shard froze
        # CUPTI loses records of a conditional body's nodes (PERF.md §7),
        # never adds one.
        assert traced[kernel] <= fn.launches == mp * runs
        assert 0 < traced["slot_gate"] <= Dp.slot_gate.launches == (
            4 * grows[0][ST_MESH_COND])
        for d in range(4):
            s = grows[d][0]
            assert torch.equal(g.pool_vals[d, :s].cpu(), p.pool_vals[d, :s])
            assert torch.equal(g.pool_aux[d, :s].cpu(), p.pool_aux[d, :s])
    finally:
        g.close()
        p.close()


def test_unfused_batched_graph_gates_frozen_slots(cuda):
    """A batched lb1_d dispatch (the unfused cycle, each slot's under its
    own ``if`` node, no cycle node outside one): kernel 5's count is the
    slots' summed cycles and ``slot_gate``'s B a round, and a
    ``torch.profiler`` trace holds at most as many launches of either;
    each slot equals its solo dispatch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_tree_search_torch.engine.resident import make_program
    from tpu_tree_search_torch.ops import dispatch as D

    K, M = 4, 256
    bp, fronts, best = _batch_case(cuda, "lb1_d", K=K, M=M)
    assert not bp.inner.fused
    fn = lb1_d_kernel.lb1_d_bounds_cuda
    fn.launches = D.slot_gate.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reads = bp.step()
        torch.cuda.synchronize()
    traced = {k: sum(e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and k in e.key)
              for k in ("lb1_d_bounds_kernel", "slot_gate")}
    cycles = [r[2] for r in reads]
    assert cycles[0] == K and cycles[1] >= 1 and cycles[2:] == [0, 0]
    # CUPTI loses records of a conditional body's nodes, never adds one.
    assert traced["lb1_d_bounds_kernel"] <= fn.launches == sum(cycles)
    assert 0 < traced["slot_gate"] <= D.slot_gate.launches == 4 * max(cycles)
    body = bp.graph().kernels()
    assert body.count("-") == 4 and len(body) == 9
    solo = make_program(bp.problem, 25, M, K, 1 << 16, cuda)
    solo.host_slots(1)
    words = [i for i in range(C.ST_LEN) if i != C.ST_ACTIVE]
    try:
        for i, f in enumerate(fronts):
            if f is None:
                continue
            state = solo.init_state(f, best)
            assert solo.enqueue(state)() == reads[i][:5]
            size = reads[i][3]
            assert torch.equal(bp.st[i, words], state.st[words])
            assert torch.equal(bp.states[i].pool_vals[:size],
                               state.pool_vals[:size])
    finally:
        solo.close()
        bp.close()


# -- the survivor-path modes and the program contracts on the card -------------


@pytest.mark.parametrize("mode", ["scatter", "sort", "search", "dense"])
def test_guarded_unfused_search_under_each_mode(cuda, monkeypatch, mode):
    """Each survivor-path mode keeps the unfused cycle free of host reads:
    a guarded N = 12 search under it checks its steady-state dispatches
    and hits the counts."""
    monkeypatch.setenv("TTS_COMPACT", mode)
    res = resident_search(NQueensProblem(12), m=25, M=4096, K=8, device=cuda,
                          fused=False, guard=True)
    assert (res.explored_tree, res.explored_sol) == (856188, 14200)
    assert (res.compact, res.compact_auto) == (mode, False)
    assert res.guard["checked_dispatches"] > 1


def test_check_on_the_card_finds_nothing(cuda):
    """`check --device cuda` on the N-Queens cells: each dispatch graph's
    nodes, names and types, held to the contracts."""
    from tpu_tree_search_torch.analysis import program_audit as PA

    res = PA.run_check(families=["nqueens"], device=cuda, with_locks=False)
    assert res.findings == [], [f.render() for f in res.findings]
    art = PA.record_cell(PA.Cell("nqueens", compact="sort"), device=cuda)
    kinds = {k for _, k in art.nodes["body"]}
    assert "kernel" in kinds and not kinds & {"host", "memcpy_host"}
    outer = [k for _, k in art.nodes["outer"]]
    assert len(outer) == 2 and outer.count("kernel") == 1  # init, while


def test_nested_graph_bodies_are_read_on_the_card(cuda):
    """The graphs nested in a dispatch graph's body (a batch slot's gated
    body, a mesh round's body, its shards' gated bodies and its balance
    step) are in the node lists the audit reads: kernels, and no host node
    or memcpy with a host end."""
    from tpu_tree_search_torch.analysis import program_audit as PA

    host = {"host", "memcpy_host"}
    nodes = PA.batched_artifact(2, False, cuda)["record"].nodes
    for part in ("gate0", "gate1"):
        kinds = {k for _, k in nodes[part]}
        assert "kernel" in kinds and not kinds & host, part
    rec = PA.mesh_record(False, cuda)
    assert {"round1", "round0.gate0", "round1.gate1", "round0.balance",
            "round1.balance"} <= set(rec.nodes)
    for part, got in rec.nodes.items():
        assert not {k for _, k in got} & host, part
    assert any(k == "kernel" for _, k in rec.nodes["round0.gate1"])


# -- the pair exchange of the mesh's shard copies (csrc/pair_exchange.cu) ------


def _exchange_pair(cuda, words, timeout_s=5.0):
    from tpu_tree_search_torch.ops.pair_exchange import PairExchange

    x = PairExchange([cuda, cuda], words, timeout_s=timeout_s)
    return x, [x.endpoint(i) for i in range(2)], [torch.cuda.Stream(cuda)
                                                  for _ in range(2)]


def test_pair_exchange_parity_slots_match_plain(cuda):
    # Seven exchanges in a row: both parity slots, several times over, the
    # whole plane and a live count; each copy on a stream of its own.
    x, ends, streams = _exchange_pair(cuda, 4099)
    rng = np.random.default_rng(20)
    cur = torch.cuda.current_stream(cuda)
    for step in range(7):
        a, b = (torch.from_numpy(rng.integers(-2**30, 2**30, 4099)
                                 .astype(np.int32)).to(cuda) for _ in range(2))
        want = torch.maximum(a, b)
        count = None if step % 3 else torch.tensor(1000 + step, dtype=torch.int32,
                                                   device=cuda)
        got = [a.clone(), b.clone()]
        for st in streams:
            st.wait_stream(cur)
        for e, st, plane in zip(ends, streams, got):
            with torch.cuda.stream(st):
                e(plane, count)
        torch.cuda.synchronize()
        for e in ends:
            e.check()
        n = 4099 if count is None else int(count)
        for plane, own in zip(got, (a, b)):
            assert torch.equal(plane[:n], want[:n])
            assert torch.equal(plane[n:], own[n:])


def test_pair_exchange_missing_peer_times_out(cuda):
    import time

    x, ends, streams = _exchange_pair(cuda, 256, timeout_s=0.3)
    plane = torch.zeros(256, dtype=torch.int32, device=cuda)
    t0 = time.perf_counter()
    with torch.cuda.stream(streams[0]):
        ends[0](plane)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 3.0
    with pytest.raises(RuntimeError, match="never posted"):
        ends[0].check()


def test_pair_exchange_across_two_cards(cuda):
    from tpu_tree_search_torch.ops.pair_exchange import PairExchange

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: peer access between cards")
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    if not torch.cuda.can_device_access_peer(0, 1):
        with pytest.raises(RuntimeError, match="no peer access"):
            PairExchange(devs, 64)
        return
    x = PairExchange(devs, 64)
    ends = [x.endpoint(i) for i in range(2)]
    planes = [torch.arange(64, dtype=torch.int32, device=d) * (1 if i else -1)
              for i, d in enumerate(devs)]
    for e, d, p in zip(ends, devs, planes):
        with torch.cuda.device(d), torch.cuda.stream(torch.cuda.Stream(d)):
            e(p)
    for d in devs:
        torch.cuda.synchronize(d)
    for e in ends:
        e.check()
    want = torch.arange(64, dtype=torch.int32)
    assert all(torch.equal(p.cpu(), want) for p in planes)


def test_mesh_copies_equal_one_position_on_the_card(cuda):
    # ta014's reduced corner under lb2, D = 2, mp = 2: each shard copied
    # on two positions of the card, dispatch by dispatch against the
    # one-position program.
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.parallel.resident_mesh import (get_mesh_program,
                                                              loop_rows)
    from tpu_tree_search_torch.pool.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    prob = PFSPProblem(lb="lb2", ub=0,
                       p_times=taillard.reduced_instance(14, jobs=10, machines=5))
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    _, _, best = warmup(prob, pool, INF, 200)
    for staged in (True, False):
        a = get_mesh_program(prob, 2, 4, 32, 2, 2, 8, 4 * 32 * 10, cuda,
                             fused=False, staged=staged, mp=2)
        b = get_mesh_program(prob, 2, 4, 32, 2, 2, 8, 4 * 32 * 10, fused=False,
                             staged=staged, mp=2, devices=["cuda:0"] * 2)
        try:
            assert b.copied and len(b.groups) == 2
            for prog in (a, b):
                prog.host_slots(1)
                prog.upload(pool.as_batch(), best)
            for _ in range(3):
                ra, rb = a.enqueue()()[0], b.enqueue()()[0]
                assert loop_rows(ra) == loop_rows(rb)
                for d, _, state in b.copy_states():
                    s = ra[d][0]
                    assert torch.equal(a.states[d].pool_vals[:s], state.pool_vals[:s])
        finally:
            a.release()
            b.release()
