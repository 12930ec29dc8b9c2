"""The port's streamed (tiled) cycle and eval-only pass against the JAX ones.

On the CPU, at M=64 and tile widths mt in {8, 16}, on the 8-job instance of
``_ptm(311)`` (`tests/test_megakernel.py`) and N-Queens N=8:

  * ``tiled_chunk_plain`` equals the Pallas tiled megakernels
    (``_nqueens_tiled_call``, ``_lb1_tiled_call``, ``_lb2_tiled_call``) in
    interpret mode, fed the operands ``make_cycle`` passes: each tile's live
    rows and aux (rows past a tile's count are garbage in the JAX output and
    not compared), all four scalar lanes of every tile, and the cycle's
    tree_inc, sol_inc and best, with a finite and an INF incumbent and a
    partial chunk;
  * the stitched pool of ``tiled_cycle_plain`` equals the single-tile
    ``cycle_*_plain`` (the point of the stitch);
  * ``resident_search(mt=16)`` gives the counts of the JAX
    ``resident_search`` under ``TTS_MEGAKERNEL=force`` and
    ``TTS_MEGAKERNEL_MT=16``, and those of ``mt=None``;
  * ``streamed_eval_bounds`` equals the JAX ``streamed_eval_bounds`` in
    interpret mode (lb1 and lb2 on the open slots, N-Queens on every slot),
    and ``megakernel_lb2_bounds`` the JAX one on the open slots;
  * a tile width that is not a multiple of 8 dividing M raises, and ``mt``
    is inert on the unfused cycle and under lb1_d;
  * the carry of kernels 9a, 9b and 9c, as a numpy model in the kernels'
    block order (``_carry_model``), gives the (G, 4) scalars of
    ``tiled_chunk_plain`` and of the Pallas tiled kernels (interpret mode),
    for N-Queens, lb1 and lb2, at M = 120, 240 and 400 (not multiples of 32, so
    tile boundaries fall inside blocks of 32 parents) and mt in {8, 16, 40,
    80}, on full, partial and tail windows (tiles with no popped row);
    ``TileBoundsScratch.scal`` reads the model's boundary row as the plain
    scalars; and the sources of 9a, 9b and 9c hold no look-back.

Tolerance 0: everything is integer. The CUDA kernels 9a-9c are compared with
these plain versions on the card in `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.engine.resident import resident_search as jax_resident_search
from tpu_tree_search.ops import megakernel as MK
from tpu_tree_search.ops import pfsp_device as jdev
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine.resident import make_program, resident_search
from tpu_tree_search_torch.ops import cycle as C
from tpu_tree_search_torch.ops import cycle_nqueens as CN
from tpu_tree_search_torch.ops import tiled as T
from tpu_tree_search_torch.ops.nqueens_device import labels_chunk
from tpu_tree_search_torch.ops.pfsp_device import lb1_chunk, lb2_chunk
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

INF = 2**31 - 1
CPU = torch.device("cpu")
M = 64
N_QUEENS = 8
PLAIN_CYCLES = {"lb1": C.cycle_lb1_plain, "lb2": C.cycle_lb2_plain}
TILED_PLAIN = {"lb1": T.tiled_lb1_plain, "lb2": T.tiled_lb2_plain}
BOUNDS = {"lb1": lb1_chunk, "lb2": lb2_chunk}


def _ptm(seed: int, jobs: int = 8, machines: int = 5) -> np.ndarray:
    """`tests/test_megakernel.py`'s random instance."""
    rng = np.random.default_rng(seed)
    return np.ascontiguousarray(
        rng.integers(1, 100, size=(machines, jobs)).astype(np.int32))


PTM = _ptm(311)
JOBS = PTM.shape[1]


def _problems(family):
    """(JAX problem, port problem) of a family: nqueens, lb1 or lb2."""
    if family == "nqueens":
        return JaxNQueens(N=N_QUEENS), NQueensProblem(N=N_QUEENS)
    return (JaxPFSP(lb=family, ub=0, p_times=PTM),
            PFSPProblem(lb=family, ub=0, p_times=PTM))


def _chunk(rng, family, B, deep=0.25):
    """Seeded parents: PFSP partial permutations with a share ``deep`` one
    swap from complete (their children are leaves); N-Queens boards with a
    share at depth N (popped solutions)."""
    if family == "nqueens":
        board = np.stack([rng.permutation(N_QUEENS) for _ in range(B)])
        depth = rng.integers(0, N_QUEENS, B)
        depth[rng.random(B) < 0.2] = N_QUEENS
        return board.astype(np.uint8), depth.astype(np.int32)
    prmu = np.stack([rng.permutation(JOBS) for _ in range(B)])
    limit1 = rng.integers(-1, JOBS - 2, B)
    limit1[rng.random(B) < deep] = JOBS - 2
    return prmu.astype(np.int32), limit1.astype(np.int32)


def _jax_tiled(family, jprob, vals, aux, valid, best, mt):
    """The JAX tiled megakernel on one chunk of M = len(vals) parents, with
    the operands ``make_cycle`` passes (`megakernel.py:1033-1098`). Returns
    (rows, caux, the (G, 4) scalar lanes)."""
    M = vals.shape[0]
    head = (jnp.asarray(vals.astype(np.int32)), jnp.asarray(aux)[:, None],
            jnp.asarray(valid.astype(np.int32))[:, None],
            jnp.asarray([best], dtype=jnp.int32))
    if family == "nqueens":
        call = MK._nqueens_tiled_call(jprob.N, jprob.g, M, mt, True)
        rows, caux, scal = call(*head)
    else:
        n, m = jprob.jobs, jprob.machines
        t = jdev.PFSPDeviceTables(jprob.lb1_data, jprob.lb2_data)
        bf16 = bool(t.exact_bf16)
        if family == "lb1":
            call = MK._lb1_tiled_call(n, m, M, mt, bf16, True)
            rows, caux, scal = call(*head, t.ptm_t, t.min_heads[None, :],
                                    t.min_tails[None, :])
        else:
            pg = jdev.lb2_kernel_pair_group(t.pairs.shape[0], n)
            o = t.johnson_ordered_mp(pg)
            call = MK._lb2_tiled_call(n, m, o.lag_o.shape[0], M, mt, pg, bf16,
                                      True)
            rows, caux, scal = call(
                *head, t.ptm_t, t.min_heads[None, :], o.p0_o[:, None, :],
                o.p1_o[:, None, :], o.lag_o[:, None, :], o.tails0, o.tails1,
                o.msel0[:, None, :], o.msel1[:, None, :], o.jorder)
    return (np.asarray(rows), np.asarray(caux)[:, 0],
            np.asarray(scal)[:, :4])


def _spec(family, tprob):
    return tprob if family == "nqueens" else tprob.device_tables(CPU)


def _incumbent(family, tprob, vals, aux, finite):
    """INF, or a finite incumbent that half the chunk's leaves improve on."""
    if family == "nqueens" or not finite:
        return INF
    n = vals.shape[1]
    lb = BOUNDS[family](torch.from_numpy(vals), torch.from_numpy(aux),
                        tprob.device_tables(CPU)).numpy()
    leaf = (np.arange(n)[None, :] > aux[:, None]) & (aux[:, None] == n - 2)
    return int(np.median(lb[leaf]))


@pytest.mark.parametrize("case", ["finite_full", "inf_partial"])
@pytest.mark.parametrize("mt", [8, 16])
@pytest.mark.parametrize("family", ["nqueens", "lb1", "lb2"])
def test_tiled_chunk_plain_matches_pallas_tiled_kernel(family, mt, case):
    jprob, tprob = _problems(family)
    rng = np.random.default_rng(mt + len(family) + len(case))
    vals, aux = _chunk(rng, family, M)
    best = _incumbent(family, tprob, vals, aux, case == "finite_full")
    valid = np.ones(M, dtype=bool)
    if case == "inf_partial":
        valid[:] = False
        valid[5:51] = True
    rows_j, caux_j, scal_j = _jax_tiled(family, jprob, vals, aux, valid, best,
                                        mt)
    tv = torch.from_numpy(vals).to(torch.uint8 if family == "nqueens"
                                   else torch.int8)
    rows, caux, offs, tree, sol, best_t, scal = T.tiled_chunk_plain(
        _spec(family, tprob), tv, torch.from_numpy(aux).to(torch.int8),
        torch.from_numpy(valid), torch.tensor(best, dtype=torch.int32), mt,
        BOUNDS.get(family, lb1_chunk))
    G = M // mt
    n = vals.shape[1]
    assert np.array_equal(scal.numpy(), scal_j)
    assert np.array_equal(offs.numpy(), scal_j[:, 0])
    last = scal_j[G - 1]
    assert (int(tree), int(sol), int(best_t)) == (last[0] + last[1], last[2],
                                                  last[3])
    assert int(tree) > 0 and int(sol) > 0
    if family != "nqueens" and case == "finite_full":
        assert int(best_t) < best  # a leaf improved the incumbent
    for t in range(G):
        lo, cnt = t * mt * n, int(scal_j[t, 1])
        assert np.array_equal(rows[lo:lo + cnt].numpy(), rows_j[lo:lo + cnt])
        assert np.array_equal(caux[lo:lo + cnt].numpy(), caux_j[lo:lo + cnt])


def _pool(rng, family, size, C_rows):
    # One PFSP parent of leaves, the last (popped in the last tile): each
    # leaf lowers the incumbent that prunes the interior children.
    vals, aux = _chunk(rng, family, size, deep=0.0)
    if family != "nqueens":
        aux[-1] = JOBS - 2
    dtype = torch.uint8 if family == "nqueens" else torch.int8
    pool_vals = torch.zeros((C_rows, vals.shape[1]), dtype=dtype)
    pool_aux = torch.zeros(C_rows, dtype=torch.int8)
    pool_vals[:size] = torch.from_numpy(vals).to(dtype)
    pool_aux[:size] = torch.from_numpy(aux).to(torch.int8)
    return pool_vals, pool_aux


@pytest.mark.parametrize("size", [40, 150])  # partial chunk / full chunk
@pytest.mark.parametrize("mt", [8, 16])
@pytest.mark.parametrize("family", ["nqueens", "lb1", "lb2"])
def test_stitched_pool_equals_single_tile_cycle(family, mt, size):
    _, tprob = _problems(family)
    n = tprob.child_slots
    m, K = 4, 4
    pool_vals, pool_aux = _pool(np.random.default_rng(size + mt), family, size,
                                size + M * n)
    pv, pa = pool_vals.clone(), pool_aux.clone()
    best = INF
    st, st2 = C.new_state(size, best, CPU), C.new_state(size, best, CPU)
    if family == "nqueens":
        scal = T.tiled_nqueens_plain(pool_vals, pool_aux, st, tprob, M, mt, m, K)
        CN.cycle_nqueens_plain(pv, pa, st2, tprob.N, tprob.g, M, m, K)
    else:
        t = tprob.device_tables(CPU)
        scal = TILED_PLAIN[family](pool_vals, pool_aux, st, t, M, mt, m, K)
        PLAIN_CYCLES[family](pv, pa, st2, t, M, m, K)
    assert torch.equal(st, st2) and int(st[C.ST_CYCLES]) == 1
    live = int(st[C.ST_SIZE])
    assert int(st[C.ST_TREE]) > 0 and int(st[C.ST_SOL]) > 0
    assert family == "nqueens" or int(st[C.ST_BEST]) < INF
    assert torch.equal(pool_vals[:live], pv[:live])
    assert torch.equal(pool_aux[:live], pa[:live])
    assert scal.shape == (M // mt, 4)
    assert int(scal[-1, 0] + scal[-1, 1]) == int(st[C.ST_TREE])
    assert int(scal[-1, 2]) == int(st[C.ST_SOL])


def test_tiled_cycle_is_noop_when_condition_false():
    _, tprob = _problems("lb1")
    t = tprob.device_tables(CPU)
    pool_vals, pool_aux = _pool(np.random.default_rng(3), "lb1", 3, 3 + M * JOBS)
    st = C.new_state(3, INF, CPU)  # size 3 < m
    before = (pool_vals.clone(), pool_aux.clone())
    assert T.tiled_lb1_plain(pool_vals, pool_aux, st, t, M, 16, 4, 4) is None
    assert int(st[C.ST_ACTIVE]) == 0 and int(st[C.ST_CYCLES]) == 0
    assert torch.equal(pool_vals, before[0]) and torch.equal(pool_aux, before[1])


@pytest.fixture(scope="module")
def jax_tiled_counts():
    """The JAX resident counts under TTS_MEGAKERNEL=force and
    TTS_MEGAKERNEL_MT=16, per family (`tests/test_megakernel.py:268-276`)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_MEGAKERNEL", "force")
        mp.setenv("TTS_MEGAKERNEL_MT", "16")
        for family in ("nqueens", "lb1", "lb2"):
            res = jax_resident_search(_problems(family)[0], m=4, M=M, K=8)
            assert res.megakernel == "on" and res.megakernel_tiled
            out[family] = (res.explored_tree, res.explored_sol, res.best)
    return out


@pytest.mark.parametrize("family", ["nqueens", "lb1", "lb2"])
def test_resident_search_tiled_matches_jax_tiled(family, jax_tiled_counts):
    counts = []
    for mt in (16, None):
        res = resident_search(_problems(family)[1], m=4, M=M, K=8,
                              device="cpu", mt=mt)
        counts.append((res.explored_tree, res.explored_sol, res.best))
        assert res.fused and res.megakernel_mt == (mt or M)
        assert cli.megakernel_tiled(res) is (mt is not None)
    assert counts[0] == counts[1] == jax_tiled_counts[family]


@pytest.mark.parametrize("mt", [8, 16, 32])
@pytest.mark.parametrize("family", ["nqueens", "lb1", "lb2"])
def test_streamed_eval_bounds_matches_jax(family, mt):
    jprob, tprob = _problems(family)
    vals, aux = _chunk(np.random.default_rng(mt), family, M)
    want = np.asarray(MK.streamed_eval_bounds(jprob, vals, aux, mt=mt,
                                              interpret=True))
    got = T.streamed_eval_bounds(tprob, torch.from_numpy(vals),
                                 torch.from_numpy(aux), mt=mt)
    assert got.dtype == torch.int32 and got.shape == vals.shape
    if family == "nqueens":
        assert np.array_equal(got.numpy(), want)  # labels on every slot
    else:
        open_ = np.arange(JOBS)[None, :] > aux[:, None]
        assert np.array_equal(got.numpy()[open_], want[open_])
    # One tile (mt defaults to B) gives the same plane.
    assert torch.equal(got, T.streamed_eval_bounds(
        tprob, torch.from_numpy(vals), torch.from_numpy(aux)))


@pytest.mark.parametrize("B", [64, 37])
def test_megakernel_lb2_bounds_matches_jax(B):
    jprob, tprob = _problems("lb2")
    prmu, limit1 = _chunk(np.random.default_rng(B), "lb2", B)
    t = jdev.PFSPDeviceTables(jprob.lb1_data, jprob.lb2_data)
    want = np.asarray(MK.megakernel_lb2_bounds(
        jnp.asarray(prmu), jnp.asarray(limit1), t, interpret=True))
    got = T.megakernel_lb2_bounds(torch.from_numpy(prmu),
                                  torch.from_numpy(limit1),
                                  tprob.device_tables(CPU))
    open_ = np.arange(JOBS)[None, :] > limit1[:, None]
    assert np.array_equal(got.numpy()[open_], want[open_])


def test_tile_width_rule_raises():
    for bad in (24, 0, 12, 128):
        with pytest.raises(ValueError, match="multiple of 8"):
            T.check_tile(M, bad)
    assert T.check_tile(M, 16) == 4 and T.check_tile(M, M) == 1
    _, tprob = _problems("lb1")
    vals, aux = _chunk(np.random.default_rng(0), "lb1", M)
    with pytest.raises(ValueError, match="multiple of 8"):
        T.streamed_eval_bounds(tprob, torch.from_numpy(vals),
                               torch.from_numpy(aux), mt=24)
    with pytest.raises(ValueError, match="unsupported"):
        T.streamed_eval_bounds(PFSPProblem(lb="lb1_d", ub=0, p_times=PTM),
                               torch.from_numpy(vals), torch.from_numpy(aux))
    with pytest.raises(ValueError, match="multiple of 8"):
        resident_search(tprob, m=4, M=M, K=8, device="cpu", mt=24)


def test_mt_is_inert_unfused_and_under_lb1_d():
    # The unfused cycle has no tiles: a width is neither checked nor used.
    for prob, fused in [(PFSPProblem(lb="lb1", ub=0, p_times=PTM), False),
                        (PFSPProblem(lb="lb1_d", ub=0, p_times=PTM), True),
                        (NQueensProblem(N=N_QUEENS), False)]:
        prog = make_program(prob, 4, M, 8, 4096, "cpu", fused=fused, mt=24)
        assert not prog.fused and prog.mt is None and not prog.tiled
        on = resident_search(prob, m=4, M=M, K=8, device="cpu", fused=fused,
                             mt=16)
        off = resident_search(prob, m=4, M=M, K=8, device="cpu", fused=fused)
        assert on.megakernel_mt is None and not cli.megakernel_tiled(on)
        assert (on.explored_tree, on.explored_sol, on.best) == (
            off.explored_tree, off.explored_sol, off.best)


def test_cli_mt_records_the_tile_and_refuses_a_bad_width(capsys):
    base = ["nqueens", "--N", "8", "--M", "64", "--device", "cpu", "--json"]
    assert cli.main(base + ["--mt", "16"]) == 0
    out = capsys.readouterr().out
    assert "fused CUDA cycle, tiled Mt=16" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == (2056, 92)
    assert (rec["megakernel_mt"], rec["megakernel_tiled"]) == (16, True)
    assert cli.main(base) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["megakernel_mt"], rec["megakernel_tiled"]) == (64, False)
    assert cli.main(base + ["--unfused", "--mt", "24"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "megakernel_mt" not in rec and rec["fused"] is False
    assert cli.main(base + ["--mt", "24"]) == 2
    assert "multiple of 8 that divides M=64" in capsys.readouterr().err


def test_tiled_cuda_wrappers_refuse_cpu_tensors(monkeypatch):
    _, tprob = _problems("lb1")
    t = tprob.device_tables(CPU)
    pool_vals, pool_aux = _pool(np.random.default_rng(1), "lb1", 50, 50 + M * JOBS)
    st = C.new_state(50, INF, CPU)
    # The libraries report their blocks' parents (CYCLE_PARENTS, pinned
    # against the source by tests/test_torch_package.py); none is built here.
    monkeypatch.setattr(T, "parents_per_block", lambda source: CYCLE_PARENTS)
    # Kernels 9b's and 9c's scratch: kernel 2's and 8's, with a (survivors,
    # leaves) pair a block of 32 parents, and the (G + 1, 3) boundary row
    # read as the (G, 4) scalars.
    scratch9b = T.tiled_lb1_scratch(M, JOBS, 16, torch.int8, CPU)
    scratch9c = T.tiled_lb2_scratch(M, JOBS, 16, torch.int8, CPU)
    for scratch in (scratch9b, scratch9c):
        assert scratch.bounds.shape == (5, 3) and scratch.bounds.dtype == torch.int32
        assert scratch.cycle.blkcnt.numel() == 2 * 2 and scratch.scal.shape == (4, 4)
        assert scratch.cycle.plane.numel() == C.pfsp_plane_words(M, JOBS)
        assert scratch.cycle.chunk_aux.dtype == torch.int8
    lb2_tables = _problems("lb2")[1].device_tables(CPU)
    with pytest.raises(ValueError, match="CUDA"):  # before any build
        T.tiled_lb1_cuda(pool_vals, pool_aux, st, scratch9b, t, M, 16, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        T.tiled_lb2_cuda(pool_vals, pool_aux, st, scratch9c, lb2_tables, M, 16,
                         4, 4)
    T.tiled_lb1(pool_vals, pool_aux, st, None, t, M, 16, 4, 4)  # the plain route
    assert int(st[C.ST_CYCLES]) == 1


# -- the carry of kernels 9a, 9b and 9c ---------------------------------------

# Parents of a counting and emit block of the single-tile cycles
# (csrc/cycle_common.cuh TTS_CYCLE_PARENTS).
CYCLE_PARENTS = 32


def _carry_model(keeps, sols, best, mt):
    """The boundary row that kernels 9a, 9b and 9c write, in their block order:
    blocks of CYCLE_PARENTS parents, each publishing its (survivors,
    solutions) pair (the labels or count launch); each emit block sums the
    pairs of the blocks before it, ranks its parents (exclusive prefixes of
    keeps and sols) and writes row i // mt for each parent i that starts a
    tile, and the last block row G. ``keeps`` is each parent's survivor
    count, ``sols`` its solution or leaf flag (0 off the popped window).
    Every row is written exactly once."""
    M = len(keeps)
    G = M // mt
    nblk = -(-M // CYCLE_PARENTS)
    pairs = [(int(keeps[b * CYCLE_PARENTS:(b + 1) * CYCLE_PARENTS].sum()),
              int(sols[b * CYCLE_PARENTS:(b + 1) * CYCLE_PARENTS].sum()))
             for b in range(nblk)]
    bnd = np.full((G + 1, 3), -1, dtype=np.int64)
    writes = np.zeros(G + 1, dtype=np.int64)
    for b in range(nblk):
        pre = sum(c for c, _ in pairs[:b])
        presol = sum(s for _, s in pairs[:b])
        i0 = b * CYCLE_PARENTS
        k = keeps[i0:i0 + CYCLE_PARENTS].astype(np.int64)
        f = sols[i0:i0 + CYCLE_PARENTS].astype(np.int64)
        s_off = np.cumsum(k) - k
        sol_before = np.cumsum(f) - f
        for lane in range(len(k)):
            if (i0 + lane) % mt == 0:
                t = (i0 + lane) // mt
                bnd[t] = (pre + s_off[lane], presol + sol_before[lane], best)
                writes[t] += 1
        if b == nblk - 1:
            bnd[G] = (pre + k.sum(), presol + f.sum(), best)
            writes[G] += 1
    assert (writes == 1).all()
    return bnd.astype(np.int32)


def _carry_inputs(family, tprob, vals, aux, valid, best):
    """Per parent its survivors and its solution (N-Queens: a popped parent
    at depth N) or leaf flag (PFSP: a popped parent at limit1 = n - 2), and
    the incumbent the cycle ends with, from the plain bound or labels."""
    n = vals.shape[1]
    if family == "nqueens":
        labels = labels_chunk(torch.from_numpy(vals), torch.from_numpy(aux),
                              tprob.N, tprob.g).bool().numpy()
        keep = labels & valid[:, None] & (aux < n)[:, None]
        return keep.sum(1), valid & (aux == n), best
    lb = BOUNDS[family](torch.from_numpy(vals), torch.from_numpy(aux),
                        tprob.device_tables(CPU)).numpy()
    open_ = (np.arange(n)[None, :] > aux[:, None]) & valid[:, None]
    leaf = open_ & (aux == n - 2)[:, None]
    best = min(best, int(lb[leaf].min()) if leaf.any() else best)
    keep = open_ & ~leaf & (lb < best)
    return keep.sum(1), valid & (aux == n - 2), best


def _window(M, window):
    """The popped rows of a chunk of M: all, a head (a partial chunk), or a
    tail (the popped rows at the window's end, as a start2 clamped at C - M
    leaves them); the other tiles hold no popped row."""
    valid = np.zeros(M, dtype=bool)
    if window == "full":
        valid[:] = True
    elif window == "partial":
        valid[:M // 2 + 3] = True
    else:
        valid[M // 3 + 5:] = True
    return valid


@pytest.mark.parametrize("window", ["full", "partial", "tail"])
@pytest.mark.parametrize("M,mt", [(240, 8), (240, 16), (240, 40), (240, 80),
                                  (400, 80), (120, 40)])
@pytest.mark.parametrize("family", ["nqueens", "lb1", "lb2"])
def test_carry_model_matches_plain_and_pallas_tiled_scalars(family, M, mt,
                                                            window):
    jprob, tprob = _problems(family)
    rng = np.random.default_rng(M + mt + len(window) + len(family))
    vals, aux = _chunk(rng, family, M)
    valid = _window(M, window)
    best = (INF if window != "full" else
            _incumbent(family, tprob, vals, aux, True))
    keeps, sols, best_out = _carry_inputs(family, tprob, vals, aux, valid,
                                          best)
    bnd = _carry_model(keeps, sols, best_out, mt)
    scal = T.scal_from_bounds(torch.from_numpy(bnd))
    # The boundary row read as the per-tile scalars by the scratch's
    # accessor.
    G = M // mt
    scratch = T.TileBoundsScratch(
        cycle=C.CycleScratch.make(M, vals.shape[1], 1, torch.int8, M,
                                  CYCLE_PARENTS, CPU, counts=2),
        bounds=torch.from_numpy(bnd))
    assert scratch.scal.shape == (G, 4) and torch.equal(scratch.scal, scal)
    tv = torch.from_numpy(vals).to(torch.uint8 if family == "nqueens"
                                   else torch.int8)
    _, _, offs, tree, sol, best_t, scal_p = T.tiled_chunk_plain(
        _spec(family, tprob), tv, torch.from_numpy(aux).to(torch.int8),
        torch.from_numpy(valid), torch.tensor(best, dtype=torch.int32), mt,
        BOUNDS.get(family, lb2_chunk))
    assert torch.equal(scal, scal_p)
    assert (int(tree), int(sol), int(best_t)) == tuple(int(v) for v in bnd[G])
    _, _, scal_j = _jax_tiled(family, jprob, vals, aux, valid, best, mt)
    assert np.array_equal(scal.numpy(), scal_j)
    # Tiles with no popped row have no survivor and carry the solutions of
    # the tiles before them.
    empty = ~valid.reshape(G, mt).any(1)
    assert window == "full" or empty.any()
    assert (scal_p[torch.from_numpy(empty), 1] == 0).all()
    assert int(tree) > 0 or int(sol) > 0  # (the leaves may prune all)


def test_streamed_nqueens_and_lb2_sources_have_no_look_back():
    # Kernels 9a, 9b and 9c run the single-tile cycles' bodies: no ticket,
    # no status words, no look-back, and no Johnson pass per child; the
    # look-back's headers are gone.
    from tpu_tree_search_torch.ops import _build

    def text(name):
        return (_build.CSRC / name).read_text()

    for src, body in [("tiled_nqueens.cu", "cycle_nqueens.cuh"),
                      ("tiled_lb1.cu", "cycle_lb1.cuh"),
                      ("tiled_lb2.cu", "cycle_lb2.cuh")]:
        code = text(src)
        assert f'#include "{body}"' in code
        for header in ("tiled_common.cuh", "tiled_pfsp.cuh"):
            assert header not in code
    for header in ("tiled_common.cuh", "tiled_pfsp.cuh"):
        assert not (_build.CSRC / header).exists()
    for name in ("tiled_lb1.cu", "cycle_lb1.cuh", "cycle_lb1.cu",
                 "tiled_lb2.cu", "cycle_lb2.cuh", "cycle_pfsp.cuh",
                 "lb1_common.cuh", "lb2_common.cuh", "cycle_nqueens.cuh",
                 "cycle_common.cuh"):
        code = text(name)
        for gone in ("lb2_child", "lb2_parent_state", "tile_lookback",
                     "tile_ticket", "atomicAdd(ticket", "__nanosleep",
                     "TTS_PARENTS_PER_BLOCK", "lb1_smem_layout"):
            assert gone not in code, (name, gone)
    # Kernel 9b's bounds launch is kernel 2's body under its own name.
    lb1 = text("cycle_lb1.cuh")
    for kernel in ("cycle_bounds", "lb1_tiles_bounds"):
        assert f"__global__ void {kernel}(TTS_LB1_BOUNDS_PARAMS)" in lb1
    assert "launch_lb1_cycle<T, true>" in text("tiled_lb1.cu")
    assert "launch_lb1_cycle<T, false>" in text("cycle_lb1.cu")
