"""The port's batched engine (`tpu_tree_search_torch/engine/batched.py`) and
its program cache (`engine/resident.py` ``make_program``) against the JAX
package, on the CPU.

  * ``batched_search(..., device="cpu")`` gives every job the tree, sol and
    best of the JAX ``batched_search`` and of the port's solo
    ``resident_search``: N-Queens N=8-9 at m=5, M=64, K=4-8 with B = 2 and
    3 and refills, a small PFSP instance on the fused and unfused cycles,
    and under ``TTS_OBS=1`` a counter block a slot equal to JAX's.
  * A forced stall finishes solo, and its checkpoint loads in the JAX
    ``engine/checkpoint.py``.
  * ``batch_init_plain`` and ``batch_cond_plain`` (the batched graph's
    nodes' plain versions) against a numpy model of the OR and the mask,
    with frozen, empty and retired slots.
  * The program cache: a second same-config search reuses the cached
    program and its state; flipping ``TTS_OBS`` builds another; two
    overlapping searches never share a state; ``release_programs``.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from tpu_tree_search.engine import checkpoint as jax_ckpt
from tpu_tree_search.engine.batched import batched_search as jax_batched_search
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.engine import batched as batched_mod
from tpu_tree_search_torch.engine.batched import batched_search, make_batched_program
from tpu_tree_search_torch.engine.resident import (
    make_program,
    release_programs,
    resident_search,
)
from tpu_tree_search_torch.ops import cycle as C
from tpu_tree_search_torch.ops.dispatch import batch_cond_plain, batch_init_plain
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

PTM = taillard.reduced_instance(14, jobs=8, machines=4)


@pytest.fixture(autouse=True)
def _quiet_knobs(monkeypatch):
    for k in ("TTS_OBS", "TTS_PHASEPROF", "TTS_PIPELINE", "TTS_K",
              "TTS_MEGAKERNEL", "TTS_MEGAKERNEL_MT", "TTS_COMPACT",
              "TTS_QUALITY", "TTS_COSTMODEL"):
        monkeypatch.delenv(k, raising=False)


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


@pytest.mark.parametrize("N,B,n_jobs,K", [(8, 2, 3, 4), (9, 3, 5, 8)])
def test_batched_nqueens_equals_jax_and_solo(N, B, n_jobs, K):
    """Every job of a B-slot batch, refills included (n_jobs > B), lands
    the JAX batched counts and the port's solo counts."""
    want = jax_batched_search(JaxNQueens(N), n_jobs=n_jobs, B=B, m=5, M=64,
                              K=K)
    got = batched_search(NQueensProblem(N), n_jobs, B, m=5, M=64, K=K,
                         device="cpu")
    solo = resident_search(NQueensProblem(N), m=5, M=64, K=K, device="cpu")
    assert len(got) == len(want) == n_jobs
    for g, w in zip(got, want):
        assert _counts(g) == _counts(w) == _counts(solo)
        assert g.complete and g.k_resolved == K


@pytest.mark.parametrize("fused", [True, False])
def test_batched_pfsp_equals_jax_and_solo(fused):
    """A small PFSP lb1 instance (ub = inf: the incumbent moves) through a
    2-slot batch with a refill, on the plain fused cycle and the unfused
    one."""
    want = jax_batched_search(JaxPFSP(lb="lb1", ub=0, p_times=PTM), n_jobs=3,
                              B=2, m=5, M=64, K=4)
    prob = PFSPProblem(lb="lb1", ub=0, p_times=PTM)
    got = batched_search(prob, 3, 2, m=5, M=64, K=4, device="cpu",
                         fused=fused)
    solo = resident_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM), m=5,
                           M=64, K=4, device="cpu", fused=fused)
    assert [_counts(g) for g in got] == [_counts(w) for w in want] \
        == [_counts(solo)] * 3
    assert all(g.fused == fused for g in got)


@pytest.mark.parametrize("fused", [True, False])
def test_batched_counter_blocks_equal_jax_a_slot(monkeypatch, fused):
    """TTS_OBS=1: each job's counter totals, summed over its slot's blocks,
    equal the JAX batched job's (the one-kernel cycle against the fused
    one; the jnp cycle, dense compaction, against the unfused one) and the
    port's solo search's."""
    monkeypatch.setenv("TTS_OBS", "1")
    monkeypatch.setenv("TTS_MEGAKERNEL", "force" if fused else "0")
    want = jax_batched_search(JaxNQueens(8), n_jobs=3, B=2, m=5, M=64, K=4)
    got = batched_search(NQueensProblem(8), 3, 2, m=5, M=64, K=4,
                         device="cpu", fused=fused)
    solo = resident_search(NQueensProblem(8), m=5, M=64, K=4, device="cpu",
                           fused=fused)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert _counts(g) == _counts(w)
        assert g.obs["device_counters"] == w.obs["device_counters"] \
            == solo.obs["device_counters"]


def test_forced_stall_finishes_solo_with_a_checkpoint_jax_loads(monkeypatch):
    """A pool of exactly two fan-outs stalls a slot (zero cycles): the slot
    is cut to a checkpoint, which the JAX package's loader reads, and a
    solo resume finishes the job at the solo counts."""
    seen = []
    real = batched_mod.R.resident_search

    def resume(problem, **kw):
        saved = jax_ckpt.load(kw["resume_from"], JaxNQueens(10))
        seen.append((saved.tree, saved.sol, saved.batch["board"].shape[0]))
        return real(problem, **kw)

    monkeypatch.setattr(batched_mod.R, "resident_search", resume)
    n = 10
    got = batched_search(NQueensProblem(n), 2, 2, m=5, M=64, K=8,
                         capacity=2 * 64 * n, device="cpu")
    assert seen and all(rows > 64 * n for _t, _s, rows in seen)
    assert [_counts(g)[:2] for g in got] == [(35538, 724)] * 2


# -- the batched graph's nodes, plain -------------------------------------------


def _model(st: np.ndarray, n: int, m: int, Mn: int, C_: int, K: int):
    """numpy model of batch_cond: the mask (only slots whose cycle ran,
    st[ST_ACTIVE], count a run and fold the counter block, the CUDA
    kernel's arithmetic) and the OR of the slots' conditions."""
    st = st.copy()
    for v in st:
        if v[C.ST_ACTIVE]:
            if n:
                c = v[C.ST_CTR:C.ST_CTR + 8]
                ti = v[C.ST_TREE] - v[C.ST_CTR_TREE]
                si = v[C.ST_SOL] - v[C.ST_CTR_SOL]
                cnt = v[C.ST_CNT]
                c[0] += cnt
                c[1] += ti
                c[2] += si
                c[3] += cnt * n - ti - si
                c[5] = max(c[5], v[C.ST_SIZE])
                c[6] = max(c[6], ti)
                c[7] += Mn
                v[C.ST_CTR_TREE], v[C.ST_CTR_SOL] = v[C.ST_TREE], v[C.ST_SOL]
            v[C.ST_RUNS] += 1
    size = st[:, C.ST_SIZE].astype(np.int64)
    live = (size >= m) & (size + Mn <= C_) & (st[:, C.ST_CYCLES] < K)
    return st, bool(live.any())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("obs", [0, 12])
def test_batch_cond_plain_is_the_mask_and_the_or(seed, obs):
    rng = np.random.default_rng(seed)
    B, m, Mn, C_, K = 6, 25, 12 * 64, 4096, 4
    st = rng.integers(0, 50, size=(B, C.ST_LEN)).astype(np.int32)
    # Slot 0 live, 1 empty (size 0), 2 retired (below m), 3 frozen by K,
    # 4 out of headroom, 5 random; the cycle ran only where ACTIVE is set.
    st[:, C.ST_SIZE] = [100, 0, 10, 100, C_ - Mn + 1,
                        int(rng.integers(0, C_))]
    st[:, C.ST_CYCLES] = [1, 0, 2, K, 0, int(rng.integers(0, K + 1))]
    st[:, C.ST_ACTIVE] = [1, 0, 0, 1, 0, int(rng.integers(0, 2))]
    # A cycle's counts as a real one leaves them: tree and sol at or past
    # the values the block last saw, within cnt * n child slots.
    st[:, C.ST_TREE] += st[:, C.ST_CTR_TREE]
    st[:, C.ST_SOL] += st[:, C.ST_CTR_SOL]
    st[:, C.ST_CNT] = rng.integers(20, 50, size=B)
    want, want_live = _model(st, obs, m, Mn, C_, K)
    t = torch.from_numpy(st.copy())
    assert batch_cond_plain(t, obs, m, Mn, C_, K) == want_live
    assert np.array_equal(t.numpy(), want)
    # Every slot frozen: the OR is false.
    t[:, C.ST_SIZE] = 0
    assert not batch_cond_plain(t, obs, m, Mn, C_, K)


@pytest.mark.parametrize("obs", [False, True])
def test_batch_init_plain_zeroes_the_counts_and_ors(obs):
    rng = np.random.default_rng(7)
    st = torch.from_numpy(rng.integers(1, 50, size=(3, C.ST_LEN))
                          .astype(np.int32))
    st[:, C.ST_SIZE] = torch.tensor([0, 10, 200])
    before = st.clone()
    assert batch_init_plain(st, 25, 64, 4096, 4, obs)
    zeroed = [C.ST_TREE, C.ST_SOL, C.ST_CYCLES, C.ST_RUNS]
    if obs:
        zeroed += list(range(C.ST_CTR, C.ST_CTR_SOL + 1))
    keep = [i for i in range(C.ST_LEN) if i not in zeroed]
    assert int(st[:, zeroed].abs().sum()) == 0
    assert torch.equal(st[:, keep], before[:, keep])
    st[2, C.ST_SIZE] = 3
    assert not batch_init_plain(st, 25, 64, 4096, 4, obs)


def test_batched_program_refuses_the_phase_clock(monkeypatch):
    monkeypatch.setenv("TTS_PHASEPROF", "1")
    with pytest.raises(RuntimeError, match="TTS_PHASEPROF"):
        make_batched_program(NQueensProblem(8), 2, 5, 64, 4, 8192, "cpu")


def test_admission_is_a_copy_into_the_slot(monkeypatch):
    """make_slot and empty_slot copy into the slot's existing tensors."""
    prog = make_batched_program(NQueensProblem(8), 2, 5, 64, 4, 8192, "cpu")
    ptrs = [(s.pool_vals.data_ptr(), s.pool_aux.data_ptr(), s.st.data_ptr())
            for s in prog.states]
    prob = NQueensProblem(8)
    prog.make_slot(0, {"board": np.tile(np.arange(8, dtype=np.uint8), (3, 1)),
                       "depth": np.zeros(3, dtype=np.uint8)}, 7)
    prog.empty_slot(1)
    assert prog.st[:, C.ST_SIZE].tolist() == [3, 0]
    assert int(prog.st[0, C.ST_BEST]) == 7
    assert [(s.pool_vals.data_ptr(), s.pool_aux.data_ptr(), s.st.data_ptr())
            for s in prog.states] == ptrs
    assert prog.residual_slot(0)[1] == 3 and prob.N == 8
    prog.release()


# -- the program cache ----------------------------------------------------------


def test_second_search_reuses_the_cached_program_and_state():
    p = NQueensProblem(8)
    a = resident_search(p, m=5, M=64, K=4, device="cpu")
    (prog,) = p._resident_programs.values()
    state = prog.state
    b = resident_search(p, m=5, M=64, K=4, device="cpu")
    assert list(p._resident_programs.values()) == [prog]
    assert prog.state is state and not prog.busy
    assert _counts(a) == _counts(b) == (2056, 92, a.best)
    # AdaptiveK moves the program's K; the key is the K asked for.
    c = resident_search(p, m=5, M=64, K="auto", device="cpu")
    d = resident_search(p, m=5, M=64, K="auto", device="cpu")
    assert len(p._resident_programs) == 2
    assert _counts(c) == _counts(d) == _counts(a)
    assert release_programs(p) == 2 and not p._resident_programs


def test_flipping_tts_obs_builds_another_program(monkeypatch):
    p = NQueensProblem(8)
    resident_search(p, m=5, M=64, K=4, device="cpu")
    monkeypatch.setenv("TTS_OBS", "1")
    res = resident_search(p, m=5, M=64, K=4, device="cpu")
    progs = list(p._resident_programs.values())
    assert [q.obs for q in progs] == [False, True]
    assert res.obs and res.obs["device_counters"]["leaves"] == 92


def test_overlapping_searches_never_share_a_state():
    """A search that finds the cached program held builds its own, uncached
    and freed when it ends; threads running at once each get a state."""
    p = NQueensProblem(8)
    held = make_program(p, 5, 64, 4, 8192, "cpu")
    assert held.busy and held.state is None
    res = resident_search(p, m=5, M=64, K=4, capacity=8192, device="cpu")
    assert list(p._resident_programs.values()) == [held]
    assert held.state is None and res.explored_sol == 92
    held.release()
    resident_search(p, m=5, M=64, K=4, capacity=8192, device="cpu")
    assert held.state is not None and not held.busy

    q = NQueensProblem(9)
    out = [None] * 3
    states = []
    real = q.root

    def run(i):
        out[i] = resident_search(q, m=5, M=64, K=8, device="cpu")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert [_counts(r) for r in out] == [(8393, 352, out[0].best)] * 3
    for prog in q._resident_programs.values():
        states.append(id(prog.state))
        assert not prog.busy
    assert len(set(states)) == len(states) and real == q.root
