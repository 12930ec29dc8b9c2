"""The port's device telemetry (`tpu_tree_search_torch/obs/counters.py`,
`obs/phases.py`) against the JAX package's, on the CPU.

  * the counter block: under ``capture()`` the port's ``resident_search``
    and the JAX one at equal m, M and K give equal ``device_counters``,
    slot for slot — the fused cycle against the JAX one-kernel cycle
    (``TTS_MEGAKERNEL=force``, Pallas interpret mode), the unfused cycle in
    its dense and scatter modes against ``TTS_MEGAKERNEL=0``. The one slot
    that differs by design (ROADMAP C): ``overflow`` on the fused cycle,
    which has no overflow branch (0), where the JAX one-kernel cycle counts
    the cycles whose survivors pass S;
  * the plain per-cycle update is the JAX ``counters.update``, and
    ``dispatch_cond_obs_plain`` folds a cycle from the loop state as the
    CUDA node does;
  * ``explored`` samples sum to the result's counts on the resident
    (fused, unfused, streamed, stall fallback), offload and sequential
    tiers, and after a ``max_steps`` cut at ``TTS_PIPELINE`` 1 and 2;
  * the phase clock: the plain block telescopes exactly, each cycle form
    charges the slots of its launch sequence (and none other), and an armed
    run's counts equal an unarmed run's.
"""

from __future__ import annotations

import signal
import sys

import numpy as np
import pytest
import torch

from tpu_tree_search import obs as jax_obs
from tpu_tree_search.engine.resident import resident_search as jax_resident_search
from tpu_tree_search.obs import counters as jax_counters
from tpu_tree_search.obs import flightrec as jax_flightrec
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch import obs
from tpu_tree_search_torch.engine import resident as resident_mod
from tpu_tree_search_torch.engine.device import device_search
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.engine.sequential import sequential_search
from tpu_tree_search_torch.obs import counters, flightrec, phases
from tpu_tree_search_torch.ops import cycle as C
from tpu_tree_search_torch.ops import dispatch as D
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

PTM = taillard.reduced_instance(14, jobs=10, machines=5)
_PROBLEMS = ["nq9", "lb1", "lb2"]


def _problem(name: str, jax: bool):
    if name.startswith("nq"):
        return (JaxNQueens if jax else NQueensProblem)(int(name[2:]))
    return (JaxPFSP if jax else PFSPProblem)(lb=name, ub=0, p_times=PTM)


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


@pytest.fixture(autouse=True)
def _quiet_knobs(monkeypatch):
    """The knobs unset; the signal handlers, the excepthook and the flight
    recorder that an armed search installs restored after each test."""
    for k in ("TTS_OBS", "TTS_PHASEPROF", "TTS_PIPELINE", "TTS_K",
              "TTS_MEGAKERNEL", "TTS_MEGAKERNEL_MT", "TTS_COMPACT",
              "TTS_FLIGHTREC", "TTS_QUALITY", "TTS_COSTMODEL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TTS_WATCHDOG_S", "0")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGALRM)}
    hook = sys.excepthook
    yield
    for s, h in handlers.items():
        signal.signal(s, h)
    sys.excepthook = hook
    for rec in (flightrec.recorder(), jax_flightrec.recorder()):
        rec.reset()
        rec._installed = False
        rec._prev_handlers = {}
        rec._prev_excepthook = None


# -- the counter block against the JAX engine -----------------------------------


@pytest.mark.parametrize("name", _PROBLEMS)
def test_fused_counters_match_the_jax_one_kernel_cycle(monkeypatch, name):
    monkeypatch.setenv("TTS_MEGAKERNEL", "force")
    with jax_obs.capture() as jcap:
        want = jax_resident_search(_problem(name, True), m=8, M=64, K=16)
    assert want.megakernel == "on"
    with obs.capture() as cap:
        res = resident_search(_problem(name, False), m=8, M=64, K=16,
                              device="cpu")
    assert res.fused and _counts(res) == _counts(want)
    assert res.obs["device_counters"] == want.obs["device_counters"]
    assert cap.explored_totals() == jcap.explored_totals() == (
        res.explored_tree, res.explored_sol)


@pytest.mark.parametrize("mode", ["dense", "scatter"])
@pytest.mark.parametrize("name", _PROBLEMS)
def test_unfused_counters_match_the_jax_cycle(monkeypatch, name, mode):
    monkeypatch.setenv("TTS_MEGAKERNEL", "0")
    monkeypatch.setenv("TTS_COMPACT", mode)
    monkeypatch.setattr(resident_mod, "resolve_compact_mode",
                        lambda problem, M, n: mode)
    with jax_obs.capture():
        want = jax_resident_search(_problem(name, True), m=8, M=64, K=16)
    with obs.capture():
        res = resident_search(_problem(name, False), m=8, M=64, K=16,
                              device="cpu", fused=False)
    assert res.compact == mode == want.compact
    assert _counts(res) == _counts(want)
    assert res.obs["device_counters"] == want.obs["device_counters"]


def test_overflow_slot_differs_by_design_on_the_fused_cycle(monkeypatch):
    # ub=inf from a 300-node frontier: a 128-parent chunk keeps more than
    # the survivor budget S. The JAX one-kernel cycle counts those cycles
    # as overflow; the port's fused cycle has no overflow branch (its
    # condition reserves M*n rows) and counts 0. Every other slot agrees,
    # and the unfused cycle counts them as JAX's unfused cycle does.
    monkeypatch.setenv("TTS_MEGAKERNEL", "force")
    kw = dict(m=8, M=128, K=16, warmup_target=300)
    with jax_obs.capture():
        want = jax_resident_search(JaxPFSP(lb="lb1", ub=0, p_times=PTM), **kw)
    with obs.capture():
        res = resident_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM),
                              device="cpu", **kw)
    jc, tc = want.obs["device_counters"], res.obs["device_counters"]
    assert jc["overflow"] > 0 and tc["overflow"] == 0
    assert {k: v for k, v in tc.items() if k != "overflow"} == {
        k: v for k, v in jc.items() if k != "overflow"}
    monkeypatch.setenv("TTS_MEGAKERNEL", "0")
    with jax_obs.capture():
        want_u = jax_resident_search(JaxPFSP(lb="lb1", ub=0, p_times=PTM), **kw)
    with obs.capture():
        res_u = resident_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM),
                                device="cpu", fused=False, **kw)
    assert res_u.obs["device_counters"] == want_u.obs["device_counters"]
    assert res_u.obs["device_counters"]["overflow"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_update_is_the_jax_update(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    c = [0] * counters.NSLOTS
    j = jax_counters.init_block()
    n = 12
    for _ in range(20):
        cnt = int(rng.integers(0, 100))
        tree = int(rng.integers(0, cnt * n + 1))
        sol = int(rng.integers(0, cnt * n - tree + 1))
        fits = bool(rng.integers(0, 2))
        size = int(rng.integers(0, 10_000))
        rows = int(rng.integers(0, 5000))
        c = counters.update(c, cnt, n, tree, sol, not fits, size, rows)
        j = jax_counters.update(j, jnp.int32(cnt), n, jnp.int32(tree),
                                jnp.int32(sol), jnp.bool_(fits),
                                jnp.int32(size), jnp.int32(rows))
    assert c == [int(x) for x in np.asarray(j)]
    assert counters.SLOTS == jax_counters.SLOTS
    assert counters.merge_host(None, c) == jax_counters.merge_host(
        None, np.asarray(c))
    two = [c, [1] * counters.NSLOTS]
    assert counters.merge_host({"popped": 5, **{k: 0 for k in counters.SLOTS
                                                if k != "popped"}}, two) == \
        jax_counters.merge_host({"popped": 5, **{k: 0 for k in counters.SLOTS
                                                 if k != "popped"}},
                                np.asarray(two))


def test_dispatch_cond_obs_plain_folds_a_cycle_from_the_state():
    st = torch.zeros(C.ST_LEN, dtype=torch.int32)
    st[C.ST_SIZE], st[C.ST_CNT] = 500, 64
    st[C.ST_TREE], st[C.ST_SOL], st[C.ST_CYCLES] = 300, 7, 1
    m, n, Mn, Cap, K = 8, 10, 640, 4096, 4
    assert D.dispatch_cond_obs_plain(st, n, m, Mn, Cap, K)
    want = counters.update([0] * 8, 64, n, 300, 7, False, 500, Mn)
    assert st[C.ST_CTR:C.ST_CTR + 8].tolist() == want
    # The next cycle's increments are the differences of the running sums.
    st[C.ST_TREE], st[C.ST_SOL], st[C.ST_SIZE], st[C.ST_CNT] = 350, 9, 3800, 32
    st[C.ST_CYCLES] = 2
    assert not D.dispatch_cond_obs_plain(st, n, m, Mn, Cap, K)  # no headroom
    want = counters.update(want, 32, n, 50, 2, False, 3800, Mn)
    assert st[C.ST_CTR:C.ST_CTR + 8].tolist() == want
    assert (st[C.ST_CTR_TREE], st[C.ST_CTR_SOL], st[C.ST_RUNS]) == (350, 9, 2)
    assert C.ST_CTR + counters.NSLOTS == C.ST_CTR_TREE
    assert C.ST_CTR_SOL < C.ST_LEN


# -- explored samples equal the search counts -----------------------------------


@pytest.mark.parametrize("form", ["fused", "unfused", "tiled"])
@pytest.mark.parametrize("mode", ["1", "host"])
@pytest.mark.parametrize("name", ["nq9", "lb1"])
def test_resident_explored_samples_equal_the_counts(name, mode, form):
    kw = dict(fused=form != "unfused", mt=16 if form == "tiled" else None)
    with obs.capture(mode=mode) as cap:
        res = resident_search(_problem(name, False), m=8, M=64, K=16,
                              device="cpu", **kw)
    assert cap.explored_totals() == (res.explored_tree, res.explored_sol)
    assert (res.obs is not None) is (mode == "1")
    if mode == "1":
        c = res.obs["device_counters"]
        assert c["pushed"] == res.phases[1].tree
        assert c["leaves"] == res.phases[1].sol
        n = _problem(name, False).child_slots
        assert c["popped"] * n == c["pushed"] + c["leaves"] + c["pruned"]


@pytest.mark.parametrize("depth", ["1", "2"])
@pytest.mark.parametrize("name", ["nq9", "lb1"])
def test_explored_samples_after_a_cut(monkeypatch, name, depth):
    monkeypatch.setenv("TTS_PIPELINE", depth)
    with obs.capture() as cap:
        res = resident_search(_problem(name, False), m=8, M=64, K=2,
                              device="cpu", max_steps=3)
    assert not res.complete and res.explored_tree > 0
    assert cap.explored_totals() == (res.explored_tree, res.explored_sol)
    assert sum(1 for e in cap.events if e["name"] == "checkpoint") == 1
    # The drained in-flight dispatches' blocks are folded in exactly once.
    assert res.obs["device_counters"]["pushed"] == res.phases[1].tree


@pytest.mark.parametrize("fused", [True, False])
def test_stall_fallback_samples_its_host_cycles(fused):
    # A frontier past the headroom stalls the device; the host offload
    # cycles reach the samples as a sample of their own, not the counters.
    with obs.capture() as cap:
        res = resident_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM), m=8,
                              M=64, K=16, capacity=1400, warmup_target=800,
                              device="cpu", fused=fused)
    assert res.stall_fallbacks > 0
    assert cap.explored_totals() == (res.explored_tree, res.explored_sol)
    fb = [e for e in cap.events if e["name"] == "overflow_fallback"]
    assert len(fb) == res.stall_fallbacks
    fb_tree = sum(e["args"]["tree"] for e in fb)
    assert res.obs["device_counters"]["pushed"] + fb_tree == res.phases[1].tree


def test_offload_and_sequential_explored_samples():
    for run in (lambda: device_search(NQueensProblem(9), m=8, M=64,
                                      device="cpu"),
                lambda: device_search(PFSPProblem(lb="lb2", ub=0, p_times=PTM),
                                      m=8, M=64, device="cpu"),
                lambda: sequential_search(NQueensProblem(8)),
                lambda: sequential_search(PFSPProblem(lb="lb1", ub=0,
                                                      p_times=PTM))):
        with obs.capture() as cap:
            res = run()
        assert cap.explored_totals() == (res.explored_tree, res.explored_sol)
        assert res.obs is None


# -- the phase clock -------------------------------------------------------------


def test_plain_clock_telescopes_exactly():
    clk = D.new_clock("cpu")
    D.phase_mark(clk, 0, phases.SEED)
    assert clk[phases.TPREV] > 0 and clk[:phases.NSLOTS].sum() == 0
    I = phases.IDX
    for _ in range(5):
        D.phase_mark(clk, I["loop"], phases.OPEN)
        for slot in ("pop", "eval", "compact"):
            D.phase_mark(clk, I[slot])
        D.phase_mark(clk, I["push"], phases.CLOSE)
    v = clk.tolist()
    assert sum(v[I[s]] for s in phases.CYCLE_SLOTS) == v[I["total"]] > 0
    assert v[I["overflow"]] == v[I["balance"]] == 0 and v[I["loop"]] > 0
    assert phases.SLOTS == jax_obs.phases.SLOTS
    assert phases.as_args(v) == {s: v[i] for i, s in enumerate(phases.SLOTS)}


# Slots each cycle form charges (the marks between its launches).
_CHARGED = {
    "pfsp_fused": {"eval", "compact", "push"},
    "nq_fused": {"eval", "push"},
    "unfused": {"pop", "eval", "compact", "push"},
}


@pytest.mark.parametrize("form,name,kw", [
    ("pfsp_fused", "lb1", {}),
    ("pfsp_fused", "lb2", {}),
    ("pfsp_fused", "lb1", {"mt": 16}),
    ("nq_fused", "nq9", {}),
    ("nq_fused", "nq9", {"mt": 16}),
    ("unfused", "lb1", {"fused": False}),
    ("unfused", "nq9", {"fused": False}),
])
def test_phase_slot_mapping_and_unchanged_counts(monkeypatch, form, name, kw):
    plain = resident_search(_problem(name, False), m=8, M=64, K=16,
                            device="cpu", **kw)
    monkeypatch.setenv("TTS_PHASEPROF", "1")
    with obs.capture() as cap:
        res = resident_search(_problem(name, False), m=8, M=64, K=16,
                              device="cpu", **kw)
    assert _counts(res) == _counts(plain)
    ph = res.phase_profile
    assert ph == res.obs["device_phases"]
    assert sum(ph[s] for s in phases.CYCLE_SLOTS) == ph["total"] > 0
    charged = {s for s in phases.CYCLE_SLOTS if ph[s] > 0}
    assert charged == _CHARGED[form]
    assert ph["balance"] == 0 and ph["loop"] > 0
    # The clock arms the counters (the roofline's floors) and the audit.
    assert res.obs["device_counters"]["pushed"] == res.phases[1].tree
    assert res.roofline is not None
    assert {r["phase"] for r in res.roofline["phases"]} == set(
        phases.CYCLE_SLOTS)
    s = cap.summary()
    assert s["phase_decomp"]["ns"] == ph and s["roofline"] == res.roofline


def test_phase_profile_counts_equal_on_every_pipeline_depth(monkeypatch):
    monkeypatch.setenv("TTS_PHASEPROF", "1")
    for depth in ("1", "3"):
        monkeypatch.setenv("TTS_PIPELINE", depth)
        res = resident_search(NQueensProblem(9), m=8, M=64, K=4,
                              device="cpu")
        assert (res.explored_tree, res.explored_sol) == (8393, 352)
        assert res.phase_profile["total"] > 0
