"""The port's multi-device tier (`tpu_tree_search_torch/parallel/multidevice.py`)
and the thread-safety repairs under it, against the JAX package, on the CPU.

  * ``TaskStates`` (the port's copy of `utils/termination.py`) follows the
    JAX states through the same sequence; ``ParallelSoAPool``'s
    ``pop_front_bulk_half`` and ``pop_back_bulk_all`` match the JAX pool's.
  * ``multidevice_search(device="cpu")`` at D = 2 and 4: N-Queens N=9 and
    reduced PFSP lb1/lb2 at a fixed incumbent (the optimum) equal the JAX
    ``multidevice_search`` and the sequential tier in tree, sol and best;
    ub=0 finds the JAX optimum; ``per_worker_tree`` has D entries and the
    shares sum to 100; a worker's error re-raises.
  * Checkpoints: a multi cut resumes on the port's device tier, and a
    device-tier cut resumes on the multi tier, to the goldens.
  * The CLI: ``--tier multi`` and ``--tier mesh`` records carry the JAX
    CLI's counts on N=8 under its keys, with ``per_worker_tree`` and
    ``workload_shares`` (the refusals are cases of
    `tests/test_torch_package.py::test_cli_refuses_unported_paths`).
  * Threads: eight threads calling ``_build.library`` on a cold name build
    once (the compiler faked), the compiler's temporary output is a
    thread's own, one library's entries never run at once, and
    ``device_tables`` builds a device's tables once.

Tolerance: exact equality (counts, node values).
"""

from __future__ import annotations

import ctypes
import json
import threading
import time

import numpy as np
import pytest

from tpu_tree_search.engine.sequential import sequential_search as jax_seq
from tpu_tree_search.parallel.multidevice import multidevice_search as jax_multi
from tpu_tree_search.pool import ParallelSoAPool as JaxParallelPool
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search.utils import TaskStates as JaxTaskStates
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.engine.sequential import sequential_search
from tpu_tree_search_torch.ops import _build
from tpu_tree_search_torch.parallel.multidevice import multidevice_search
from tpu_tree_search_torch.pool import ParallelSoAPool
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem
from tpu_tree_search_torch.utils import BUSY, IDLE, TaskStates

PTM = taillard.reduced_instance(14, jobs=10, machines=5)


def _counts(res):
    return res.explored_tree, res.explored_sol, res.best


def test_task_states_follow_jax():
    mine, theirs = TaskStates(3), JaxTaskStates(3)
    assert (BUSY, IDLE) == (False, True)
    ops = [("set_idle", 0), ("all", None), ("set_idle", 1), ("set_busy", 0),
           ("all", None), ("set_idle", 0), ("set_idle", 2), ("all", None),
           ("set_busy", 1), ("all", None)]
    for op, tid in ops:
        if op == "all":
            assert mine.all_idle() == theirs.all_idle()
        else:
            getattr(mine, op)(tid)
            getattr(theirs, op)(tid)
        assert mine.states == theirs.states
        assert mine.flag.is_set() == theirs.flag.is_set()
    # The flag is sticky: a worker flipping BUSY after the latch does not
    # unset it.
    assert mine.all_idle() and mine.flag.is_set()


@pytest.mark.parametrize("size,perc", [(5, 0.5), (40, 0.5), (41, 0.25),
                                       (100, 1.0)])
def test_parallel_pool_steal_and_drain_match_jax(size, perc):
    fields = NQueensProblem(6).node_fields()
    rng = np.random.default_rng(size)
    batch = {"depth": rng.integers(0, 6, size).astype(fields["depth"][1]),
             "board": rng.integers(0, 6, (size, 6)).astype(np.uint8)}
    mine, theirs = ParallelSoAPool(fields), JaxParallelPool(fields)
    mine.locked_push_back_bulk(batch)
    theirs.locked_push_back_bulk(batch)
    assert mine.try_lock()
    try:
        a = mine.pop_front_bulk_half(10, perc)
    finally:
        mine.unlock()
    b = theirs.pop_front_bulk_half(10, perc)
    assert (a is None) == (b is None)
    if a is not None:
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    out_m, out_j = NQueensProblem(6).empty_batch(64), NQueensProblem(6).empty_batch(64)
    assert (mine.locked_pop_back_bulk_all(64, out_m)
            == theirs.locked_pop_back_bulk_all(64, out_j))
    for k in out_m:
        np.testing.assert_array_equal(out_m[k], out_j[k])
    assert (mine.size, mine.front) == (theirs.size, theirs.front)


@pytest.mark.parametrize("D", [2, 4])
def test_multi_nqueens_equals_jax_and_seq(D):
    res = multidevice_search(NQueensProblem(9), m=5, M=64, D=D, device="cpu")
    want = jax_multi(JaxNQueens(9), m=5, M=64, D=D)
    seq = sequential_search(NQueensProblem(9))
    assert _counts(res)[:2] == _counts(want)[:2] == _counts(seq)[:2] == (8393, 352)
    assert len(res.per_worker_tree) == D
    assert sum(res.per_worker_tree) == res.phases[1].tree
    assert abs(sum(res.workload_shares()) - 100.0) < 1e-9
    assert res.diagnostics.kernel_launches > 0 and res.engine == "multi"


@pytest.mark.parametrize("lb", ["lb1", "lb2"])
def test_multi_pfsp_fixed_incumbent_equals_jax_and_seq(lb):
    opt = jax_seq(JaxPFSP(lb=lb, ub=0, p_times=PTM)).best
    seq = sequential_search(PFSPProblem(lb=lb, ub=0, p_times=PTM),
                            initial_best=opt)
    want = jax_multi(JaxPFSP(lb=lb, ub=0, p_times=PTM), m=5, M=64, D=2,
                     initial_best=opt)
    res = multidevice_search(PFSPProblem(lb=lb, ub=0, p_times=PTM), m=5,
                             M=64, D=2, device="cpu", initial_best=opt)
    assert _counts(res) == _counts(want) == _counts(seq)
    assert res.staged == (lb == "lb2")


def test_multi_improving_incumbent_finds_the_jax_optimum():
    opt = jax_seq(JaxPFSP(lb="lb1", ub=0, p_times=PTM)).best
    res = multidevice_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM), m=5,
                             M=64, D=4, device="cpu")
    assert res.best == opt


def test_a_worker_error_propagates(monkeypatch):
    prob = NQueensProblem(9)
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("worker fault")

    monkeypatch.setattr(prob, "generate_children", broken)
    with pytest.raises(RuntimeError, match="worker fault"):
        multidevice_search(prob, m=5, M=64, D=2, device="cpu")
    assert calls


def test_multi_cut_resumes_on_the_device_tier_and_back(tmp_path):
    path = str(tmp_path / "multi.npz")
    done = multidevice_search(NQueensProblem(10), m=5, M=64, D=2,
                              device="cpu", checkpoint_path=path,
                              checkpoint_interval_s=0.0)
    assert (done.explored_tree, done.explored_sol) == (35538, 724)
    res = resident_search(NQueensProblem(10), m=5, M=64, K=4, device="cpu",
                          resume_from=path)
    assert (res.explored_tree, res.explored_sol) == (35538, 724)
    cut = str(tmp_path / "device.npz")
    part = resident_search(NQueensProblem(10), m=5, M=64, K=2, device="cpu",
                           max_steps=2, checkpoint_path=cut)
    assert not part.complete
    back = multidevice_search(NQueensProblem(10), m=5, M=64, D=4,
                              device="cpu", resume_from=cut)
    assert (back.explored_tree, back.explored_sol) == (35538, 724)


# -- the CLI ----------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["multi", "mesh"])
def test_cli_records_carry_the_jax_counts(tier, capsys):
    from tpu_tree_search import cli as jax_cli

    argv = ["nqueens", "--N", "8", "--tier", tier, "--D", "2", "--M", "64",
            "--json"]
    assert jax_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rec = json.loads(out.strip().splitlines()[-1])
    shared = set(want) & set(rec)
    assert {"problem", "tier", "explored_tree", "explored_sol", "N",
            "g"} <= shared
    for key in shared - {"elapsed_s", "steals"}:
        assert rec[key] == want[key], key
    assert rec["D"] == 2 and len(rec["per_worker_tree"]) == 2
    assert abs(sum(rec["workload_shares"]) - 100.0) < 1e-9
    banner = "SPMD device-mesh" if tier == "mesh" else "Multi-device"
    assert banner in out and "Workload per device (%)" in out


# -- threads: the build, the entries, the tables ------------------------------------


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.tts_error_string = lambda err: b"fake"


def test_cold_library_builds_once_under_eight_threads(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_CALL_LOCKS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    built = []

    def fake_build_all():
        built.append(threading.get_ident())
        time.sleep(0.05)  # a compiler's time: the others arrive meanwhile
        _build._target(_build.CSRC / "mesh_balance.cu").touch()
        return {"mesh_balance": 0.05}

    monkeypatch.setattr(_build, "build_all", fake_build_all)
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
    assert len(built) == 1
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


def test_compiler_output_is_a_threads_own(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    outs = []
    barrier = threading.Barrier(2)

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            outs.append(out)
            barrier.wait()
            open(out, "wb").close()

        def communicate(self):
            return b"", None

    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    threads = [threading.Thread(target=_build.build_all) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(outs) == 2 and outs[0] != outs[1]
    assert _build._target(csrc / "k.cu").exists()


def test_one_librarys_entries_never_overlap(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_CALL_LOCKS", {})
    _build.entry.cache_clear()
    inside, most = [0], [0]

    def fn(*args):
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        time.sleep(0.005)
        inside[0] -= 1
        return 0

    class Lib:
        def __init__(self, path):
            self.tts_error_string = lambda err: b"fake"
            self.probe = fn

    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    monkeypatch.setattr(_build, "_target", lambda src: tmp_path)
    try:
        _, call = _build.entry("probe_lib", "probe", (ctypes.c_int,))
        threads = [threading.Thread(target=lambda: [call(1) for _ in range(5)])
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        _build.entry.cache_clear()
    assert most[0] == 1


def test_device_tables_build_once_under_threads(monkeypatch):
    from tpu_tree_search_torch.ops import pfsp_device

    prob = PFSPProblem(lb="lb2", ub=0, p_times=PTM)
    real = pfsp_device.PFSPDeviceTables.from_lb1.__func__
    made = []

    def slow(cls, *args, **kw):
        made.append(1)
        time.sleep(0.05)
        return real(cls, *args, **kw)

    monkeypatch.setattr(pfsp_device.PFSPDeviceTables, "from_lb1",
                        classmethod(slow))
    barrier = threading.Barrier(8)
    got = []

    def ask():
        barrier.wait()
        got.append(prob.device_tables("cpu"))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(made) == 1 and all(t is got[0] for t in got)
