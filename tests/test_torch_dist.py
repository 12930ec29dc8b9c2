"""The port's distributed tier (`tpu_tree_search_torch/parallel/dist.py`, the
multi-host hooks of `parallel/multidevice.py`, `engine/checkpoint.py`
``lockstep_commit``) against the JAX package's (`tpu_tree_search/parallel/
dist.py`, run on the suite's eight virtual CPU devices), on the CPU.

  * ``ThreadCollectives``: reductions, the ragged allgather, the kv channel
    and its timeout;
  * virtual hosts: N-Queens N=9 at H x D = 2 x 2 and 4 x 1, reduced PFSP
    lb1 at a fixed incumbent and ``steal=False`` equal the JAX tier's and
    the sequential tier's counts; ub=0 finds the JAX optimum; one host is
    the degenerate case; a skewed partition feeds the starved host through
    donations capped at M; a balanced run backs its cadence off; per-pool
    drain leftovers still terminate; a transport that dies mid-donation
    requeues the block; a worker's death surfaces as the root cause;
  * ``TorchCollectives`` (a ``TCPStore`` on loopback): one rank in this
    process; 2 processes (reductions, a ragged allgather, kv both ways, a
    skewed dist search, a lockstep cut and its resume, a skewed dist_mesh
    search); 4 processes with steal churn; a peer killed mid-donation fails
    the survivor within its timeout; the CLI's ``--distributed`` runs of
    both tiers (two processes) to the goldens, and one that cannot reach
    its store exits 2;
  * checkpoints: a per-host v4 set cut by the JAX ``dist_search`` (H = 2)
    resumes in the port to the goldens, and the reverse.

Tolerance: exact equality (counts, node values).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from tpu_tree_search.engine.sequential import sequential_search as jax_seq
from tpu_tree_search.parallel.dist import dist_search as jax_dist
from tpu_tree_search.pool import SoAPool as JaxSoAPool
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine import checkpoint as ckpt
from tpu_tree_search_torch.parallel.dist import (
    ThreadCollectives,
    TorchCollectives,
    _HostComm,
    dist_search,
    secondary_error,
)
from tpu_tree_search_torch.pool import ParallelSoAPool, SoAPool
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

ROOT = Path(__file__).resolve().parent.parent
N10 = (35538, 724)


def _counts(res):
    return res.explored_tree, res.explored_sol


def _skew(warm, host_id, num_hosts):
    """Every warm node on host 0: the others live off donations."""
    return {k: (v if host_id == 0 else v[:0]) for k, v in warm.items()}


def _in_threads(H, fn):
    out, ts = {}, []
    for h in range(H):
        ts.append(threading.Thread(target=lambda h=h: out.__setitem__(h, fn(h))))
        ts[-1].start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    return out


def test_thread_collectives_reduce_and_gather():
    coll = ThreadCollectives(3)
    out = _in_threads(3, lambda h: (
        coll.bind(h).allreduce_sum(h + 1), coll.allreduce_min(h),
        coll.allreduce_max(h), coll.allgather_obj({"h": h, "pad": [0] * h})))
    assert out[0][:3] == out[1][:3] == out[2][:3] == (6, 0, 2)
    assert [r["h"] for r in out[1][3]] == [0, 1, 2]
    assert out[0][3] == out[2][3]


def test_thread_collectives_kv_channel_and_timeout():
    coll = ThreadCollectives(2)
    got = _in_threads(2, lambda h: (
        coll.bind(h).kv_set("tts/steal/1/0->1", b"payload") if h == 0
        else coll.bind(h).kv_get("tts/steal/1/0->1", timeout_s=5.0)))
    assert got[1] == b"payload" and coll._kv == {}
    one = ThreadCollectives(1).bind(0)
    with pytest.raises(TimeoutError):
        one.kv_get("missing", timeout_s=0.1)
    one.abort()
    with pytest.raises(TimeoutError, match="peer aborted") as e:
        one.kv_get("missing", timeout_s=5.0)
    assert secondary_error(e.value)


@pytest.mark.parametrize("H,D", [(2, 2), (4, 1)])
def test_nqueens_equals_jax_and_seq(H, D):
    res = dist_search(NQueensProblem(9), m=5, M=128, D=D, num_hosts=H,
                      device="cpu")
    want = jax_dist(JaxNQueens(N=9), m=5, M=128, D=D, num_hosts=H)
    assert _counts(res) == _counts(want) == _counts(jax_seq(JaxNQueens(N=9)))
    assert len(res.per_worker_tree) == H * D == len(want.per_worker_tree)
    assert res.comm["rounds"] > 0 and res.engine == "dist"
    assert res.diagnostics.kernel_launches > 0


def test_pfsp_fixed_incumbent_equals_jax():
    ptm = taillard.reduced_instance(14, jobs=8, machines=5)
    opt = jax_seq(JaxPFSP(lb="lb1", ub=0, p_times=ptm)).best
    want = jax_dist(JaxPFSP(lb="lb1", ub=0, p_times=ptm), m=5, M=64, D=2,
                    num_hosts=2, initial_best=opt)
    res = dist_search(PFSPProblem(lb="lb1", ub=0, p_times=ptm), m=5, M=64,
                      D=2, num_hosts=2, initial_best=opt, device="cpu")
    seq = jax_seq(JaxPFSP(lb="lb1", ub=0, p_times=ptm), initial_best=opt)
    assert (*_counts(res), res.best) == (*_counts(want), want.best) == \
        (*_counts(seq), opt)


@pytest.mark.parametrize("lb,inst,jobs,machines", [("lb1", 14, 7, 5),
                                                    ("lb2", 21, 7, 5)])
def test_pfsp_improving_incumbent_finds_the_jax_optimum(lb, inst, jobs,
                                                        machines):
    ptm = taillard.reduced_instance(inst, jobs=jobs, machines=machines)
    opt = jax_seq(JaxPFSP(lb=lb, ub=0, p_times=ptm)).best
    res = dist_search(PFSPProblem(lb=lb, ub=0, p_times=ptm), m=5, M=64, D=2,
                      num_hosts=2, steal_interval_s=0.005, device="cpu")
    assert res.best == opt and res.staged == (lb == "lb2")


def test_single_host_and_no_steal_equal_jax():
    one = dist_search(NQueensProblem(8), m=5, M=128, device="cpu")
    assert _counts(one) == (2056, 92) and one.comm is None
    res = dist_search(NQueensProblem(9), m=5, M=128, D=2, num_hosts=2,
                      steal=False, device="cpu")
    want = jax_dist(JaxNQueens(N=9), m=5, M=128, D=2, num_hosts=2, steal=False)
    assert _counts(res) == _counts(want) == (8393, 352)
    assert res.comm is None and res.steal_policy is None


def test_skewed_partition_feeds_the_starved_host_in_capped_blocks():
    M = 32
    res = dist_search(NQueensProblem(10), m=5, M=M, D=2, num_hosts=2,
                      steal_interval_s=0.005, partition_fn=_skew,
                      device="cpu")
    assert _counts(res) == N10
    assert sum(res.per_worker_tree[2:]) > 0, "the starved host explored nothing"
    c = res.comm
    assert c["blocks_received"] > 0 and c["nodes_sent"] == c["nodes_received"]
    assert c["nodes_received"] <= c["blocks_received"] * M


def test_terminates_with_drain_leftovers_and_backs_off():
    # m=25, D=3: per-pool leftovers below m can sum past 2m a host, with no
    # pool able to donate; quiescence keys on the largest pool.
    res = dist_search(NQueensProblem(9), m=25, M=64, D=3, num_hosts=2,
                      steal_interval_s=0.005, device="cpu")
    assert _counts(res) == (8393, 352)
    interval = 0.002
    bal = dist_search(NQueensProblem(10), m=5, M=2048, D=2, num_hosts=2,
                      steal_interval_s=interval, device="cpu")
    assert _counts(bal) == N10
    assert bal.comm["rounds"] < max(10.0, bal.elapsed / interval / 2), bal.comm


def test_pop_front_bulk_half_cap_equals_jax():
    fields = {"x": ((), np.int32)}
    mine, theirs = SoAPool(fields), JaxSoAPool(fields)
    for p in (mine, theirs):
        p.push_back_bulk({"x": np.arange(10000, dtype=np.int32)})
    for cap in (64, None):
        a = mine.pop_front_bulk_half(m=5, perc=0.5, cap=cap)
        b = theirs.pop_front_bulk_half(m=5, perc=0.5, cap=cap)
        np.testing.assert_array_equal(a["x"], b["x"])
    assert mine.size == theirs.size == 10000 - 64 - (10000 - 64) // 2


def test_a_transport_that_dies_mid_donation_requeues_the_block():
    class DyingTransport:
        """Round 1 matches host 0 (rich) to host 1 (idle); the send dies."""
        num_hosts, host_id = 2, 0

        def allgather_obj(self, row):
            return [row, (0, 0, row[2], True, False, None)]

        def kv_set(self, key, value):
            raise RuntimeError("transport died mid-donation")

    class States:
        flag = threading.Event()

        def _all_idle(self):
            return False

    class Shared:
        def read(self):
            return 10**9

        def publish(self, v):
            return v

    pool = ParallelSoAPool({"x": ((), np.int32)})
    pool.push_back_bulk({"x": np.arange(100, dtype=np.int32)})
    comm = _HostComm(DyingTransport(), 5, interval_s=0.0)
    stop = threading.Event()
    comm.run([pool], States(), Shared(), stop)
    assert isinstance(comm.error, RuntimeError) and stop.is_set()
    assert comm._inflight is None and pool.size == 100


def test_a_worker_death_surfaces_as_the_root_cause():
    calls = {"n": 0}
    orig = NQueensProblem.generate_children

    def dying(self, *args):
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("injected worker death")
        return orig(self, *args)

    t0 = time.monotonic()
    with mock.patch.object(NQueensProblem, "generate_children", dying):
        with pytest.raises(RuntimeError, match="injected worker death"):
            dist_search(NQueensProblem(10), m=5, M=64, D=2, num_hosts=2,
                        steal_interval_s=0.005, partition_fn=_skew,
                        device="cpu")
    assert time.monotonic() - t0 < 30.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torch_collectives_one_rank():
    coll = TorchCollectives("127.0.0.1", _free_port(), 1, 0, timeout_s=10.0)
    try:
        assert (coll.num_hosts, coll.host_id, coll.is_master) == (1, 0, True)
        assert coll.allreduce_sum(7) == 7 and coll.allgather_obj([1]) == [[1]]
        coll.kv_set("tts/steal/7/0->0", b"kv-bytes")
        assert coll.kv_get("tts/steal/7/0->0", timeout_s=5.0) == b"kv-bytes"
        with pytest.raises(TimeoutError, match="peer aborted"):
            coll.kv_get("tts/missing", timeout_s=0.2)
        res = dist_search(NQueensProblem(8), m=5, M=64, device="cpu",
                          collectives=coll)
        assert _counts(res) == (2056, 92)
    finally:
        coll.close()


def _run_ranks(code: str, n: int, port: int, timeout: float = 120.0,
               argv=None) -> list:
    """``code`` (or the CLI with ``argv``) in n processes, rank r getting
    ``sys.argv[1:] == [r, port]``; returns (rc, stdout, stderr) by rank."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for r in range(n):
        cmd = ([sys.executable, "-c", code, str(r), str(port)] if argv is None
               else [sys.executable, "-m", "tpu_tree_search_torch", *argv,
                     "--host-id", str(r)])
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env, cwd=ROOT))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


_PRELUDE = """
import os, sys, time
rank, port = int(sys.argv[1]), int(sys.argv[2])
from tpu_tree_search_torch.parallel.dist import TorchCollectives, dist_search
from tpu_tree_search_torch.parallel.dist_mesh import dist_mesh_search
from tpu_tree_search_torch.problems import NQueensProblem

def skew(warm, host_id, num_hosts):
    return {k: (v if host_id == 0 else v[:0]) for k, v in warm.items()}
"""

_TWO_RANKS = _PRELUDE + """
coll = TorchCollectives("127.0.0.1", port, 2, rank, timeout_s=60.0)
assert coll.allreduce_sum(10 + rank) == 21
assert coll.allreduce_min(float(rank)) == 0.0
assert coll.allreduce_max(float(rank)) == 1.0
got = coll.allgather_obj({"rank": rank, "pad": "x" * (100 * (rank + 1))})
assert [g["rank"] for g in got] == [0, 1] and len(got[1]["pad"]) == 200
coll.kv_set(f"tts/test/{rank}", bytes([rank]) * 64)
assert coll.kv_get(f"tts/test/{1 - rank}", timeout_s=30.0) == bytes([1 - rank]) * 64

res = dist_search(NQueensProblem(10), m=5, M=256, D=2, device="cpu",
                  steal_interval_s=0.005, partition_fn=skew, collectives=coll)
assert (res.explored_tree, res.explored_sol) == (35538, 724), res
assert res.comm["blocks_received"] > 0 and len(res.per_worker_tree) == 4

path = sys.argv[3]
res2 = dist_search(NQueensProblem(10), m=5, M=256, D=2, device="cpu",
                   steal_interval_s=0.005, checkpoint_path=path,
                   checkpoint_interval_s=0.0, collectives=coll)
assert (res2.explored_tree, res2.explored_sol) == (35538, 724)
assert os.path.exists(f"{path}.h{rank}"), "per-host cut missing"
res3 = dist_search(NQueensProblem(10), m=5, M=256, D=2, device="cpu",
                   steal_interval_s=0.005, resume_from=path, collectives=coll)
assert (res3.explored_tree, res3.explored_sol) == (35538, 724)

res4 = dist_mesh_search(NQueensProblem(10), m=5, M=128, K=4, D=2,
                        device="cpu", partition_fn=skew, collectives=coll)
assert (res4.explored_tree, res4.explored_sol) == (35538, 724), res4
assert res4.comm["blocks_received"] > 0 and res4.comm["exchange_s"] > 0
coll.close()
print(f"RANK{rank}_OK donations={res.comm['blocks_received']}")
"""


def test_torch_collectives_two_processes(tmp_path):
    code = _TWO_RANKS.replace("path = sys.argv[3]",
                              f"path = {str(tmp_path / 'c.ckpt')!r}")
    outs = _run_ranks(code, 2, _free_port())
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"RANK{rank}_OK" in out, (rank, rc, err[-2000:])


_FOUR_RANKS = _PRELUDE + """
coll = TorchCollectives("127.0.0.1", port, 4, rank, timeout_s=60.0)
res = dist_search(NQueensProblem(10), m=5, M=128, D=1, device="cpu",
                  steal_interval_s=0.005, partition_fn=skew, collectives=coll)
assert (res.explored_tree, res.explored_sol) == (35538, 724), res
assert res.comm["blocks_received"] >= 3
coll.close()
print(f"RANK{rank}_OK")
"""


def test_torch_collectives_four_processes_steal_churn():
    outs = _run_ranks(_FOUR_RANKS, 4, _free_port())
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"RANK{rank}_OK" in out, (rank, rc, err[-2000:])


_KILLED_PEER = _PRELUDE + """
coll = TorchCollectives("127.0.0.1", port, 2, rank, timeout_s=3.0)
if rank == 1:
    # Die as the receiver of a donation, its block undelivered: SIGKILL.
    real_get = TorchCollectives.kv_get
    def dying_get(self, key, timeout_s):
        if "/steal/" in key:
            os.kill(os.getpid(), 9)
        return real_get(self, key, timeout_s)
    TorchCollectives.kv_get = dying_get
t0 = time.monotonic()
try:
    dist_search(NQueensProblem(12), m=5, M=256, D=1, device="cpu",
                steal_interval_s=0.005, partition_fn=skew, collectives=coll)
except TimeoutError as e:
    print(f"SURVIVOR_ABORTED after {time.monotonic() - t0:.1f}s: {e}", flush=True)
    coll.close(wait=False)
    sys.exit(3)
print("UNEXPECTED_COMPLETION", flush=True)
"""


def test_torch_collectives_killed_peer_fails_stop():
    (rc0, out0, err0), (rc1, out1, _) = _run_ranks(_KILLED_PEER, 2, _free_port())
    assert rc1 == -9 and "SURVIVOR" not in out1
    assert rc0 == 3 and "SURVIVOR_ABORTED" in out0, (rc0, out0, err0[-2000:])
    assert "peer aborted" in out0
    assert float(out0.split("after ")[1].split("s:")[0]) < 3.0 + 10.0


def test_cli_distributed_two_processes_of_each_tier():
    """Two ``--distributed`` CLI processes a tier, both tiers at once (on
    two stores): each rank's record has the goldens; rank 0 alone prints
    the banner."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    procs = {}
    for tier in ("dist", "dist_mesh"):
        argv = [sys.executable, "-m", "tpu_tree_search_torch", "nqueens",
                "--N", "10", "--tier", tier, "--distributed", "--coordinator",
                f"127.0.0.1:{_free_port()}", "--num-hosts", "2", "--D", "1",
                "--device", "cpu", "--M", "256", "--json"]
        for r in (0, 1):
            procs[tier, r] = subprocess.Popen(
                argv + ["--host-id", str(r)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    outs = {}
    try:
        for key, p in procs.items():
            outs[key] = (*p.communicate(timeout=120), p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for (tier, rank), (out, err, rc) in outs.items():
        assert rc == 0, (tier, rank, err[-2000:])
        rec = json.loads(out.strip().splitlines()[-1])
        assert (rec["explored_tree"], rec["explored_sol"]) == N10
        assert (rec["tier"], rec["host_id"], rec["num_hosts"], rec["hosts"]) \
            == (tier, rank, 2, 2)
        assert rec["comm"]["rounds"] > 0
        assert ("Distributed" in out) == (rank == 0)


def test_cli_distributed_without_a_store_exits_2(capsys, monkeypatch):
    monkeypatch.setattr(TorchCollectives, "AG_TIMEOUT_S", 1.0)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    base = ["nqueens", "--N", "8", "--tier", "dist", "--distributed",
            "--device", "cpu"]
    assert cli.main(base) == 2
    assert "MASTER_ADDR" in capsys.readouterr().err
    # Rank 1 of 2 with no rank 0 listening: no run as one host.
    assert cli.main(base + ["--coordinator", f"127.0.0.1:{_free_port()}",
                            "--num-hosts", "2", "--host-id", "1"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("Error:") and "cannot reach the coordinator" in err


def _header(path):
    with np.load(path) as data:
        return json.loads(bytes(data["header"]).decode())


def test_a_jax_dist_cut_resumes_in_the_port(tmp_path):
    path = str(tmp_path / "jd.ckpt")
    full = jax_dist(JaxNQueens(N=10), m=5, M=64, D=2, num_hosts=2,
                    steal_interval_s=0.005, checkpoint_path=path,
                    checkpoint_interval_s=0.0)
    assert _counts(full) == N10
    heads = [_header(f"{path}.h{h}") for h in (0, 1)]
    assert [h["version"] for h in heads] == [ckpt.FORMAT_VERSION] * 2
    assert heads[0]["cut_tag"] == heads[1]["cut_tag"] is not None
    res = dist_search(NQueensProblem(10), m=5, M=64, D=2, num_hosts=2,
                      steal_interval_s=0.005, resume_from=path, device="cpu")
    assert _counts(res) == N10


def test_a_port_dist_cut_resumes_in_jax(tmp_path):
    path = str(tmp_path / "pd.ckpt")
    full = dist_search(NQueensProblem(10), m=5, M=64, D=2, num_hosts=2,
                       steal_interval_s=0.005, checkpoint_path=path,
                       checkpoint_interval_s=0.0, device="cpu")
    assert _counts(full) == N10
    heads = [_header(f"{path}.h{h}") for h in (0, 1)]
    assert [(h["version"], h["hosts"]) for h in heads] == [(4, 2)] * 2
    assert heads[0]["cut_tag"] == heads[1]["cut_tag"] is not None
    res = jax_dist(JaxNQueens(N=10), m=5, M=64, D=2, num_hosts=2,
                   steal_interval_s=0.005, resume_from=path)
    assert _counts(res) == N10
    # A tampered tag: the files are of two cuts, and the resume refuses.
    one = ckpt.load(f"{path}.h1", NQueensProblem(10), expect_hosts=2)
    ckpt.save(f"{path}.h1", NQueensProblem(10), one.batch, one.best, one.tree,
              one.sol, hosts=2, cut_tag="deadbeef0000:999")
    with pytest.raises(ValueError, match="incoherent multi-host resume"):
        dist_search(NQueensProblem(10), m=5, M=64, D=2, num_hosts=2,
                    resume_from=path, device="cpu")


def test_lockstep_commit_vetoes_and_keeps_the_previous_cut(tmp_path, capsys):
    final, staging = tmp_path / "f", tmp_path / "f.staging"
    final.write_bytes(b"old")
    staging.write_bytes(b"new")
    assert not ckpt.lockstep_commit(True, str(staging), str(final),
                                    vote=lambda ok: [ok, False])
    assert final.read_bytes() == b"old" and not staging.exists()
    assert "NOT committed" in capsys.readouterr().err
    staging.write_bytes(b"new")
    assert ckpt.lockstep_commit(True, str(staging), str(final),
                                vote=lambda ok: [ok, True])
    assert final.read_bytes() == b"new" and not staging.exists()
