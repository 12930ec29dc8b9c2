"""The port's distributed mesh-resident tier (`tpu_tree_search_torch/parallel/
dist_mesh.py`) against the JAX package's (`tpu_tree_search/parallel/
dist_mesh.py`, on the suite's eight virtual CPU devices), on the CPU (the
plain cycles and ``mesh_balance_plain``).

  * one host is the mesh tier: N-Queens N=10 to the sequential counts;
  * virtual hosts at H x D = 2 x 2, 2 x 4 and 4 x 2 reach the sequential
    counts; at 2 x 2 every shard's tree equals the JAX tier's (the exchange
    rounds ride dispatch boundaries, so the run is deterministic);
  * reduced PFSP lb1 at a fixed incumbent equals the JAX tier and the
    sequential tier; ub=0 finds the JAX optimum; the unfused cycles give
    the fused counts;
  * a skewed partition (everything on host 0) feeds host 1 by donations
    and keeps the counts;
  * a ``max_steps`` budget ends incomplete; lockstep cuts at every round
    (interval 0) carry one tag in both v4 files and resume to the goldens,
    a tampered tag is refused; a budget cut resumes to the goldens;
  * a per-host set cut by the JAX tier resumes in the port, and the
    reverse; the CLI cuts with ``--max-steps`` and resumes.

Tolerance: exact equality (counts, per-shard trees).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from tpu_tree_search.engine.sequential import sequential_search as jax_seq
from tpu_tree_search.parallel.dist_mesh import dist_mesh_search as jax_dmesh
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine import checkpoint as ckpt
from tpu_tree_search_torch.parallel.dist_mesh import dist_mesh_search
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

N10 = (35538, 724)
N11 = (166925, 2680)
PTM = taillard.reduced_instance(14, jobs=9, machines=5)


def _counts(res):
    return res.explored_tree, res.explored_sol


def _dm(prob, **kw):
    return dist_mesh_search(prob, device="cpu", **kw)


def test_one_host_is_the_mesh_tier():
    res = _dm(NQueensProblem(10), m=5, M=128, K=4, D=4)
    assert _counts(res) == N10 == _counts(jax_seq(JaxNQueens(N=10)))
    assert res.complete and res.comm["rounds"] == 0 and len(res.per_worker_tree) == 4


def test_two_hosts_equal_jax_shard_for_shard():
    res = _dm(NQueensProblem(10), m=5, M=128, K=4, D=2, num_hosts=2)
    want = jax_dmesh(JaxNQueens(N=10), m=5, M=128, K=4, D=2, num_hosts=2)
    assert _counts(res) == _counts(want) == N10
    assert res.per_worker_tree == want.per_worker_tree
    assert res.comm["rounds"] == want.comm["rounds"]


@pytest.mark.parametrize("H,D", [(2, 4), (4, 2)])
def test_hosts_reach_the_sequential_counts(H, D):
    res = _dm(NQueensProblem(10), m=5, M=128, K=4, D=D, num_hosts=H)
    assert _counts(res) == N10 and len(res.per_worker_tree) == H * D


def test_pfsp_fixed_incumbent_and_ub0_equal_jax():
    opt = jax_seq(JaxPFSP(lb="lb1", ub=0, p_times=PTM)).best
    seq = jax_seq(JaxPFSP(lb="lb1", ub=0, p_times=PTM), initial_best=opt)
    res = _dm(PFSPProblem(lb="lb1", ub=0, p_times=PTM), m=5, M=128, K=4, D=2,
              num_hosts=2, initial_best=opt)
    assert (*_counts(res), res.best) == (*_counts(seq), opt)
    unfused = _dm(PFSPProblem(lb="lb1", ub=0, p_times=PTM), m=5, M=128, K=4,
                  D=2, num_hosts=2, initial_best=opt, fused=False)
    assert _counts(unfused) == _counts(res) and not unfused.fused
    want0 = jax_dmesh(JaxPFSP(lb="lb1", ub=0, p_times=PTM), m=5, M=128, K=4,
                      D=2, num_hosts=2)
    res0 = _dm(PFSPProblem(lb="lb1", ub=0, p_times=PTM), m=5, M=128, K=4, D=2,
               num_hosts=2)
    assert res0.best == want0.best == opt


def test_skewed_partition_forces_donations():
    def all_to_host0(warm, host_id, num_hosts):
        return {k: (v if host_id == 0 else v[:0]) for k, v in warm.items()}

    res = _dm(NQueensProblem(11), m=5, M=128, K=2, D=2, num_hosts=2,
              partition_fn=all_to_host0)
    assert _counts(res) == N11
    assert res.comm["blocks_received"] > 0
    assert res.comm["nodes_sent"] == res.comm["nodes_received"]
    assert sum(res.per_worker_tree[2:]) > 0


def _header(path):
    with np.load(path) as data:
        return json.loads(bytes(data["header"]).decode())


def test_lockstep_cuts_resume_and_a_tampered_tag_is_refused(tmp_path):
    path = str(tmp_path / "dm.ckpt")
    budget = _dm(NQueensProblem(12), m=5, M=64, K=1, rounds=1, D=2,
                 num_hosts=2, max_steps=2)
    assert not budget.complete and budget.explored_tree > 0
    full = _dm(NQueensProblem(10), m=5, M=128, K=2, rounds=1, D=2,
               num_hosts=2, checkpoint_path=path, checkpoint_interval_s=0.0)
    assert _counts(full) == N10
    heads = [_header(f"{path}.h{h}") for h in (0, 1)]
    assert [(h["version"], h["hosts"]) for h in heads] == [(4, 2)] * 2
    assert heads[0]["cut_tag"] == heads[1]["cut_tag"] and ":" in heads[0]["cut_tag"]
    resumed = _dm(NQueensProblem(10), m=5, M=128, K=2, rounds=1, D=2,
                  num_hosts=2, resume_from=path)
    assert _counts(resumed) == N10
    one = ckpt.load(f"{path}.h1", NQueensProblem(10), expect_hosts=2)
    ckpt.save(f"{path}.h1", NQueensProblem(10), one.batch, one.best, one.tree,
              one.sol, hosts=2, cut_tag="deadbeef0000:999")
    with pytest.raises(ValueError, match="incoherent multi-host resume"):
        _dm(NQueensProblem(10), m=5, M=128, K=2, rounds=1, D=2, num_hosts=2,
            resume_from=path)


def test_a_budget_cut_resumes_to_the_goldens(tmp_path):
    path = str(tmp_path / "cut.ckpt")
    part = _dm(NQueensProblem(11), m=5, M=64, K=1, rounds=1, D=2, num_hosts=2,
               max_steps=2, checkpoint_path=path)
    assert not part.complete
    assert os.path.exists(f"{path}.h0") and os.path.exists(f"{path}.h1")
    resumed = _dm(NQueensProblem(11), m=5, M=64, K=2, rounds=1, D=2,
                  num_hosts=2, resume_from=path)
    assert _counts(resumed) == N11 and resumed.complete


def test_a_jax_cut_resumes_in_the_port_and_back(tmp_path):
    jpath, ppath = str(tmp_path / "j.ckpt"), str(tmp_path / "p.ckpt")
    kw = dict(m=5, M=64, K=2, rounds=1, D=2, num_hosts=2)
    part = jax_dmesh(JaxNQueens(N=10), max_steps=2, checkpoint_path=jpath, **kw)
    assert not part.complete
    assert _counts(_dm(NQueensProblem(10), resume_from=jpath, **kw)) == N10
    mine = _dm(NQueensProblem(10), max_steps=2, checkpoint_path=ppath, **kw)
    assert not mine.complete
    assert _counts(jax_dmesh(JaxNQueens(N=10), resume_from=ppath, **kw)) == N10


def test_cli_cuts_with_max_steps_and_resumes(tmp_path, capsys):
    path = str(tmp_path / "c.ckpt")
    base = ["nqueens", "--N", "10", "--tier", "dist_mesh", "--hosts", "2",
            "--D", "2", "--m", "5", "--M", "64", "--device", "cpu", "--json"]
    assert cli.main(base + ["--K", "1", "--max-steps", "2",
                            "--checkpoint", path]) == 0
    out = capsys.readouterr().out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["complete"] is False and "resume with --resume" in out
    assert cli.main(base + ["--resume", path]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == N10
    assert (rec["engine"], rec["hosts"], rec["D"]) == ("dist_mesh", 2, 2)
    assert rec["comm"]["rounds"] > 0 and rec["dispatches"] > 0
