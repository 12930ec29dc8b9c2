"""The port's steal topology (`tpu_tree_search_torch/parallel/topology.py`)
against the JAX package's (`tpu_tree_search/parallel/topology.py`), on the
CPU.

  * ``steal_mode``, ``_parse_pods``, ``Topology`` (link classes, ``detect``
    with and without ``TTS_PODS``), ``SimLinks``, ``bytes_per_node``,
    ``resolve_policy`` (flat, hier on the fixed fallbacks, hier from a
    COSTMODEL.json profile) and ``StealPolicy.match``/``describe`` give the
    JAX outputs for the same inputs;
  * the knobs stay on the host (in place of the JAX ``steal-knob-inert``
    contract): ``TTS_STEAL``, ``TTS_PODS`` and ``TTS_SIM_LAT_*`` change
    neither ``mesh_key`` nor ``program_key``, and a virtual-host dist_mesh
    search under them takes the mesh program a plain mesh search cached;
  * under ``TTS_STEAL=hier`` with two pods the dist tier's counts equal
    the JAX dist tier's and the sequential tier's, and the dist_mesh
    tier's the sequential tier's; the record and the banner show the
    policy.

Tolerance: exact equality.
"""

from __future__ import annotations

import json

import pytest

from tpu_tree_search.engine.sequential import sequential_search as jax_seq
from tpu_tree_search.obs import costmodel as jax_cm
from tpu_tree_search.parallel import topology as JT
from tpu_tree_search.parallel.dist import dist_search as jax_dist
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine import resident as R
from tpu_tree_search_torch.parallel import topology as T
from tpu_tree_search_torch.parallel.dist import dist_search
from tpu_tree_search_torch.parallel.dist_mesh import dist_mesh_search
from tpu_tree_search_torch.parallel.resident_mesh import (
    mesh_key,
    mesh_resident_search,
)
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

KNOBS = ("TTS_STEAL", "TTS_PODS", "TTS_SIM_LAT_ICI", "TTS_SIM_LAT_DCN",
         "TTS_COSTMODEL", "TTS_OBS")


@pytest.fixture(autouse=True)
def _clean_steal_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("raw", [None, "hier", "HIER ", "flat",
                                 "hierarchical"])
def test_steal_mode_equals_jax(raw, monkeypatch):
    if raw is not None:
        monkeypatch.setenv("TTS_STEAL", raw)
    assert T.steal_mode() == JT.steal_mode()


@pytest.mark.parametrize("raw,H", [("2", 6), ("2", 4), ("3", 3), ("0,0,1,1", 4),
                                   ("0,1", 4), ("0", 4), ("two", 4), ("", 4),
                                   ("4", 3)])
def test_parse_pods_equals_jax(raw, H):
    assert T._parse_pods(raw, H) == JT._parse_pods(raw, H)


def test_topology_equals_jax(monkeypatch):
    for pods in ([0, 0, 1, 1], [0, 1, 2], None):
        H = len(pods) if pods else 3
        a, b = T.Topology(H, pods), JT.Topology(H, pods)
        assert [a.link_class(i, j) for i in range(H) for j in range(H)] == \
            [b.link_class(i, j) for i in range(H) for j in range(H)]
        assert (a.num_pods, a.describe()) == (b.num_pods, b.describe())
    monkeypatch.setenv("TTS_PODS", "2")
    assert T.Topology.detect(4).pod_of == JT.Topology.detect(4).pod_of == [0, 0, 1, 1]
    monkeypatch.delenv("TTS_PODS")
    # No slice index on a GPU host: one pod, as JAX without one.
    assert T.Topology.detect(3).pod_of == JT.Topology.detect(3).pod_of
    gather = lambda v: [0, 1, 1]  # noqa: E731
    assert (T.Topology.detect(3, slice_index=1, allgather=gather).pod_of
            == JT.Topology.detect(3, slice_index=1, allgather=gather).pod_of)


def test_sim_links_equal_jax(monkeypatch):
    assert T.SimLinks().armed == JT.SimLinks().armed is False
    monkeypatch.setenv("TTS_SIM_LAT_ICI", "0.001")
    monkeypatch.setenv("TTS_SIM_LAT_DCN", "not-a-float")
    assert T.SimLinks().lat_s == JT.SimLinks().lat_s == {T.LINK_ICI: 0.001}


@pytest.mark.parametrize("make", [
    lambda P: P[0](N=6),
    lambda P: P[1](lb="lb2", ub=0, p_times=taillard.reduced_instance(
        14, jobs=8, machines=5)),
])
def test_bytes_per_node_equals_jax(make):
    assert (T.bytes_per_node(make((NQueensProblem, PFSPProblem)))
            == JT.bytes_per_node(make((JaxNQueens, JaxPFSP))))


def _policies(pods, mode=None, **kw):
    kw = {"m": 5, "cap": 64, "interval_s": 0.01, **kw}
    mine = T.resolve_policy(NQueensProblem(N=6), T.Topology(len(pods), pods),
                            mode=mode, **kw)
    theirs = JT.resolve_policy(JaxNQueens(N=6), JT.Topology(len(pods), pods),
                               mode=mode, **kw)
    return mine, theirs


def test_flat_policy_equals_jax():
    mine, theirs = _policies([0, 0, 1, 1])
    assert not mine.hier and mine.describe() == theirs.describe()
    assert [mine.cap_for(k) for k in T.LINK_CLASSES] == \
        [theirs.cap_for(k) for k in JT.LINK_CLASSES] == [64] * 3


def test_hier_fixed_policy_equals_jax(monkeypatch):
    monkeypatch.setenv("TTS_STEAL", "hier")
    mine, theirs = _policies([0, 0, 1, 1])
    assert mine.hier and mine.describe() == theirs.describe()
    assert [mine.level_of(k) for k in T.LINK_CLASSES] == \
        [theirs.level_of(k) for k in JT.LINK_CLASSES]
    assert mine.levels[T.LINK_DCN].quantum == 64 * T.FAR_QUANTUM_MULT


def test_hier_policy_from_a_profile_equals_jax(tmp_path, monkeypatch):
    key = jax_cm.profile_key("cpu", "topo-x", jax_cm.shape_class(JaxNQueens(N=6)))
    links = {"offload": {"per_unit_us": 10.0},
             "donate:ici": {"latency_us": 100.0, "per_unit_us": 0.0},
             "donate:dcn": {"latency_us": 2000.0, "per_unit_us": 0.0}}
    path = tmp_path / "COSTMODEL.json"
    path.write_text(json.dumps({key: {"links": links}}))
    monkeypatch.setenv("TTS_COSTMODEL", str(path))
    monkeypatch.setenv("TTS_STEAL", "hier")
    mine, theirs = _policies([0, 0, 1, 1], interval_s=0.005, backend="cpu",
                             topo_str="topo-x")
    assert mine.describe() == theirs.describe()
    assert mine.levels[T.LINK_ICI].source == key
    assert (mine.levels[T.LINK_ICI].quantum, mine.levels[T.LINK_DCN].every) == (100, 4)


@pytest.mark.parametrize("pods,donors,needy,rounds,sizes", [
    ([0, 0, 1, 1], [2, 0], [1], range(2), None),      # the near donor wins
    ([0, 0, 1, 1], [0], [3], range(9), None),         # far only on far rounds
    ([0, 0, 1, 1], [0], [3], range(2), [19, 0, 0, 0]),  # below the far floor
    ([0, 0, 1, 1], [0], [3], range(2), [256, 0, 0, 0]),
    ([0, 0, 0, 1, 1, 1], [0, 3], [1, 2, 4], range(3), None),
])
def test_match_equals_jax(pods, donors, needy, rounds, sizes):
    mine, theirs = _policies(pods, mode="hier")
    for r in rounds:
        got = mine.match(list(donors), list(needy), r, sizes=sizes)
        assert got == theirs.match(list(donors), list(needy), r, sizes=sizes)
        assert len({d for d, _ in got}) == len(got)  # a donor once a round


def test_steal_knobs_reach_no_program_key(monkeypatch):
    """The knobs are host-side: neither the mesh program's cache key nor
    the resident one (whose graphs a mesh dispatch holds) moves, and a
    two-host dist_mesh search under them takes the program a plain mesh
    search cached (no second key, no new program for host 0)."""
    args = (2, 5, 128, 4, 1, 10, 4096, "cpu", True, True)
    plain = (mesh_key(*args), R.program_key(5, 128, 4, 4096, "cpu", True,
                                            True, None))
    prob = NQueensProblem(8)
    mesh_resident_search(prob, m=5, M=128, K=4, D=2, device="cpu")
    (cached,) = prob._mesh_programs.values()
    monkeypatch.setenv("TTS_STEAL", "hier")
    monkeypatch.setenv("TTS_PODS", "0,1")
    monkeypatch.setenv("TTS_SIM_LAT_ICI", "0.0001")
    monkeypatch.setenv("TTS_SIM_LAT_DCN", "0.0002")
    assert (mesh_key(*args), R.program_key(5, 128, 4, 4096, "cpu", True,
                                           True, None)) == plain
    res = dist_mesh_search(prob, m=5, M=128, K=4, D=2, num_hosts=2,
                           device="cpu")
    assert (res.explored_tree, res.explored_sol) == (2056, 92)
    assert list(prob._mesh_programs.values()) == [cached]
    assert res.steal_policy["mode"] == "hier"
    assert res.steal_policy["sim_lat_s"] == {"dcn": 0.0002, "ici": 0.0001}


def test_dist_hier_counts_equal_jax(monkeypatch):
    monkeypatch.setenv("TTS_STEAL", "hier")
    monkeypatch.setenv("TTS_PODS", "2")
    want = jax_dist(JaxNQueens(N=9), m=5, M=128, D=1, num_hosts=4)
    res = dist_search(NQueensProblem(9), m=5, M=128, D=1, num_hosts=4,
                      device="cpu")
    seq = jax_seq(JaxNQueens(N=9))
    assert (res.explored_tree, res.explored_sol) == \
        (want.explored_tree, want.explored_sol) == \
        (seq.explored_tree, seq.explored_sol)
    assert res.steal_policy == want.steal_policy
    assert res.steal_policy["pods"] == [0, 0, 1, 1]


def test_dist_mesh_hier_counts_equal_the_sequential_tier(monkeypatch):
    monkeypatch.setenv("TTS_STEAL", "hier")
    monkeypatch.setenv("TTS_PODS", "2")
    seq = jax_seq(JaxNQueens(N=10))
    res = dist_mesh_search(NQueensProblem(10), m=5, M=128, K=4, D=2,
                           num_hosts=2, device="cpu")
    assert (res.explored_tree, res.explored_sol) == \
        (seq.explored_tree, seq.explored_sol)
    assert res.steal_policy["mode"] == "hier"


def test_cli_json_and_banner_show_the_policy(capsys, monkeypatch):
    monkeypatch.setenv("TTS_STEAL", "hier")
    monkeypatch.setenv("TTS_PODS", "2")
    assert cli.main(["nqueens", "--N", "8", "--tier", "dist", "--m", "5",
                     "--M", "64", "--hosts", "2", "--device", "cpu",
                     "--json"]) == 0
    out = capsys.readouterr().out
    rec = json.loads(out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == (2056, 92)
    assert rec["steal_policy"]["mode"] == "hier"
    assert rec["steal_policy"]["levels"][T.LINK_DCN]["every"] >= 2
    assert "TTS_STEAL" in out and "Steal policy: hier" in out
