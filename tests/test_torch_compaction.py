"""The port's survivor compaction against `tpu_tree_search/ops/compaction.py`.

``compact_ids`` in all four modes (``scatter``, ``sort``, ``search``,
``dense``), ``survivor_ranks`` and ``shift_compact`` must return exactly
what the JAX functions return — the full id vectors (survivor prefix and
garbage tail alike) and the survivor count. Masks are made with numpy from
a seed at several survivor densities, with a survivor budget S below and
at M*n. The ``TTS_COMPACT`` knob resolves as the JAX one does, and whole
unfused searches under each explicit mode equal the JAX
``resident_search`` under the same knob.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.engine.resident import resident_search as jax_resident_search
from tpu_tree_search.ops import compaction as jc
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import PFSPProblem as JaxPFSP
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.ops import compact_policy as tp
from tpu_tree_search_torch.ops import compaction as tc
from tpu_tree_search_torch.ops.compact_policy import resolve_compact_mode
from tpu_tree_search_torch.problems import NQueensProblem
from tpu_tree_search_torch.problems import PFSPProblem as TorchPFSP

MODES = ("scatter", "sort", "search", "dense")


def _mask(density, M=48, n=10, seed=0):
    rng = np.random.default_rng(seed + int(1000 * density))
    return rng.random((M, n)) < density


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("S", [120, 480])
def test_compact_ids_match_jax(mode, density, S):
    keep = _mask(density)
    ids_j, tree_j = jc.compact_ids(jnp.asarray(keep), S, mode)
    ids_t, tree_t = tc.compact_ids(torch.from_numpy(keep), S, mode)
    assert int(tree_t) == int(tree_j) == int(keep.sum())
    assert ids_t.dtype == torch.int32
    assert np.array_equal(ids_t.numpy(), np.asarray(ids_j))


@pytest.mark.parametrize("density", [0.1, 0.7])
def test_survivor_ranks_match_jax(density):
    keep = _mask(density, M=33, n=7)
    ranks_j, tree_j = jc.survivor_ranks(jnp.asarray(keep))
    ranks_t, tree_t = tc.survivor_ranks(torch.from_numpy(keep))
    assert np.array_equal(ranks_t.numpy(), np.asarray(ranks_j))
    assert int(tree_t) == int(tree_j)


def test_shift_compact_matches_jax_with_payloads():
    keep = _mask(0.4, M=20, n=6).reshape(-1)
    L = keep.size
    ranks = np.cumsum(keep) - keep
    dist = np.where(keep, np.arange(L) - ranks, 0).astype(np.int32)
    rows = np.random.default_rng(3).integers(0, 100, (L, 6)).astype(np.int32)
    aux = np.arange(L, dtype=np.int32)
    got = tc.shift_compact(torch.from_numpy(dist),
                           (torch.from_numpy(rows), torch.from_numpy(aux)))
    want = jc.shift_compact(jnp.asarray(dist), (jnp.asarray(rows), jnp.asarray(aux)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    t = int(keep.sum())
    assert np.array_equal(got[1][:t].numpy(), np.nonzero(keep)[0])


def test_modes_and_policy():
    # The JAX auto policy's gpu row for PFSP, and dense for N-Queens at any M.
    pfsp = TorchPFSP(inst=14, lb="lb1", ub=1)
    nq = NQueensProblem(N=15)
    for prob, M, n in [(pfsp, 1024, 20), (pfsp, 49152, 20), (nq, 1024, 15),
                       (nq, 50000, 15)]:
        assert resolve_compact_mode(prob, M, n) == jc._auto_compact(
            prob, M, n, "gpu")
    assert resolve_compact_mode(pfsp, 1024, 20) == "dense"
    assert resolve_compact_mode(pfsp, 49152, 20) == "scatter"
    assert resolve_compact_mode(nq, 50000, 15) == "dense"
    assert tp.MODES == jc.MODES
    with pytest.raises(ValueError):
        tc.compact_ids(torch.zeros((2, 3), dtype=torch.bool), 6, "bogus")


@pytest.mark.parametrize("knob", [None, "auto", *MODES, "bogus"])
def test_knob_resolves_as_jax(monkeypatch, knob):
    # compact_mode's values and refusal text are the JAX function's; an
    # explicit mode wins over the policy in both packages.
    if knob is None:
        monkeypatch.delenv("TTS_COMPACT", raising=False)
    else:
        monkeypatch.setenv("TTS_COMPACT", knob)
    pfsp = TorchPFSP(inst=14, lb="lb1", ub=1)
    if knob == "bogus":
        with pytest.raises(ValueError) as mine:
            tp.compact_mode()
        with pytest.raises(ValueError) as theirs:
            jc.compact_mode()
        assert str(mine.value) == str(theirs.value)
        return
    assert tp.compact_mode() == jc.compact_mode()
    for M in (1024, 49152):
        got = resolve_compact_mode(pfsp, M, 20)
        if knob in MODES:
            assert got == knob == jc.resolve_compact_mode(pfsp, M, 20)
        else:
            assert got == jc._auto_compact(pfsp, M, 20, "gpu")
    assert tp.auto_chosen(resolve_compact_mode(pfsp, 1024, 20)) == (
        knob in (None, "auto"))
    assert tp.auto_chosen(None) is False


def test_children_are_the_two_position_swap():
    # Child (b, k) of the selects is its parent with positions d[b] and k
    # swapped (the gather/scatter swap), k == d included, in (parent, slot)
    # order.
    rng = np.random.default_rng(7)
    parent = rng.integers(0, 100, (64, 9)).astype(np.int8)
    d = rng.integers(0, 9, (64, 1))
    want = np.repeat(parent, 9, axis=0)
    rows = np.arange(64 * 9)[:, None]
    dd, k = np.repeat(d, 9, axis=0), np.tile(np.arange(9), 64)[:, None]
    want[rows, dd], want[rows, k] = want[rows, k], want[rows, dd]
    got = tc.children_of(torch.from_numpy(parent), torch.from_numpy(d))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


PTM = taillard.reduced_instance(14, jobs=10, machines=5)
SEARCHES = {
    "nqueens8": (lambda: JaxNQueens(8), lambda: NQueensProblem(8)),
    "lb1": (lambda: JaxPFSP(lb="lb1", ub=0, p_times=PTM),
            lambda: TorchPFSP(lb="lb1", ub=0, p_times=PTM)),
    "lb2-staged": (lambda: JaxPFSP(lb="lb2", ub=0, p_times=PTM),
                   lambda: TorchPFSP(lb="lb2", ub=0, p_times=PTM)),
}


@pytest.mark.parametrize("search", sorted(SEARCHES))
@pytest.mark.parametrize("mode", MODES)
def test_unfused_search_under_each_mode_matches_jax(monkeypatch, search,
                                                    mode):
    monkeypatch.setenv("TTS_COMPACT", mode)
    jax_prob, torch_prob = SEARCHES[search]
    want = jax_resident_search(jax_prob(), m=8, M=64, K=16)
    res = resident_search(torch_prob(), m=8, M=64, K=16, device="cpu",
                          fused=False)
    assert (res.explored_tree, res.explored_sol, res.best) == (
        want.explored_tree, want.explored_sol, want.best)
    assert (res.compact, res.compact_auto) == (want.compact,
                                               want.compact_auto) == (mode,
                                                                      False)
    assert res.staged == (search == "lb2-staged")


@pytest.mark.parametrize("flag", [None, "sort"])
def test_cli_compact_flag_and_record_match_jax(monkeypatch, capsys, flag):
    # --compact pins TTS_COMPACT for the run only, and the record's
    # compact/compact_auto are the JAX record's for the same run; the fused
    # cycle takes the flag with no effect and records the mode it resolves
    # to, as the JAX record does under an armed megakernel.
    import json

    from tpu_tree_search import cli as jax_cli
    from tpu_tree_search_torch import cli

    monkeypatch.delenv("TTS_COMPACT", raising=False)
    extra = [] if flag is None else ["--compact", flag]
    run = ["nqueens", "--N", "8", "--M", "64", "--K", "16", "--json", *extra]
    assert jax_cli.main(run + ["--tier", "device"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(run + ["--device", "cpu", "--unfused"]) == 0
    out = capsys.readouterr().out
    mine = json.loads(out.strip().splitlines()[-1])
    for key in ("explored_tree", "explored_sol", "compact", "compact_auto"):
        assert mine.get(key) == theirs.get(key), key
    assert f"Survivor path (TTS_COMPACT): {flag or 'auto'}" in out
    assert f"Survivor path: {mine['compact']}" in out
    assert cli.main(run + ["--device", "cpu"]) == 0
    fused = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert fused["fused"]
    for key in ("compact", "compact_auto"):
        assert fused.get(key) == theirs.get(key), key
    assert "TTS_COMPACT" not in os.environ


@pytest.mark.parametrize("mode", ["sort", "search"])
def test_mesh_dist_mesh_and_batched_honour_an_explicit_mode(monkeypatch, mode):
    # The mesh, dist_mesh and batched programs take the mode from their
    # inner resident program: under an explicit TTS_COMPACT each equals the
    # JAX tier's run under the same knob (counts, shard trees, compact and
    # compact_auto), and a flip of the mode takes a new mesh program on the
    # same problem.
    from tpu_tree_search.engine.batched import batched_search as jax_batched
    from tpu_tree_search.parallel.dist_mesh import dist_mesh_search as jax_dm
    from tpu_tree_search.parallel.resident_mesh import (
        mesh_resident_search as jax_mesh,
    )
    from tpu_tree_search_torch.engine.batched import batched_search
    from tpu_tree_search_torch.parallel.dist_mesh import dist_mesh_search
    from tpu_tree_search_torch.parallel.resident_mesh import (
        mesh_resident_search,
    )

    monkeypatch.setenv("TTS_COMPACT", mode)
    prob = NQueensProblem(8)
    kw = dict(m=8, M=64, K=8)
    runs = {
        "mesh": (jax_mesh(JaxNQueens(8), D=2, **kw),
                 mesh_resident_search(prob, D=2, device="cpu", fused=False,
                                      **kw)),
        "dist_mesh": (jax_dm(JaxNQueens(8), D=1, num_hosts=2, **kw),
                      dist_mesh_search(NQueensProblem(8), D=1, num_hosts=2,
                                       device="cpu", fused=False, **kw)),
        "batched": (jax_batched(JaxNQueens(8), n_jobs=2, B=2, **kw)[0],
                    batched_search(NQueensProblem(8), 2, 2, device="cpu",
                                   fused=False, **kw)[0]),
    }
    for name, (want, res) in runs.items():
        assert (res.explored_tree, res.explored_sol, res.compact,
                res.compact_auto) == (want.explored_tree, want.explored_sol,
                                      want.compact, want.compact_auto), name
        assert (res.compact, res.compact_auto) == (mode, False), name
    assert runs["mesh"][1].per_worker_tree == list(
        runs["mesh"][0].per_worker_tree)
    first = next(iter(prob._mesh_programs.values()))
    monkeypatch.setenv("TTS_COMPACT", "dense")
    res = mesh_resident_search(prob, D=2, device="cpu", fused=False, **kw)
    assert res.compact == jax_mesh(JaxNQueens(8), D=2, **kw).compact == "dense"
    assert len(prob._mesh_programs) == 2 and first.inner.compact == mode
