"""The port's survivor compaction against `tpu_tree_search/ops/compaction.py`.

``compact_ids`` in the ``scatter`` and ``dense`` modes, ``survivor_ranks``
and ``shift_compact`` must return exactly what the JAX functions return —
the full id vectors (survivor prefix and garbage tail alike) and the
survivor count. Masks are made with numpy from a seed at several survivor
densities, with a survivor budget S below and at M*n.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.ops import compaction as jc
from tpu_tree_search_torch.ops import compaction as tc
from tpu_tree_search_torch.ops.compact_policy import resolve_compact_mode
from tpu_tree_search_torch.problems import NQueensProblem
from tpu_tree_search_torch.problems import PFSPProblem as TorchPFSP


def _mask(density, M=48, n=10, seed=0):
    rng = np.random.default_rng(seed + int(1000 * density))
    return rng.random((M, n)) < density


@pytest.mark.parametrize("mode", ["scatter", "dense"])
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
    with pytest.raises(ValueError):
        tc.compact_ids(torch.zeros((2, 3), dtype=torch.bool), 6, "sort")
