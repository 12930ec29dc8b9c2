"""The port's lb2 tables and plain lb2 bounds against the JAX package, bit for bit.

The Johnson tables of ``PFSPDeviceTables`` equal the JAX
``johnson_ordered()`` fields. The plain ``lb2_chunk`` (kernel 6's plain
version) is held to the JAX jnp evaluator ``pfsp_device._lb2_chunk`` at pair
block 1 and at the automatic block, to the Pallas kernel
``pallas_kernels.pfsp_lb2_bounds`` in interpret mode (bf16 gathers off and
on), and to the numpy oracle ``bounds.lb2_bound`` per child, on the open
child slots (k > limit1; the others are not children). ``lb2_self_chunk``
(kernel 7's plain version) is held to ``_lb2_self_chunk`` and to
``pfsp_lb2_self_bounds`` in interpret mode on the first ``n_active`` rows,
and ``lb2_bounds_staged`` to the JAX staged evaluator on the candidate
slots. Instances: ta014 (P = 45 pairs) and its 10-job, 5-machine corner
under the three pair variants. Tolerance 0: everything is int32. The kernels
themselves are compared with these plain versions on the card in
`tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tree_search.ops import pallas_kernels, pfsp_device
from tpu_tree_search.problems import PFSPProblem
from tpu_tree_search.problems.pfsp import bounds as jbounds
from tpu_tree_search.problems.pfsp import taillard
from tpu_tree_search_torch.ops import lb2_kernel, lb2_self_kernel
from tpu_tree_search_torch.ops import pfsp_device as tdev
from tpu_tree_search_torch.problems import PFSPProblem as TorchPFSP
from tpu_tree_search_torch.problems.pfsp import bounds as tbounds

CPU = torch.device("cpu")
# ta014's full tables and its reduced corner under each pair variant.
INSTANCES = ["ta014", "10x5-full", "10x5-nabeshima", "10x5-lageweg"]


def _problems(name):
    if name == "ta014":
        return (PFSPProblem(inst=14, lb="lb2", ub=1),
                TorchPFSP(inst=14, lb="lb2", ub=1))
    variant = name.split("-")[1]
    ptm = taillard.reduced_instance(14, jobs=10, machines=5)
    return (PFSPProblem(lb="lb2", ub=0, p_times=ptm, lb2_variant=variant),
            TorchPFSP(lb="lb2", ub=0, p_times=ptm, lb2_variant=variant))


def _nodes(rng, n, B):
    prmu = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    limit1 = rng.integers(-1, n - 1, B).astype(np.int32)
    return prmu, limit1


def _open(limit1, n):
    return np.arange(n)[None, :] >= (limit1[:, None] + 1)


def _jax_tables(jprob):
    return pfsp_device.PFSPDeviceTables(jprob.lb1_data, jprob.lb2_data)


def _torch_tables_from_jax(jt):
    return tdev.tables_from_numpy(
        np.asarray(jt.ptm_t), np.asarray(jt.min_heads), np.asarray(jt.min_tails),
        device="cpu", pairs=np.asarray(jt.pairs), lags=np.asarray(jt.lags),
        johnson_schedules=np.asarray(jt.johnson_schedules))


def _jax_args(jt):
    return (jt.ptm_t, jt.min_heads, jt.min_tails, jt.pairs, jt.lags,
            jt.johnson_schedules)


@pytest.mark.parametrize("name", INSTANCES)
def test_johnson_tables_match_jax_ordered_tables(name):
    jprob, tprob = _problems(name)
    jt = _jax_tables(jprob)
    o = jt.johnson_ordered()
    # Both from the JAX tables' arrays and from the port's own make_lb2.
    for J in (_torch_tables_from_jax(jt).johnson, tprob.device_tables(CPU).johnson):
        for field in ("p0_o", "p1_o", "lag_o", "tails0", "tails1"):
            got = getattr(J, field)
            assert got.dtype == torch.int32 and got.is_contiguous()
            assert np.array_equal(got.numpy(), getattr(o, field)), field
        assert np.array_equal(J.sched.numpy(), np.argmax(o.jorder, -1))
        assert np.array_equal(J.pairs.numpy(), np.asarray(jt.pairs))
        assert J.pair_count == jprob.lb2_data.pairs.shape[0]
        # The kernels' packed copies: (p0, p1, lag, job) and the pair rows.
        assert np.array_equal(J.packed.numpy(), np.stack(
            [o.p0_o, o.p1_o, o.lag_o, np.argmax(o.jorder, -1)], -1))
        assert np.array_equal(J.pairinfo.numpy(), np.stack(
            [np.asarray(jt.pairs)[:, 0], np.asarray(jt.pairs)[:, 1], o.tails0,
             o.tails1], -1))


def test_lb1_tables_carry_no_johnson_part():
    tprob = TorchPFSP(inst=14, lb="lb1", ub=1)
    t = tprob.device_tables(CPU)
    assert t.johnson is None
    prmu, limit1 = _nodes(np.random.default_rng(30), 20, 4)
    with pytest.raises(ValueError, match="lb2"):
        tdev.lb2_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1), t)


@pytest.mark.parametrize("pairblock", ["1", "auto"])
@pytest.mark.parametrize("name", INSTANCES)
def test_plain_lb2_matches_jnp_evaluator(name, pairblock):
    jprob, _ = _problems(name)
    jt = _jax_tables(jprob)
    n = jprob.jobs
    P = jprob.lb2_data.pairs.shape[0]
    pb = 1 if pairblock == "1" else pfsp_device.lb2_pairblock(P, n)
    prmu, limit1 = _nodes(np.random.default_rng(31), n, 200)
    want = np.asarray(pfsp_device._lb2_chunk(
        jnp.asarray(prmu), jnp.asarray(limit1), *_jax_args(jt), pairblock=pb))
    got = tdev.lb2_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                         _torch_tables_from_jax(jt)).numpy()
    assert got.dtype == np.int32
    op = _open(limit1, n)
    assert np.array_equal(got[op], want[op])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", ["ta014", "10x5-full"])
def test_plain_lb2_matches_pallas_kernel_interpret(name, bf16):
    jprob, _ = _problems(name)
    jt = _jax_tables(jprob)
    n = jprob.jobs
    prmu, limit1 = _nodes(np.random.default_rng(32), n, 40)
    want = np.asarray(pallas_kernels.pfsp_lb2_bounds(
        jnp.asarray(prmu), jnp.asarray(limit1), jt, interpret=True, bf16=bf16))
    got = tdev.lb2_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                         _torch_tables_from_jax(jt)).numpy()
    op = _open(limit1, n)
    assert np.array_equal(got[op], want[op])


@pytest.mark.parametrize("name", ["ta014", "10x5-nabeshima"])
def test_plain_lb2_matches_numpy_oracle_per_child(name):
    jprob, tprob = _problems(name)
    n = jprob.jobs
    prmu, limit1 = _nodes(np.random.default_rng(33), n, 12)
    got = tdev.lb2_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                         tprob.device_tables(CPU)).numpy()
    for b in range(prmu.shape[0]):
        l1 = int(limit1[b])
        for k in range(l1 + 1, n):
            child = prmu[b].copy()
            child[l1 + 1], child[k] = child[k], child[l1 + 1]
            # The C early exit never fires below an infinite incumbent.
            assert got[b, k] == jbounds.lb2_bound(
                jprob.lb1_data, jprob.lb2_data, child, l1 + 1, n, 2**62)


@pytest.mark.parametrize("active", ["none", "partial", "all"])
@pytest.mark.parametrize("name", ["ta014", "10x5-lageweg"])
def test_plain_lb2_self_matches_jax(name, active):
    jprob, _ = _problems(name)
    jt = _jax_tables(jprob)
    n = jprob.jobs
    R = 48
    n_active = {"none": 0, "partial": 17, "all": R}[active]
    prmu, limit1 = _nodes(np.random.default_rng(34), n, R)
    got = tdev.lb2_self_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                              n_active, _torch_tables_from_jax(jt)).numpy()
    assert got.shape == (R,) and got.dtype == np.int32
    want = np.asarray(pfsp_device._lb2_self_chunk(
        jnp.asarray(prmu), jnp.asarray(limit1), *_jax_args(jt)))
    kern = np.asarray(pallas_kernels.pfsp_lb2_self_bounds(
        jnp.asarray(prmu), jnp.asarray(limit1), n_active, jt, interpret=True))
    assert np.array_equal(got[:n_active], want[:n_active])
    assert np.array_equal(got[:n_active], kern[:n_active])
    # The plain version bounds every row.
    assert np.array_equal(got, want)


@pytest.mark.parametrize("share", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("name", ["ta014", "10x5-full"])
def test_lb2_bounds_staged_matches_jax_on_candidates(name, share):
    jprob, _ = _problems(name)
    jt = _jax_tables(jprob)
    n = jprob.jobs
    rng = np.random.default_rng(35)
    prmu, limit1 = _nodes(rng, n, 64)
    limit1 = np.minimum(limit1, n - 3)  # candidates are never leaves
    cand = _open(limit1, n) & (rng.random((64, n)) < share)
    t = _torch_tables_from_jax(jt)
    want = np.asarray(pfsp_device.lb2_bounds_staged(
        jnp.asarray(prmu), jnp.asarray(limit1), jnp.asarray(cand), jt))
    for dtype in (torch.int8, torch.int32):
        # Every non-candidate writes the spill row R of the compaction
        # (duplicate indices); no candidate's value depends on that.
        got = tdev.lb2_bounds_staged(torch.from_numpy(prmu).to(dtype),
                                     torch.from_numpy(limit1).to(dtype),
                                     torch.from_numpy(cand), t).numpy()
        assert got.shape == (64, n) and got.dtype == np.int32
        assert np.array_equal(got[cand], want[cand])
        full = tdev.lb2_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1), t)
        assert np.array_equal(got[cand], full.numpy()[cand])


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_lb2_bounds_route_cpu_to_plain_in_pool_dtype(dtype):
    _, tprob = _problems("ta014")
    t = tprob.device_tables(CPU)
    prmu, limit1 = _nodes(np.random.default_rng(36), 20, 32)
    p, l1 = torch.from_numpy(prmu), torch.from_numpy(limit1)
    ref = tdev.lb2_chunk(p, l1, t)
    assert torch.equal(tdev.lb2_bounds(p.to(dtype), l1.to(dtype), t), ref)
    self_ref = tdev.lb2_self_chunk(p, l1, 32, t)
    got = tdev.lb2_self_bounds(p.to(dtype), l1.to(dtype),
                               torch.tensor(32, dtype=torch.int32), t)
    assert torch.equal(got, self_ref)
    assert lb2_kernel.plain is tdev.lb2_chunk
    assert lb2_self_kernel.plain is tdev.lb2_self_chunk


def test_lb2_kernel_wrappers_refuse_cpu_tensors():
    _, tprob = _problems("ta014")
    t = tprob.device_tables(CPU)
    prmu = torch.zeros((4, 20), dtype=torch.int8)
    lim = torch.zeros(4, dtype=torch.int8)
    with pytest.raises(ValueError):
        lb2_kernel.lb2_bounds_cuda(prmu, lim, t)
    with pytest.raises(ValueError):
        lb2_self_kernel.lb2_self_bounds_cuda(prmu, lim, 4, t)


def _tables_of(ptm):
    d1 = tbounds.make_lb1(ptm)
    d2 = tbounds.make_lb2(d1)
    return tdev.tables_from_numpy(
        np.ascontiguousarray(d1.p_times.T), d1.min_heads, d1.min_tails, "cpu",
        pairs=d2.pairs, lags=d2.lags, johnson_schedules=d2.johnson_schedules)


@pytest.mark.parametrize("why", ["jobs", "int16"])
def test_lb2_kernels_refuse_shapes_they_do_not_take(why):
    rng = np.random.default_rng(37)
    if why == "jobs":  # n = 101 > MAX_JOBS
        ptm = rng.integers(1, 100, (3, lb2_kernel.MAX_JOBS + 1))
    else:  # a lag past int16
        ptm = rng.integers(1, 100, (4, 10))
        ptm[1:3] = 20000
    t = _tables_of(ptm)
    for source in ("lb2_bounds", "lb2_self_bounds", "cycle_lb2"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lb2_kernel.johnson_operands(source, t)


@pytest.mark.parametrize("lb", ["lb1", "lb2"])
def test_device_tables_build_johnson_only_for_lb2(lb):
    tprob = TorchPFSP(inst=14, lb=lb, ub=1)
    t = tprob.device_tables(CPU)
    assert (t.johnson is None) == (lb != "lb2")
    assert tprob.device_tables(CPU) is t  # cached per device
