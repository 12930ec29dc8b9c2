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
under the three pair variants. A numpy model of the per-parent pair pass
that kernels 6 and 8 run (`csrc/lb2_common.cuh`) is held to ``lb2_chunk``
and to the JAX evaluator on ta014, ta021, a random 7x5 instance and a pair
subset, from the root, at the leaves and at mixed depths. Tolerance 0:
everything is int32. The kernels themselves are compared with these plain
versions on the card in `tests/test_torch_cuda.py`.
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


# -- the per-parent pair pass of kernels 6 and 8 (csrc/lb2_common.cuh) ---------


def _per_parent_pass(prmu, limit1, tables):
    """A numpy model of the per-parent Johnson pass of kernels 6 and 8
    (`lb2p_bounds` in csrc/lb2_common.cuh), in the kernels' order. Per
    parent: its front and its free work S by machine. Per (parent, pair q):
    a forward walk over the free jobs in q's Johnson order with the
    inclusive prefix sum of p0, the exclusive one of p1 and the prefix
    maximum of u = cum0 + lag - cum1 (w = u + S1), then a backward walk with
    the suffix sums and the suffix maximum of v = lag + suf1 - suf0
    (w = v + S0); each walk takes its term of job i left out, less the
    child's front, into A[job][ma0] with a max. Per open child: its front c
    (one add_forward step) and its bound, max(0, c[j] + A[job][j], and
    c[j] + S[j] - p[j] + tails[j] for each machine j of a pair). Returns
    (B, n) int64 with the closed slots at 0."""
    J = tables.johnson
    h = J.host
    ptm_t = tables.ptm_t.numpy().astype(np.int64)
    heads = tables.min_heads.numpy().astype(np.int64)
    B, n = prmu.shape
    m = ptm_t.shape[1]
    neg = int(tdev.NEG)
    # The tails of the machines some pair names, NEG for the others.
    t14 = np.full(m, neg, dtype=np.int64)
    for q in range(J.pair_count):
        t14[h["pairs"][q][0]] = h["tails0"][q]
        t14[h["pairs"][q][1]] = h["tails1"][q]
    out = np.zeros((B, n), dtype=np.int64)
    for b in range(B):
        row, l1 = prmu[b], int(limit1[b])
        free = np.zeros(n, dtype=bool)
        free[row[l1 + 1:]] = True
        front = heads.copy() if l1 == -1 else np.zeros(m, dtype=np.int64)
        for i in range(l1 + 1):
            p = ptm_t[row[i]]
            c = front[0] + p[0]
            front[0] = c
            for j in range(1, m):
                c = max(c, front[j]) + p[j]
                front[j] = c
        S = ptm_t[row[l1 + 1:]].sum(0)
        A = np.full((n, m), neg, dtype=np.int64)
        for q in range(J.pair_count):
            ma0, ma1 = (int(v) for v in h["pairs"][q])
            t1 = int(h["tails1"][q])
            S0, S1 = int(S[ma0]), int(S[ma1])
            order = [t for t in range(n) if free[h["sched"][q, t]]]
            c0 = c1 = 0
            premax = neg
            for t in order:
                p0, p1, lag, job = (int(h[f][q, t]) for f in ("p0_o", "p1_o", "lag_o",
                                                              "sched"))
                c0 += p0
                if premax != neg:
                    A[job, ma0] = max(A[job, ma0], premax + S1 - p1 + t1)
                premax = max(premax, c0 + lag - c1)
                c1 += p1
            s0 = s1 = 0
            sufmax = neg
            for t in reversed(order):
                p0, p1, lag, job = (int(h[f][q, t]) for f in ("p0_o", "p1_o", "lag_o",
                                                              "sched"))
                s1 += p1
                if sufmax != neg:
                    A[job, ma0] = max(A[job, ma0], sufmax + S0 - p0 + t1)
                sufmax = max(sufmax, lag + s1 - s0)
                s0 += p0
        for k in range(l1 + 1, n):
            job = row[k]
            p = ptm_t[job]
            lb = c = 0
            for j in range(m):
                c = (front[0] if j == 0 else max(c, front[j])) + p[j]
                lb = max(lb, c + int(A[job, j]), c + int(S[j]) - p[j] + int(t14[j]))
            out[b, k] = lb
    return out


def _pass_case(name):
    """(JAX problem, the port's CPU tables) of an instance of the pair-pass
    test: ta014 (20 jobs, 10 machines, P = 45), ta021 (20 jobs, 20
    machines, P = 190), a seeded random 7-job, 5-machine instance, or
    ta014's 10-job, 5-machine corner under the Nabeshima subset (the P = 4
    pairs of adjacent machines)."""
    if name == "10x5-nabeshima":
        jprob, tprob = _problems(name)
        return jprob, tprob.device_tables(CPU)
    if name == "7x5-random":
        ptm = np.random.default_rng(38).integers(1, 100, (5, 7))
        return PFSPProblem(lb="lb2", ub=0, p_times=ptm), _tables_of(ptm)
    inst = int(name[2:])
    return (PFSPProblem(inst=inst, lb="lb2", ub=1),
            TorchPFSP(inst=inst, lb="lb2", ub=1).device_tables(CPU))


@pytest.mark.parametrize("depth", ["root", "leaf", "mixed"])
@pytest.mark.parametrize("name", ["ta014", "ta021", "7x5-random", "10x5-nabeshima"])
def test_per_parent_pair_pass_matches_plain_and_jax(name, depth):
    # The identity kernels 6 and 8 rest on: the lb2 of every open child
    # from one forward and one backward pass per (parent, pair), held bit
    # for bit against the plain per-child closed form and the JAX evaluator
    # on the open slots. "root": limit1 = -1 (r = n free jobs); "leaf":
    # limit1 = n - 2 (one child, with no free job left: its lb2 is the
    # front's); "mixed": every depth from -1 to n - 2.
    jprob, t = _pass_case(name)
    n = jprob.jobs
    rng = np.random.default_rng(39)
    B = 24
    prmu = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    limit1 = {"root": np.full(B, -1), "leaf": np.full(B, n - 2),
              "mixed": np.arange(B) % n - 1}[depth].astype(np.int32)
    got = _per_parent_pass(prmu, limit1, t)
    plain = tdev.lb2_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                           t).numpy()
    jt = _jax_tables(jprob)
    want = np.asarray(pfsp_device._lb2_chunk(
        jnp.asarray(prmu), jnp.asarray(limit1), *_jax_args(jt)))
    op = _open(limit1, n)
    assert op.sum() == np.sum(n - 1 - limit1)
    assert np.array_equal(got[op], plain[op].astype(np.int64))
    assert np.array_equal(got[op], want[op].astype(np.int64))
