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


@pytest.mark.parametrize("why", ["jobs", "int16", "past"])
def test_lb2_kernels_refuse_shapes_they_do_not_take(why):
    # 101 jobs (once refused) take the shared-memory route, a lag
    # past int16 the global one; past MAX_JOBS jobs is still refused.
    rng = np.random.default_rng(37)
    if why == "jobs":  # n = 101
        ptm = rng.integers(1, 100, (3, 101))
    elif why == "int16":  # a lag past int16
        ptm = rng.integers(1, 100, (4, 10))
        ptm[1:3] = 20000
    else:
        ptm = rng.integers(1, 100, (2, lb2_kernel.MAX_JOBS + 1))
    t = _tables_of(ptm)
    for source in ("lb2_bounds", "lb2_self_bounds", "cycle_lb2", "tiled_lb2"):
        if why == "past":
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                lb2_kernel.johnson_operands(source, t)
            continue
        J = lb2_kernel.johnson_operands(source, t)
        assert J.tables == {"jobs": "smem", "int16": "global"}[why]
        want = t.johnson.packed if J.route == 0 else t.johnson.packed32
        assert J.tab is want and J.pair_count == t.johnson.pair_count


@pytest.mark.parametrize("lb", ["lb1", "lb2"])
def test_device_tables_build_johnson_only_for_lb2(lb):
    tprob = TorchPFSP(inst=14, lb=lb, ub=1)
    t = tprob.device_tables(CPU)
    assert (t.johnson is None) == (lb != "lb2")
    assert tprob.device_tables(CPU) is t  # cached per device


# -- the per-parent pair pass of kernels 6 and 8 (csrc/lb2_common.cuh) ---------


def _per_parent_pass(prmu, limit1, tables, glob=False):
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
    (B, n) int64 with the closed slots at 0. ``glob``: the global table
    route's reads: the (p0, p1, lag, job) entries from the int32 table
    ``packed32``, and each pair's free slots as W mask words from the
    16-bit inverse ``inv`` (bit inv[q, job] of each free job), walked
    lowest bit first forward and highest first backward."""
    J = tables.johnson
    h = dict(J.host)
    if glob:
        p32 = J.packed32.numpy()
        h.update(p0_o=p32[..., 0], p1_o=p32[..., 1], lag_o=p32[..., 2],
                 sched=p32[..., 3])
        inv = J.inv.numpy().astype(np.int64)
        W = -(-prmu.shape[1] // 32)
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
            if glob:
                words = [0] * W
                for job in row[l1 + 1:]:
                    t = int(inv[q, job])
                    words[t >> 5] |= 1 << (t & 31)
                order = [32 * w + b for w in range(W) for b in range(32)
                         if (words[w] >> b) & 1]
            else:
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


# -- kernel 7's design (csrc/lb2_self_bounds.cu) --------------------------------

# Written by no launch: the rows at or past n_active keep it.
_UNWRITTEN = -7


def _self_kernel_model(prmu, limit1, n_active, tables, blocks, threads,
                       rows=1, G=None, RT=None, glob=False):
    """A numpy model of kernel 7 in the kernel's order, on a grid of
    ``blocks`` blocks of ``threads`` threads taking up to ``rows`` rows a
    thread. G lanes a row and RT rows a thread (``split``'s rule from
    n_active unless given); block b takes U = threads / G * RT rows a pass,
    from b * U, blocks * U apart, and returns at once when b * U is past
    n_active. Per row: job ids outside [0, n) read as 0, limit1 clamped to
    [-1, n - 1]; the front as a wavefront over the machines when m <= G
    (lane j takes position step - j from its left neighbour's value of the
    step before), else one lane's (l1 + 1) * m steps; the free-job mask, W
    words that each lane builds from its positions l1+1+lane,
    l1+1+lane+G, ... and the group or-s with a butterfly; lane l takes the
    pairs q = l, l + G, ... and walks each pair's n ordered slots, a slot
    counted where its job's mask bit is set. The lanes' maxima (from 0)
    reduce with a max butterfly and lane 0 writes. Returns (R,) int64,
    ``_UNWRITTEN`` where no lane wrote. ``glob``: the global table route,
    its entries read from the int32 table ``packed32``."""
    J = tables.johnson
    h = dict(J.host)
    if glob:
        p32 = J.packed32.numpy()
        h.update(p0_o=p32[..., 0], p1_o=p32[..., 1], lag_o=p32[..., 2],
                 sched=p32[..., 3])
    ptm_t = tables.ptm_t.numpy().astype(np.int64)
    heads = tables.min_heads.numpy().astype(np.int64)
    R, n = prmu.shape
    m, P = ptm_t.shape[1], J.pair_count
    W = (n + 31) // 32
    nact = min(n_active, R)
    if G is None:
        G, RT = lb2_self_kernel.split(nact, blocks, threads, rows, P, m)
    U = threads // G * RT
    sched = h["sched"].astype(np.int64)
    p0, p1, lag = (h[f].astype(np.int64) for f in ("p0_o", "p1_o", "lag_o"))
    ma0, ma1 = h["pairs"][:, 0], h["pairs"][:, 1]
    out = np.full(R, _UNWRITTEN, dtype=np.int64)
    for b in range(blocks):
        if b * U >= nact:
            continue
        for r0 in range(b * U, nact, blocks * U):
            for p in range(min(U, nact - r0)):
                row = prmu[r0 + p].astype(np.int64)
                row = np.where((row >= 0) & (row < n), row, 0)
                l1 = min(max(int(limit1[r0 + p]), -1), n - 1)
                if m <= G:
                    f = [int(heads[j]) if l1 == -1 and j < m else 0 for j in range(G)]
                    for step in range(l1 + m):
                        left = [f[j - 1] if j else f[0] for j in range(G)]
                        for j in range(m):
                            i = step - j
                            if 0 <= i <= l1:
                                c = ptm_t[row[i], j]
                                f[j] = (f[j] if j == 0 else max(f[j], left[j])) + c
                    f = np.array(f[:m], dtype=np.int64)
                else:
                    f = heads.copy() if l1 == -1 else np.zeros(m, dtype=np.int64)
                    for i in range(l1 + 1):
                        c = 0
                        for j in range(m):
                            c = (f[0] if j == 0 else max(c, f[j])) + ptm_t[row[i], j]
                            f[j] = c
                tmp0, tmp1 = f[ma0].copy(), f[ma1].copy()
                fm = [[0] * W for _ in range(G)]
                for lane in range(G):
                    for k in range(l1 + 1 + lane, n, G):
                        fm[lane][row[k] >> 5] |= 1 << (row[k] & 31)
                o = G >> 1
                while o:
                    fm = [[fm[x][w] | fm[x ^ o][w] for w in range(W)]
                          for x in range(G)]
                    o >>= 1
                words = np.array(fm[0], dtype=np.int64)
                for t in range(n):  # every lane's pairs at once
                    job = sched[:, t]
                    free = ((words[job >> 5] >> (job & 31)) & 1) == 1
                    new0 = tmp0 + p0[:, t]
                    new1 = np.maximum(tmp1, new0 + lag[:, t]) + p1[:, t]
                    tmp0 = np.where(free, new0, tmp0)
                    tmp1 = np.where(free, new1, tmp1)
                pair_lb = np.maximum(tmp1 + h["tails1"], tmp0 + h["tails0"])
                lane_lb = [max([0] + [int(pair_lb[q]) for q in range(lane, P, G)])
                           for lane in range(G)]
                o = G >> 1
                while o:
                    lane_lb = [max(lane_lb[x], lane_lb[x ^ o]) for x in range(G)]
                    o >>= 1
                assert out[r0 + p] == _UNWRITTEN  # each row once
                out[r0 + p] = lane_lb[0]
    return out


def _self_rows(name, depth):
    """(JAX problem, the port's tables, prmu, limit1) of a kernel-7 model
    case: a few dozen rows (a dozen at 50 and 100 jobs, where the Pallas
    kernel's interpret mode is slow), limit1 -1 ("root"), n - 2 ("deep") or
    every depth from -1 to n - 2 ("mixed")."""
    inst = int(name[2:])
    jprob = PFSPProblem(inst=inst, lb="lb2", ub=1)
    t = TorchPFSP(inst=inst, lb="lb2", ub=1).device_tables(CPU)
    n = t.jobs
    R = 40 if n <= 20 else 12
    rng = np.random.default_rng(inst)
    prmu = np.stack([rng.permutation(n) for _ in range(R)]).astype(np.int32)
    limit1 = {"root": np.full(R, -1), "deep": np.full(R, n - 2),
              "mixed": rng.permutation(np.arange(R) % n) - 1}[depth]
    return jprob, t, prmu, limit1.astype(np.int32)


@pytest.mark.parametrize("depth", ["root", "mixed", "deep"])
@pytest.mark.parametrize("name", ["ta014", "ta021", "ta051", "ta081"])
def test_self_kernel_design_matches_plain_and_jax(name, depth):
    # Kernel 7's design, modelled in numpy in the kernel's order, against
    # the plain lb2_self_chunk, the JAX _lb2_self_chunk and the Pallas
    # kernel in interpret mode: G in {1, 4, 16, 32} lanes a row (one thread
    # a row, lanes under the machines, the wavefront), 1, 2 and 4 rows a
    # thread at one lane, n_active in {0, 1, 33, all, past R}, and the work
    # split of a grid whose G and rows a thread follow from n_active.
    # Tolerance 0 (int32).
    jprob, t, prmu, limit1 = _self_rows(name, depth)
    R, n = prmu.shape
    jt = _jax_tables(jprob)
    plain = tdev.lb2_self_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                                R, t).numpy().astype(np.int64)
    want = np.asarray(pfsp_device._lb2_self_chunk(
        jnp.asarray(prmu), jnp.asarray(limit1), *_jax_args(jt)))
    kern = np.asarray(pallas_kernels.pfsp_lb2_self_bounds(
        jnp.asarray(prmu), jnp.asarray(limit1), R, jt, interpret=True))
    assert np.array_equal(plain, want)
    # The Pallas kernel (interpret mode) misses the root rows of ta081 (100
    # jobs, 20 machines: 5884 where the numpy oracle, the jnp evaluator and
    # the port give 5926; ROADMAP.md C). Those rows are held to the oracle.
    pallas_off = (limit1 == -1) & (name == "ta081")
    assert np.array_equal(plain[~pallas_off], kern[~pallas_off])
    for b in np.flatnonzero(pallas_off):
        assert plain[b] == jbounds.lb2_bound(jprob.lb1_data, jprob.lb2_data, prmu[b],
                                             int(limit1[b]), n, 2**62)
    for G, RT in ((1, 1), (1, 2), (1, 3), (1, 4), (4, 1), (16, 1), (32, 1)):
        got = _self_kernel_model(prmu, limit1, R, t, 3, 32, G=G, RT=RT)
        assert np.array_equal(got, plain), (G, RT)
    m, P = t.machines, t.johnson.pair_count
    for nact in (0, 1, 33, R, R + 5):
        for blocks in (1, 2, 9):
            got = _self_kernel_model(prmu, limit1, nact, t, blocks, 32, rows=4)
            k = min(nact, R)
            assert np.array_equal(got[:k], plain[:k]), (nact, blocks)
            assert (got[k:] == _UNWRITTEN).all()
    # The split: 32 lanes a row while the rows leave lanes idle, halved as
    # the rows grow (never more than the pairs or machines need), then more
    # rows a thread.
    split = lb2_self_kernel.split
    assert split(185, 1056, 128, 4, P, m) == (32, 1)
    assert split(12, 1, 32, 4, P, m) == (2, 1) and split(40, 1, 32, 4, P, m) == (1, 2)
    assert split(100, 1, 32, 4, P, m) == (1, 4) and split(70, 1, 32, 4, P, m) == (1, 3)
    assert split(100, 1, 32, 2, P, m) == (1, 2)


def test_self_kernel_model_takes_rows_that_are_no_permutation():
    # Job ids outside [0, n) read as job 0 and limit1 outside [-1, n - 1]
    # clamped: the model (as the kernel) indexes no table past its end. The
    # valid rows beside such rows keep the plain version's bounds.
    _, t, prmu, limit1 = _self_rows("ta014", "mixed")
    wild = prmu.copy()
    wild[::3, 2] = 77
    wild[1::3, 5] = -4
    lim = limit1.copy()
    lim[::5] = 40
    lim[2::5] = -3
    got = _self_kernel_model(wild, lim, len(wild), t, 2, 64, rows=2)
    plain = tdev.lb2_self_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                                len(prmu), t).numpy()
    ok = np.ones(len(prmu), dtype=bool)
    ok[::3] = ok[1::3] = ok[::5] = ok[2::5] = False
    assert ok.any() and np.array_equal(got[ok], plain[ok])
    assert (got != _UNWRITTEN).all()


def test_self_kernel_block_fits_wherever_the_per_row_kernel_did():
    # Kernel 7's block (threads halved down to one warp) fits the shared
    # memory a block may ask for at ta081 (100 jobs, 20 machines, P = 190),
    # and wherever the per-row design before it fitted: its block held the
    # tables, 128 fronts and 128 job-position columns.
    t = TorchPFSP(inst=81, lb="lb2", ub=1).device_tables(CPU)
    n, m, P = t.jobs, t.machines, t.johnson.pair_count
    sh = lb2_self_kernel.block_shape(n, m, P)
    assert sh["smem_bytes"] <= lb2_kernel.SMEM_LIMIT
    assert (sh["ns"], sh["threads"], sh["rows"]) == (101, lb2_self_kernel.THREADS, 2)
    assert lb2_self_kernel.ROWS == 4

    def per_row(n, m, P):
        return 16 * P + 8 * P * n + 4 * (n * m + m + 128 * m) + 128 * n

    for n in (2, 5, 10, 20, 50, 64, 99, 100):
        for m in range(2, 200):
            for P in {m * (m - 1) // 2, m - 1}:
                if per_row(n, m, P) <= lb2_kernel.SMEM_LIMIT:
                    sh = lb2_self_kernel.block_shape(n, m, P)
                    assert sh["smem_bytes"] <= lb2_kernel.SMEM_LIMIT, (n, m, P)


# -- past 100 jobs: ta101 and ta111 (200 and 500 jobs, 20 machines) --------------


def _wide_case(inst):
    """(JAX problem, the port's CPU tables, prmu, limit1) of an instance past
    100 jobs: a few int32 rows (the resident pool's type past 127 jobs),
    limit1 mixed from the root to the last open slot."""
    jprob = PFSPProblem(inst=inst, lb="lb2", ub=1)
    t = TorchPFSP(inst=inst, lb="lb2", ub=1).device_tables(CPU)
    n = t.jobs
    rng = np.random.default_rng(inst)
    prmu = np.stack([rng.permutation(n) for _ in range(4)]).astype(np.int32)
    limit1 = np.array([-1, n // 3, n - 3, n - 2], dtype=np.int32)
    return jprob, t, prmu, limit1


@pytest.mark.parametrize("inst", [101, 111])
def test_plain_lb2_past_100_jobs_matches_jax_oracle_and_global_walk(inst):
    # The plain lb2_chunk (kernels 6, 8 and 9c's plain version) on ta101 and
    # ta111 equals the JAX jnp evaluator on the open slots, the numpy
    # oracle on sampled children, and a numpy model of the global-route
    # pair pass (the int32 table and the W-word inverse masks, in the
    # kernels' order). Both instances take the global route.
    jprob, t, prmu, limit1 = _wide_case(inst)
    n = t.jobs
    for source in ("lb2_bounds", "cycle_lb2", "tiled_lb2", "lb2_self_bounds"):
        assert lb2_kernel.johnson_operands(source, t).tables == "global"
    jt = _jax_tables(jprob)
    plain = tdev.lb2_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                           t).numpy()
    want = np.asarray(pfsp_device._lb2_chunk(
        jnp.asarray(prmu), jnp.asarray(limit1), *_jax_args(jt), pairblock=1))
    op = _open(limit1, n)
    assert np.array_equal(plain[op], want[op])
    model = _per_parent_pass(prmu[1:], limit1[1:], t, glob=True)
    assert np.array_equal(model[op[1:]], plain[1:][op[1:]].astype(np.int64))
    rng = np.random.default_rng(inst + 1)
    for b in range(len(prmu)):
        l1 = int(limit1[b])
        for k in rng.choice(np.arange(l1 + 1, n), min(3, n - 1 - l1),
                            replace=False):
            child = prmu[b].copy()
            child[l1 + 1], child[k] = child[k], child[l1 + 1]
            assert plain[b, k] == jbounds.lb2_bound(
                jprob.lb1_data, jprob.lb2_data, child, l1 + 1, n, 2**62)


@pytest.mark.parametrize("inst", [101, 111])
def test_plain_lb2_self_past_100_jobs_matches_jax_oracle_and_model(inst):
    # lb2_self_chunk (kernel 7's plain version) on ta101 and ta111 rows
    # equals the JAX jnp evaluator, the numpy oracle and kernel 7's model on
    # the global route (one row a thread, the int32 table).
    jprob, t, prmu, limit1 = _wide_case(inst)
    n = t.jobs
    jt = _jax_tables(jprob)
    plain = tdev.lb2_self_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                                len(prmu), t).numpy().astype(np.int64)
    want = np.asarray(pfsp_device._lb2_self_chunk(
        jnp.asarray(prmu), jnp.asarray(limit1), *_jax_args(jt)))
    assert np.array_equal(plain, want)
    for b in range(len(prmu)):
        assert plain[b] == jbounds.lb2_bound(jprob.lb1_data, jprob.lb2_data,
                                             prmu[b], int(limit1[b]), n, 2**62)
    for G in (1, 32):
        got = _self_kernel_model(prmu, limit1, len(prmu), t, 2, 32, G=G, RT=1,
                                 glob=True)
        assert np.array_equal(got, plain), G
    sh = lb2_self_kernel.block_shape(n, t.machines, t.johnson.pair_count, True)
    assert sh["rows"] == 1 and sh["ns"] == n
    assert sh["smem_bytes"] <= lb2_kernel.SMEM_LIMIT


def test_lb2_routes_of_every_taillard_instance():
    # johnson_operands takes every Taillard instance under all pairs
    # (ta001-ta100 and the 10-machine ta091-ta100 on the shared-memory
    # route, ta101-ta120 on the global one) and the (100, 22, 231) shape
    # whose tables pass shared memory (global). `route` owns the rule: the
    # C entries take its route and check only their block's shared memory
    # (tests/test_torch_cuda.py holds each launch's `tables` to it).
    from tpu_tree_search_torch.problems.pfsp import taillard as tt

    for inst in range(1, 121):
        n, m = tt.nb_jobs(inst), tt.nb_machines(inst)
        P = m * (m - 1) // 2
        want = 0 if inst <= 100 else 1
        assert lb2_kernel.route("lb2_bounds", n, m, P, True) == want, inst
        assert lb2_kernel.route("lb2_self_bounds", n, m, P, True) == want, inst
    assert lb2_kernel.route("lb2_bounds", 100, 22, 231, True) == 1
    assert lb2_kernel.route("lb2_self_bounds", 100, 22, 231, True) == 0
    assert lb2_kernel.route("lb2_bounds", 20, 5, 10, False) == 1
    assert lb2_kernel.route("lb2_bounds", 1025, 5, 10, True) == -1
    ptm = np.random.default_rng(22).integers(1, 100, (22, 100))
    J = lb2_kernel.johnson_operands("tiled_lb2", _tables_of(ptm))
    assert J.tables == "global"
