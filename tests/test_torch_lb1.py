"""The port's lb1 and lb1_d bounds against the JAX package, bit for bit.

The plain PyTorch ``lb1_chunk`` (the CUDA kernel's plain version) is held to
the JAX jnp evaluator ``pfsp_device._lb1_chunk``, to the Pallas kernel
``pallas_kernels.pfsp_lb1_bounds`` in interpret mode, and to the numpy
oracle ``bounds.lb1_bound`` per child, on the open child slots (k > limit1;
the other slots are not children). ``lb1_d_chunk`` is held the same way to
``_lb1_d_chunk`` and ``pfsp_lb1_d_bounds``. Tolerance 0: everything is
int32. Inputs are made with numpy from a seed and handed to both packages.
The kernels themselves are compared with their plain versions on the card in
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
from tpu_tree_search_torch.ops import lb1_d_kernel, lb1_kernel
from tpu_tree_search_torch.ops import pfsp_device as tdev
from tpu_tree_search_torch.problems import PFSPProblem as TorchPFSP

# ta014's full tables (n=20, m=10) and its reduced 10-job, 5-machine corner.
INSTANCES = ["ta014", "ta014_10x5"]


def _problems(name):
    if name == "ta014":
        return PFSPProblem(inst=14, lb="lb1", ub=1), TorchPFSP(inst=14, lb="lb1", ub=1)
    ptm = taillard.reduced_instance(14, jobs=10, machines=5)
    return (PFSPProblem(lb="lb1", ub=0, p_times=ptm),
            TorchPFSP(lb="lb1", ub=0, p_times=ptm))


def _nodes(rng, n, B):
    prmu = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    limit1 = rng.integers(-1, n - 1, B).astype(np.int32)
    return prmu, limit1


def _open(limit1, n):
    return np.arange(n)[None, :] >= (limit1[:, None] + 1)


def _jax_tables(jprob):
    return pfsp_device.PFSPDeviceTables(jprob.lb1_data, jprob.lb2_data)


def _torch_tables_from_jax(jt):
    return tdev.tables_from_numpy(np.asarray(jt.ptm_t), np.asarray(jt.min_heads),
                                  np.asarray(jt.min_tails), device="cpu")


@pytest.mark.parametrize("name", INSTANCES)
def test_plain_lb1_matches_jnp_evaluator(name):
    jprob, _ = _problems(name)
    jt = _jax_tables(jprob)
    n = jprob.jobs
    rng = np.random.default_rng(11)
    prmu, limit1 = _nodes(rng, n, 300)
    want = np.asarray(pfsp_device._lb1_chunk(
        jnp.asarray(prmu), jnp.asarray(limit1), jt.ptm_t, jt.min_heads,
        jt.min_tails))
    got = tdev.lb1_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                         _torch_tables_from_jax(jt)).numpy()
    assert got.dtype == np.int32
    op = _open(limit1, n)
    assert np.array_equal(got[op], want[op])


@pytest.mark.parametrize("name", INSTANCES)
def test_plain_lb1_matches_pallas_kernel_interpret(name):
    jprob, _ = _problems(name)
    jt = _jax_tables(jprob)
    n = jprob.jobs
    rng = np.random.default_rng(12)
    prmu, limit1 = _nodes(rng, n, 96)
    want = np.asarray(pallas_kernels.pfsp_lb1_bounds(
        jnp.asarray(prmu), jnp.asarray(limit1), jt.ptm_t, jt.min_heads,
        jt.min_tails, interpret=True))
    got = tdev.lb1_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                         _torch_tables_from_jax(jt)).numpy()
    op = _open(limit1, n)
    assert np.array_equal(got[op], want[op])


@pytest.mark.parametrize("name", INSTANCES)
def test_plain_lb1_matches_numpy_oracle_per_child(name):
    jprob, tprob = _problems(name)
    n = jprob.jobs
    rng = np.random.default_rng(13)
    prmu, limit1 = _nodes(rng, n, 40)
    got = tdev.lb1_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                         tprob.device_tables(torch.device("cpu"))).numpy()
    for b in range(prmu.shape[0]):
        l1 = int(limit1[b])
        for k in range(l1 + 1, n):
            child = prmu[b].copy()
            child[l1 + 1], child[k] = child[k], child[l1 + 1]
            assert got[b, k] == jbounds.lb1_bound(jprob.lb1_data, child, l1 + 1, n)


def test_tables_match_jax_tables():
    jprob, tprob = _problems("ta014")
    jt = _jax_tables(jprob)
    tt = tprob.device_tables(torch.device("cpu"))
    assert np.array_equal(tt.ptm_t.numpy(), np.asarray(jt.ptm_t))
    assert np.array_equal(tt.min_heads.numpy(), np.asarray(jt.min_heads))
    assert np.array_equal(tt.min_tails.numpy(), np.asarray(jt.min_tails))
    assert tt.ptm_t.dtype == torch.int32 and tt.ptm_t.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_lb1_bounds_routes_cpu_to_plain_in_pool_dtype(dtype):
    _, tprob = _problems("ta014")
    t = tprob.device_tables(torch.device("cpu"))
    rng = np.random.default_rng(14)
    prmu, limit1 = _nodes(rng, 20, 64)
    ref = tdev.lb1_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1), t)
    got = tdev.lb1_bounds(torch.from_numpy(prmu).to(dtype),
                          torch.from_numpy(limit1).to(dtype), t)
    assert torch.equal(got, ref)
    assert lb1_kernel.plain is tdev.lb1_chunk


def test_kernel_wrapper_refuses_cpu_tensors():
    _, tprob = _problems("ta014")
    t = tprob.device_tables(torch.device("cpu"))
    prmu = torch.zeros((4, 20), dtype=torch.int8)
    with pytest.raises(ValueError):
        lb1_kernel.lb1_bounds_cuda(prmu, torch.zeros(4, dtype=torch.int8), t)
    with pytest.raises(ValueError):
        lb1_d_kernel.lb1_d_bounds_cuda(prmu, torch.zeros(4, dtype=torch.int8), t)


# -- lb1_d -------------------------------------------------------------------


@pytest.mark.parametrize("name", INSTANCES)
def test_plain_lb1_d_matches_jnp_evaluator(name):
    jprob, _ = _problems(name)
    jt = _jax_tables(jprob)
    n = jprob.jobs
    prmu, limit1 = _nodes(np.random.default_rng(21), n, 300)
    want = np.asarray(pfsp_device._lb1_d_chunk(
        jnp.asarray(prmu), jnp.asarray(limit1), jt.ptm_t, jt.min_heads,
        jt.min_tails))
    got = tdev.lb1_d_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                           _torch_tables_from_jax(jt)).numpy()
    assert got.dtype == np.int32
    op = _open(limit1, n)
    assert np.array_equal(got[op], want[op])


@pytest.mark.parametrize("name", INSTANCES)
def test_plain_lb1_d_matches_pallas_kernel_interpret(name):
    jprob, _ = _problems(name)
    jt = _jax_tables(jprob)
    n = jprob.jobs
    prmu, limit1 = _nodes(np.random.default_rng(22), n, 96)
    want = np.asarray(pallas_kernels.pfsp_lb1_d_bounds(
        jnp.asarray(prmu), jnp.asarray(limit1), jt.ptm_t, jt.min_heads,
        jt.min_tails, interpret=True))
    got = tdev.lb1_d_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1),
                           _torch_tables_from_jax(jt)).numpy()
    op = _open(limit1, n)
    assert np.array_equal(got[op], want[op])


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_lb1_d_bounds_routes_cpu_to_plain_in_pool_dtype(dtype):
    _, tprob = _problems("ta014")
    t = tprob.device_tables(torch.device("cpu"))
    prmu, limit1 = _nodes(np.random.default_rng(23), 20, 64)
    ref = tdev.lb1_d_chunk(torch.from_numpy(prmu), torch.from_numpy(limit1), t)
    got = tdev.lb1_d_bounds(torch.from_numpy(prmu).to(dtype),
                            torch.from_numpy(limit1).to(dtype), t)
    assert torch.equal(got, ref)
    assert lb1_d_kernel.plain is tdev.lb1_d_chunk


@pytest.mark.parametrize("lb", ["lb1", "lb1_d", "lb2"])
def test_problem_device_bounds_follow_the_bound(lb):
    tprob = TorchPFSP(inst=14, lb=lb, ub=1)
    prmu, limit1 = _nodes(np.random.default_rng(24), 20, 32)
    p, l1 = torch.from_numpy(prmu), torch.from_numpy(limit1)
    plain = {"lb1": tdev.lb1_chunk, "lb1_d": tdev.lb1_d_chunk,
             "lb2": tdev.lb2_chunk}[lb]
    want = plain(p, l1, tprob.device_tables(torch.device("cpu")))
    assert torch.equal(tprob.device_bounds(p, l1), want)



# -- the staged body of kernels 1 and 5 (csrc/lb1_family.cuh) -----------------


def _job(v, n):
    """A staged job id as the kernels read it: clamped to 0..n-1 (job 0)."""
    return int(v) if 0 <= int(v) < n else 0


def _wave_parent(row, l1, n, m, ptm_t, heads, G):
    """A numpy model of `lb1f_parent_wave`, in the kernel's order: G lanes,
    lane l owning the c = ceil(m / G) machines l*c..l*c+c-1: G >= m is
    `lb1f_parent_lanes` (a lane a machine), G = 1 `lb1f_front_thread` (one
    thread a parent). Step s: every lane reads its left neighbour's last
    machine from the step before (the shuffle; lane 0 reads its own), then
    lane l schedules position i = s - l on its machines when
    0 <= i <= min(l1, n-1). Then each machine's work over positions
    max(l1+1, 0)..n-1 (`lb1f_remain`)."""
    c = -(-m // G)
    last = min(l1, n - 1)
    f = heads.copy() if l1 == -1 else np.zeros(m, dtype=np.int64)
    lastv = np.zeros(G, dtype=np.int64)
    for step in range(last + G):
        left = np.concatenate([lastv[:1], lastv[:-1]])
        for lane in range(G):
            j0, i = lane * c, step - lane
            cnt = max(0, min(c, m - j0))
            if cnt == 0 or not 0 <= i <= last:
                continue
            p = ptm_t[_job(row[i], n)]
            v = left[lane]
            for j in range(j0, j0 + cnt):
                v = (f[0] if j == 0 else max(v, f[j])) + p[j]
                f[j] = v
            lastv[lane] = v
    remain = np.zeros(m, dtype=np.int64)
    for i in range(max(l1 + 1, 0), n):
        remain += ptm_t[_job(row[i], n)]
    return f, remain


def _staged_model(prmu, limit1, tables, bound, G):
    """The (B, n) plane of kernel 1 (``bound`` "lb1") or kernel 5
    ("lb1_d") as `lb1f_body` computes it: clamped ids, each parent's front
    and remaining work by a wavefront over G lanes, then every slot's chain
    (`lb1_child`, `lb1_d_child`), the closed slots included."""
    ptm_t = tables.ptm_t.numpy().astype(np.int64)
    heads = tables.min_heads.numpy().astype(np.int64)
    tails = tables.min_tails.numpy().astype(np.int64)
    B, n = prmu.shape
    m = ptm_t.shape[1]
    out = np.zeros((B, n), dtype=np.int64)
    for b in range(B):
        row, l1 = prmu[b], int(limit1[b])
        front, remain = _wave_parent(row, l1, n, m, ptm_t, heads, G)
        p = ptm_t[[_job(v, n) for v in row]]  # (n, m): each slot's job
        if bound == "lb1":
            cf = front[0] + p[:, 0]
            tmp0 = cf + remain[0] - p[:, 0]
            lb = tmp0 + tails[0]
            for i in range(1, m):
                cf = np.maximum(cf, front[i]) + p[:, i]
                tmp0 = np.maximum(tmp0, cf + remain[i] - p[:, i])
                lb = np.maximum(lb, tmp0 + tails[i])
        else:
            lb = np.full(n, front[0] + remain[0] + tails[0], dtype=np.int64)
            tmp0 = front[0] + p[:, 0]
            for i in range(1, m):
                tmp1 = np.maximum(tmp0, front[i])
                lb = np.maximum(lb, tmp1 + remain[i] + tails[i])
                tmp0 = tmp1 + p[:, i]
        out[b] = lb
    return out


def _lanes(m):
    """The lanes a parent of the kernels' prologue: a group of G lanes, one
    machine each (G the power of two at or above m, up to 32 machines), or
    one (warp 0's fronts, one thread a parent)."""
    G = 1
    while G < m:
        G *= 2
    return (G, 1) if m <= 32 else (1,)


def _staged_case(name):
    """(JAX problem or None, the port's CPU tables) of a staged-body test:
    ta014 (m = 10), ta021 (m = 20), a seeded 40-machine, 12-job instance
    (one thread a parent's front), or ta111 (500 jobs, 20 machines, int32
    rows)."""
    if name == "40x12-random":
        ptm = np.random.default_rng(40).integers(1, 100, (40, 12))
        return (PFSPProblem(lb="lb1", ub=0, p_times=ptm),
                TorchPFSP(lb="lb1", ub=0, p_times=ptm).device_tables(torch.device("cpu")))
    inst = int(name[2:])
    jprob = None if inst == 111 else PFSPProblem(inst=inst, lb="lb1", ub=1)
    return jprob, TorchPFSP(inst=inst, lb="lb1", ub=1).device_tables(torch.device("cpu"))


def _depth_nodes(rng, n, B, depth):
    prmu = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    limit1 = {"roots": np.full(B, -1), "leaves": np.full(B, n - 2),
              "mixed": np.arange(B) % n - 1}[depth].astype(np.int32)
    return prmu, limit1


_CHUNK = {"lb1": (tdev.lb1_chunk, pallas_kernels.pfsp_lb1_bounds),
          "lb1_d": (tdev.lb1_d_chunk, pallas_kernels.pfsp_lb1_d_bounds)}


@pytest.mark.parametrize("bound", ["lb1", "lb1_d"])
@pytest.mark.parametrize("depth", ["roots", "mixed", "leaves"])
@pytest.mark.parametrize("name", ["ta014", "ta021", "40x12-random"])
def test_staged_body_matches_plain_and_pallas(name, depth, bound):
    # The plane of kernels 1 and 5 as their shared body computes it (the
    # parent front as a wavefront over a lane a machine, or by one thread;
    # the remaining work over the staged row), equals the plain version on
    # every slot and the Pallas kernel (interpret mode) on the open slots. "roots": limit1 = -1 (min_heads, every job unscheduled);
    # "leaves": limit1 = n - 2; "mixed": every depth from -1 to n - 2.
    jprob, t = _staged_case(name)
    n, m = t.jobs, t.machines
    prmu, limit1 = _depth_nodes(np.random.default_rng(41), n, 24, depth)
    plain, pallas = _CHUNK[bound]
    want = plain(torch.from_numpy(prmu), torch.from_numpy(limit1), t).numpy()
    jt = _jax_tables(jprob)
    jax_plane = np.asarray(pallas(
        jnp.asarray(prmu), jnp.asarray(limit1), jt.ptm_t, jt.min_heads,
        jt.min_tails, interpret=True))
    op = _open(limit1, n)
    for G in _lanes(m):
        got = _staged_model(prmu, limit1, t, bound, G)
        assert np.array_equal(got, want.astype(np.int64)), G
        assert np.array_equal(got[op], jax_plane[op].astype(np.int64)), G


@pytest.mark.parametrize("bound", ["lb1", "lb1_d"])
def test_staged_body_takes_ta111(bound):
    # 500 jobs (int32 rows, 64 KB of staged rows a 32-parent block): the
    # model against the plain version only (a Pallas interpret run at this
    # width is slow), roots, mixed depths and leaves together, by 32 lanes
    # and by one thread.
    _, t = _staged_case("ta111")
    n = t.jobs
    rng = np.random.default_rng(111)
    prmu = np.stack([rng.permutation(n) for _ in range(6)]).astype(np.int32)
    limit1 = np.array([-1, 0, 137, 250, 497, n - 2], dtype=np.int32)
    want = _CHUNK[bound][0](torch.from_numpy(prmu), torch.from_numpy(limit1),
                            t).numpy()
    for G in (32, 1):
        got = _staged_model(prmu, limit1, t, bound, G)
        assert np.array_equal(got, want.astype(np.int64)), G


@pytest.mark.parametrize("bound", ["lb1", "lb1_d"])
@pytest.mark.parametrize("name", ["ta014", "40x12-random"])
def test_staged_body_matches_plain_on_rows_that_are_no_permutation(name, bound):
    # Rows with repeated in-range ids (the unfused chunk past its popped
    # window holds such rows) and limit1 past both ends: the kernels read
    # every limit1 as the plain version does, so the planes stay equal on
    # every slot, as the serial prologue's did.
    _, t = _staged_case(name)
    n = t.jobs
    rng = np.random.default_rng(42)
    prmu = rng.integers(0, n, (32, n)).astype(np.int32)
    prmu[:4] = 0
    limit1 = rng.integers(-3, n + 2, 32).astype(np.int32)
    want = _CHUNK[bound][0](torch.from_numpy(prmu), torch.from_numpy(limit1),
                            t).numpy()
    for G in _lanes(t.machines):
        got = _staged_model(prmu, limit1, t, bound, G)
        assert np.array_equal(got, want.astype(np.int64)), G


def test_staged_model_clamps_ids_out_of_range():
    # An id outside 0..n-1 is read as job 0 (no index past the table): the
    # model's plane for such a row is the plane of the row with those ids
    # set to 0.
    _, t = _staged_case("ta014")
    rng = np.random.default_rng(43)
    prmu = rng.integers(-128, 128, (8, 20)).astype(np.int32)
    limit1 = rng.integers(-1, 19, 8).astype(np.int32)
    fixed = np.where((prmu >= 0) & (prmu < 20), prmu, 0).astype(np.int32)
    for bound in ("lb1", "lb1_d"):
        want = _CHUNK[bound][0](torch.from_numpy(fixed), torch.from_numpy(limit1),
                                t).numpy()
        for G in (16, 1):
            assert np.array_equal(_staged_model(prmu, limit1, t, bound, G),
                                  want.astype(np.int64))
