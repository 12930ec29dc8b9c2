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

