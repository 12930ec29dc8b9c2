"""PFSP lb1 and lb1_d on the device: instance tables and the plain PyTorch
bounds — the lb1 half of `tpu_tree_search/ops/pfsp_device.py`.

Forward branching fixes ``limit2 == jobs`` (`pfsp_chpl.chpl:23-26`), so the
tail schedule is always the constant ``min_tails`` table. A child's head
schedule is one ``add_forward`` step from its parent's
(`c_bound_simple.c:31-38` applied incrementally): the parent prefix is
scanned once, then every child slot takes one O(m) update and the m-long
machine chain of `machine_bound_from_parts` (`c_bound_simple.c:126-141`).

The gather of processing times is ``ptm_t[prmu]``; the JAX package's one-hot
matrix product (and its bf16 exactness gate) was a TPU device with no place
here. All arithmetic is int32 (bounds fit comfortably: makespans < 2^31).
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import resolve_device


class PFSPDeviceTables:
    """The lb1 instance tables on one device (`pfsp_gpu_chpl.chpl:362-371`:
    device-resident lbound1 copies): ``ptm_t`` (n, m) job-major processing
    times, ``min_heads`` (m,) and ``min_tails`` (m,), all int32 and
    contiguous — the layout the CUDA kernels read."""

    def __init__(self, ptm_t: torch.Tensor, min_heads: torch.Tensor,
                 min_tails: torch.Tensor):
        n, m = ptm_t.shape
        if min_heads.shape != (m,) or min_tails.shape != (m,):
            raise ValueError("min_heads/min_tails must have shape (m,)")
        self.ptm_t = ptm_t.to(torch.int32).contiguous()
        self.min_heads = min_heads.to(torch.int32).contiguous()
        self.min_tails = min_tails.to(torch.int32).contiguous()

    @classmethod
    def from_lb1(cls, lb1_data, device) -> "PFSPDeviceTables":
        return tables_from_numpy(
            np.ascontiguousarray(lb1_data.p_times.T),
            lb1_data.min_heads, lb1_data.min_tails, device,
        )

    @property
    def device(self) -> torch.device:
        return self.ptm_t.device

    @property
    def jobs(self) -> int:
        return self.ptm_t.shape[0]

    @property
    def machines(self) -> int:
        return self.ptm_t.shape[1]


def tables_from_numpy(ptm_t, min_heads, min_tails, device=None) -> PFSPDeviceTables:
    """Tables from the arrays of the JAX package's ``PFSPDeviceTables``
    (``ptm_t`` (n, m), ``min_heads``/``min_tails`` (m,)) given as numpy."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

    return PFSPDeviceTables(put(ptm_t), put(min_heads), put(min_tails))


def add_forward(front: torch.Tensor, pt_job: torch.Tensor) -> torch.Tensor:
    """One ``add_forward`` step over arbitrary leading axes (broadcasting):
    ``front``/``pt_job`` (..., m) -> the child front (..., m)."""
    m = pt_job.shape[-1]
    cols = [front[..., 0] + pt_job[..., 0]]
    for j in range(1, m):
        cols.append(torch.maximum(cols[-1], front[..., j]) + pt_job[..., j])
    return torch.stack(cols, dim=-1)


def machine_bound_from_parts(front, back, remain) -> torch.Tensor:
    """`machine_bound_from_parts` (`c_bound_simple.c:126-141`) over leading
    axes: front/remain (..., m), back (m,). Returns (...)."""
    m = front.shape[-1]
    tmp0 = front[..., 0] + remain[..., 0]
    lb = tmp0 + back[0]
    for i in range(1, m):
        tmp1 = torch.maximum(tmp0, front[..., i] + remain[..., i])
        lb = torch.maximum(lb, tmp1 + back[i])
        tmp0 = tmp1
    return lb


def parent_state(prmu: torch.Tensor, limit1: torch.Tensor,
                 tables: PFSPDeviceTables):
    """Per-parent precomputation of a chunk (`pfsp_device.py:101-131`).

    prmu (B, n) and limit1 (B,) of any integer dtype. Returns
    ``(front, remain, ptg)``: front (B, m) = schedule_front
    (`c_bound_simple.c:51-69`, ``min_heads`` at limit1 == -1), remain (B, m)
    = sum_unscheduled (`c_bound_simple.c:108-124`), ptg (B, n, m) the
    processing times gathered per position — all int32.
    """
    B, n = prmu.shape
    limit1 = limit1.to(torch.int32)
    ptg = tables.ptm_t[prmu.long()]  # (B, n, m)
    front = torch.zeros((B, tables.machines), dtype=torch.int32,
                        device=prmu.device)
    for i in range(n):
        newf = add_forward(front, ptg[:, i, :])
        front = torch.where((i <= limit1)[:, None], newf, front)
    front = torch.where((limit1 == -1)[:, None], tables.min_heads[None, :],
                        front)
    pos = torch.arange(n, dtype=torch.int32, device=prmu.device)
    unsched = (pos[None, :] >= (limit1 + 1)[:, None]).to(torch.int32)
    remain = torch.sum(ptg * unsched[:, :, None], dim=1, dtype=torch.int32)
    return front, remain, ptg


def lb1_chunk(prmu: torch.Tensor, limit1: torch.Tensor,
              tables: PFSPDeviceTables) -> torch.Tensor:
    """Plain lb1 of every child of every parent (`pfsp_device._lb1_chunk`).

    Child slot (i, k): the full `lb1_bound` of the parent with the job at
    position k appended to its prefix (`evaluate.cu:25-49`). Returns (B, n)
    int32; slots k <= limit1 are not children and are never read (the
    reference's untouched-slot convention).
    """
    front, remain, ptg = parent_state(prmu, limit1, tables)
    child_front = add_forward(front[:, None, :], ptg)  # (B, n, m)
    child_remain = remain[:, None, :] - ptg
    return machine_bound_from_parts(child_front, tables.min_tails,
                                    child_remain)


def lb1_d_chunk(prmu: torch.Tensor, limit1: torch.Tensor,
                tables: PFSPDeviceTables) -> torch.Tensor:
    """Plain lb1_d of every child of every parent (`pfsp_device._lb1_d_chunk`:
    `add_front_and_bound`, `c_bound_simple.c:213-244`; device
    `evaluate.cu:51-71`): O(m) per child slot from the parent's front and
    remaining work, one pass for all children. Returns (B, n) int32; slots
    k <= limit1 are not children and are never read."""
    front, remain, ptg = parent_state(prmu, limit1, tables)
    back = tables.min_tails
    f = front[:, None, :]  # (B, 1, m)
    r = remain[:, None, :]
    lb = f[..., 0] + r[..., 0] + back[0]  # (B, 1) -> broadcasts to (B, n)
    tmp0 = f[..., 0] + ptg[..., 0]  # (B, n)
    for i in range(1, tables.machines):
        tmp1 = torch.maximum(tmp0, f[..., i])
        lb = torch.maximum(lb, tmp1 + r[..., i] + back[i])
        tmp0 = tmp1 + ptg[..., i]
    return lb


def lb1_bounds(prmu: torch.Tensor, limit1: torch.Tensor,
               tables: PFSPDeviceTables) -> torch.Tensor:
    """lb1 child bounds routed by device: a CUDA tensor goes to the CUDA
    kernel (`ops/lb1_kernel.py`, which launches or raises), a CPU tensor to
    the plain ``lb1_chunk``."""
    if prmu.is_cuda:
        from .lb1_kernel import lb1_bounds_cuda

        return lb1_bounds_cuda(prmu, limit1, tables)
    return lb1_chunk(prmu, limit1, tables)


def lb1_d_bounds(prmu: torch.Tensor, limit1: torch.Tensor,
                 tables: PFSPDeviceTables) -> torch.Tensor:
    """lb1_d child bounds routed like ``lb1_bounds``: the CUDA kernel
    (`ops/lb1_d_kernel.py`) for a CUDA tensor, ``lb1_d_chunk`` for a CPU
    tensor."""
    if prmu.is_cuda:
        from .lb1_d_kernel import lb1_d_bounds_cuda

        return lb1_d_bounds_cuda(prmu, limit1, tables)
    return lb1_d_chunk(prmu, limit1, tables)
