"""Kernel 7: the lb2 bound of each row's own partial schedule, as a CUDA
kernel for Hopper — the second stage of the staged lb2 evaluator.

Replaces the TPU kernel `_lb2_self_kernel`
(`tpu_tree_search/ops/pallas_kernels.py`, entries
`pfsp_lb2_self_bounds_tables` and `pfsp_lb2_self_bounds`); source
`csrc/lb2_self_bounds.cu`, whose header note says what bounds it on the
card and how the design answers that.

``lb2_self_bounds_cuda`` launches the kernel on CUDA tensors (rows (R, n)
and limit1 (R,) int8 or int32) and raises on anything it does not take;
``plain`` is its plain PyTorch version (`ops/pfsp_device.lb2_self_chunk`).
``n_active`` — the rows to bound — is read by the kernel from device
memory: give it as a CUDA int32 tensor (the staged evaluator's candidate
count) so that the host never waits for it, or as an int. Blocks past it
return at once; rows past it are not written. ``lb2_self_bounds_cuda
.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .lb1_kernel import chunk_operands
from .lb2_kernel import johnson_operands
from .pfsp_device import PFSPDeviceTables, lb2_self_chunk

#: The plain PyTorch version of the kernel.
plain = lb2_self_chunk

_ENTRIES = {torch.int8: "lb2_self_bounds_i8",
            torch.int32: "lb2_self_bounds_i32"}
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def lb2_self_bounds_cuda(rows: torch.Tensor, limit1: torch.Tensor, n_active,
                         tables: PFSPDeviceTables) -> torch.Tensor:
    """(R,) int32 self lb2 of the first ``n_active`` of ``rows`` (R, n) /
    ``limit1`` (R,), computed by the CUDA kernel on the current stream;
    the other entries are left unwritten."""
    rows, limit1 = chunk_operands("lb2_self_bounds", _ENTRIES, rows, limit1,
                                  tables)
    J = johnson_operands("lb2_self_bounds", tables)
    if not isinstance(n_active, torch.Tensor):
        n_active = torch.tensor(int(n_active), dtype=torch.int32)
    n_active = n_active.to(rows.device, torch.int32).reshape(1).contiguous()
    R, n = rows.shape
    out = torch.empty(R, dtype=torch.int32, device=rows.device)
    lib, fn = _build.entry("lb2_self_bounds", _ENTRIES[rows.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = fn(rows.data_ptr(), limit1.data_ptr(), n_active.data_ptr(),
             tables.ptm_t.data_ptr(), tables.min_heads.data_ptr(),
             J.pairinfo.data_ptr(), J.packed.data_ptr(), out.data_ptr(), R, n,
             tables.machines, J.pair_count, stream)
    _build.check(lib, err, "lb2_self_bounds")
    lb2_self_bounds_cuda.launches += 1  # type: ignore[attr-defined]
    return out


lb2_self_bounds_cuda.launches = 0  # type: ignore[attr-defined]
