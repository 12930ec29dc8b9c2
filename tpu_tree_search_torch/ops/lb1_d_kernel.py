"""Kernel 5: the lb1_d bound of every child slot, as a CUDA kernel for
Hopper.

Replaces the TPU kernel `_lb1_d_kernel` (`tpu_tree_search/ops/pallas_kernels.py`,
entry `pfsp_lb1_d_bounds`); source `csrc/lb1_d_bounds.cu`, whose header
note says what bounds it on the card and how the design answers that.

``lb1_d_bounds_cuda`` launches the kernel on CUDA tensors (int8 or int32
prmu/limit1, the operands and checks of kernel 1) and raises on anything it
does not take; ``plain`` is its plain PyTorch version
(`ops/pfsp_device.lb1_d_chunk`). ``lb1_d_bounds_cuda.launches`` counts the
launches.
"""

from __future__ import annotations

import torch

from . import _build
from .dispatch import count_launch
from .lb1_kernel import launch_lb1_family
from .pfsp_device import PFSPDeviceTables, lb1_d_chunk

#: The plain PyTorch version of the kernel.
plain = lb1_d_chunk

_ENTRIES = {torch.int8: "lb1_d_bounds_i8", torch.int32: "lb1_d_bounds_i32"}


def lb1_d_bounds_cuda(prmu: torch.Tensor, limit1: torch.Tensor,
                      tables: PFSPDeviceTables) -> torch.Tensor:
    """(B, n) int32 lb1_d child bounds of ``prmu`` (B, n) / ``limit1``
    (B,), computed by the CUDA kernel on the current stream."""
    out = launch_lb1_family("lb1_d_bounds", _ENTRIES, prmu, limit1, tables)
    count_launch(lb1_d_bounds_cuda)
    return out


lb1_d_bounds_cuda.launches = 0  # type: ignore[attr-defined]
lb1_d_bounds_cuda.captures = 0  # type: ignore[attr-defined]
