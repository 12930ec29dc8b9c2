"""Kernel 1: the lb1 bound of every child slot, as a CUDA kernel for Hopper.

Replaces the TPU kernel `_lb1_kernel` (`tpu_tree_search/ops/pallas_kernels.py`,
entry `pfsp_lb1_bounds`); source `csrc/lb1_bounds.cu`, whose header note
says what bounds it on the card and how the design answers that.

``lb1_bounds_cuda`` launches the kernel on CUDA tensors and raises on
anything it does not take; ``plain`` is its plain PyTorch version
(`ops/pfsp_device.lb1_chunk`), which the CPU tests and the on-card
comparison use. ``lb1_bounds_cuda.launches`` counts the launches.

The kernel reads prmu and limit1 in the pool's storage type, int8 or int32
(limit1 is cast to prmu's type: B elements), so the resident pool's int8
rows go in without a widening copy. ``launch_lb1_family`` is the launch
shared with kernel 5 (`ops/lb1_d_kernel.py`), which takes the same operands
and shares the kernel body (`csrc/lb1_family.cuh`); ``last_shape`` reads
the block shape of either kernel's last launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dispatch import count_launch
from .pfsp_device import PFSPDeviceTables, lb1_chunk

#: The plain PyTorch version of the kernel.
plain = lb1_chunk

_ENTRIES = {torch.int8: "lb1_bounds_i8", torch.int32: "lb1_bounds_i32"}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def chunk_operands(source: str, entries: dict, prmu: torch.Tensor,
                   limit1: torch.Tensor, tables: PFSPDeviceTables):
    """Check the operands of a kernel that bounds PFSP rows (prmu (B, n),
    limit1 (B,), the tables) and return them contiguous, limit1 cast to
    prmu's type (B elements: int8 at -1 is -1, as the kernels read it)."""
    if not prmu.is_cuda:
        raise ValueError(f"{source} takes CUDA tensors "
                         "(pfsp_device routes CPU tensors)")
    if prmu.dtype not in entries:
        raise TypeError(f"prmu must be int8 or int32, got {prmu.dtype}")
    if prmu.dim() != 2 or limit1.shape != (prmu.shape[0],):
        raise ValueError("prmu must be (B, n) and limit1 (B,)")
    n = prmu.shape[1]
    if (n, tables.machines) != tuple(tables.ptm_t.shape):
        raise ValueError("prmu width does not match the tables' job count")
    if tables.device != prmu.device or limit1.device != prmu.device:
        raise ValueError("prmu, limit1 and the tables must share a device")
    return prmu.contiguous(), limit1.to(prmu.dtype).contiguous()


def launch_lb1_family(source: str, entries: dict, prmu: torch.Tensor,
                      limit1: torch.Tensor,
                      tables: PFSPDeviceTables) -> torch.Tensor:
    """Check the operands of an lb1-shaped kernel (prmu (B, n), limit1 (B,),
    the tables) and launch ``entries[prmu.dtype]`` of ``csrc/<source>.cu``
    on the current stream. Returns the (B, n) int32 plane."""
    prmu, limit1 = chunk_operands(source, entries, prmu, limit1, tables)
    B, n = prmu.shape
    out = torch.empty((B, n), dtype=torch.int32, device=prmu.device)
    lib, fn = _build.entry(source, entries[prmu.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(prmu.device).cuda_stream
    err = fn(prmu.data_ptr(), limit1.data_ptr(), tables.ptm_t.data_ptr(),
             tables.min_heads.data_ptr(), tables.min_tails.data_ptr(),
             out.data_ptr(), B, n, tables.machines, stream)
    _build.check(lib, err, source)
    return out


def last_shape(source: str) -> dict:
    """The block shape of the last launch of kernel 1 (``lb1_bounds``) or
    kernel 5 (``lb1_d_bounds``) in this process: parents and threads a
    block, blocks, its dynamic shared memory, whether the whole grid was on
    the card at once (``fits``), and the lanes a parent of the prologue's
    wavefront (``lanes``; each owns ceil(m / lanes) machines)."""
    _, fn = _build.entry(source, f"{source}_last_shape",
                         (ctypes.POINTER(ctypes.c_int),), None)
    out = (ctypes.c_int * 6)()
    fn(out)
    return {"parents": out[0], "threads": out[1], "blocks": out[2],
            "smem_bytes": out[3], "fits": bool(out[4]), "lanes": out[5]}


def lb1_bounds_cuda(prmu: torch.Tensor, limit1: torch.Tensor,
                    tables: PFSPDeviceTables) -> torch.Tensor:
    """(B, n) int32 lb1 child bounds of ``prmu`` (B, n) / ``limit1`` (B,),
    computed by the CUDA kernel on the current stream."""
    out = launch_lb1_family("lb1_bounds", _ENTRIES, prmu, limit1, tables)
    count_launch(lb1_bounds_cuda)
    return out


lb1_bounds_cuda.launches = 0  # type: ignore[attr-defined]
lb1_bounds_cuda.captures = 0  # type: ignore[attr-defined]
