"""Kernel 6: the lb2 bound of every child slot, as a CUDA kernel for Hopper.

Replaces the TPU kernel `_lb2_kernel` (`tpu_tree_search/ops/pallas_kernels.py`,
entry `pfsp_lb2_bounds`); source `csrc/lb2_bounds.cu`, whose header note
says what bounds it on the card and how the design answers that.

``lb2_bounds_cuda`` launches the kernel on CUDA tensors (int8 or int32
prmu/limit1, as kernel 1) and raises on anything it does not take; ``plain``
is its plain PyTorch version (`ops/pfsp_device.lb2_chunk`).
``lb2_bounds_cuda.launches`` counts the launches.

The lb2 kernels (6, 7 and 8) hold the instance's Johnson tables in shared
memory. Kernels 6 and 8 pick their block shape by what the card holds at
once (`csrc/lb2_common.cuh`, ``tts_lb2p_shape``); ``last_shape`` reads the
shape of a source's last launch. ``johnson_operands`` refuses, with
``NotImplementedError``, a shape they do not take: more than ``MAX_JOBS``
jobs (the JAX lb2 kernels serve n <= 100 too, `pfsp_device.py:585`), values
past int16 in the packed table, or tables past the card's shared-memory
opt-in limit. It never hands the work to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .lb1_kernel import chunk_operands
from .pfsp_device import JohnsonTables, PFSPDeviceTables, lb2_chunk

#: The plain PyTorch version of the kernel.
plain = lb2_chunk

#: The most jobs the lb2 kernels take (ROADMAP.md §C).
MAX_JOBS = 100
#: Dynamic shared memory a block may ask for on sm_90 (227 KB), less room
#: for the kernels' static shared variables.
SMEM_LIMIT = 232448 - 1024

_ENTRIES = {torch.int8: "lb2_bounds_i8", torch.int32: "lb2_bounds_i32"}
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def block_smem(source: str, tables: PFSPDeviceTables) -> int:
    """Bytes of dynamic shared memory a block of the lb2 kernel of
    ``csrc/<source>.cu`` needs for these tables (its C entry
    ``<source>_smem``)."""
    _, smem = _build.entry(source, f"{source}_smem", (ctypes.c_int,) * 3,
                           ctypes.c_longlong)
    return smem(tables.jobs, tables.machines, tables.johnson.pair_count)


def last_shape(source: str) -> dict:
    """The block shape of the last launch of kernel 6 (``lb2_bounds``) or of
    kernel 8's or 9c's bounds launch (``cycle_lb2``, ``tiled_lb2``) in this
    process: parents and
    threads a block, its dynamic shared memory, and whether the whole grid
    was on the card at once (``fits``)."""
    _, fn = _build.entry(source, f"{source}_last_shape",
                         (ctypes.POINTER(ctypes.c_int),), None)
    out = (ctypes.c_int * 4)()
    fn(out)
    return {"parents": out[0], "threads": out[1], "smem_bytes": out[2],
            "fits": bool(out[3])}


def johnson_operands(source: str, tables: PFSPDeviceTables) -> JohnsonTables:
    """The Johnson tables the lb2 kernel of ``csrc/<source>.cu`` reads,
    after checking that it takes this instance."""
    J = tables.johnson
    if J is None:
        raise ValueError("these tables have no lb2 part: build them for "
                         "lb='lb2'")
    n = tables.jobs
    why = None
    if n > MAX_JOBS:
        why = f"n = {n} jobs > {MAX_JOBS}"
    elif J.packed is None:
        why = "a time or lag is past int16"
    else:
        need = block_smem(source, tables)
        if need > SMEM_LIMIT:
            why = f"a block needs {need} B of shared memory (> {SMEM_LIMIT})"
    if why:
        raise NotImplementedError(
            f"{source}: the lb2 kernels do not take this instance ({why}); "
            "see ROADMAP.md §C")
    return J


def lb2_bounds_cuda(prmu: torch.Tensor, limit1: torch.Tensor,
                    tables: PFSPDeviceTables) -> torch.Tensor:
    """(B, n) int32 lb2 child bounds of ``prmu`` (B, n) / ``limit1`` (B,),
    computed by the CUDA kernel on the current stream."""
    prmu, limit1 = chunk_operands("lb2_bounds", _ENTRIES, prmu, limit1, tables)
    J = johnson_operands("lb2_bounds", tables)
    B, n = prmu.shape
    out = torch.empty((B, n), dtype=torch.int32, device=prmu.device)
    lib, fn = _build.entry("lb2_bounds", _ENTRIES[prmu.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(prmu.device).cuda_stream
    err = fn(prmu.data_ptr(), limit1.data_ptr(), tables.ptm_t.data_ptr(),
             tables.min_heads.data_ptr(), J.pairinfo.data_ptr(),
             J.packed.data_ptr(), out.data_ptr(), B, n, tables.machines,
             J.pair_count, stream)
    _build.check(lib, err, "lb2_bounds")
    lb2_bounds_cuda.launches += 1  # type: ignore[attr-defined]
    return out


lb2_bounds_cuda.launches = 0  # type: ignore[attr-defined]
