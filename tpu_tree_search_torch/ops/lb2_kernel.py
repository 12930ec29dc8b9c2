"""Kernel 6: the lb2 bound of every child slot, as a CUDA kernel for Hopper.

Replaces the TPU kernel `_lb2_kernel` (`tpu_tree_search/ops/pallas_kernels.py`,
entry `pfsp_lb2_bounds`); source `csrc/lb2_bounds.cu`, whose header note
says what bounds it on the card and how the design answers that.

``lb2_bounds_cuda`` launches the kernel on CUDA tensors (int8 or int32
prmu/limit1, as kernel 1) and raises on anything it does not take; ``plain``
is its plain PyTorch version (`ops/pfsp_device.lb2_chunk`).
``lb2_bounds_cuda.launches`` counts the launches. ``lb2_block_cuda`` is
the same kernel on one mp pair block (`pfsp_device.lb2_bounds_mp`, the
``--mp`` path): the block's own tables, so the launch takes its P_local
pairs and the route is chosen at P_local; its launches are counted apart.

The lb2 kernels (6, 7, 8 and 9c) take two table routes
(`csrc/lb2_common.cuh`), chosen from the shape before the launch:
``smem``, the int16 tables in shared memory (n <= 256, every value below
2^15, the tables and one parent within a block's shared memory), and
``global``, the int32 tables read from device memory through L2 with only
the parents in shared memory (up to ``MAX_JOBS`` jobs). ``route`` owns
that rule: the C entries take the route it picks as an argument and only
refuse a block their shared memory cannot hold; ``johnson_operands``
returns the operands of the route it picks and raises ``NotImplementedError`` on a shape neither takes (more
than ``MAX_JOBS`` jobs, or one parent past shared memory). It never hands
the work to the plain version. Kernels 6 and 8 pick their block shape by
what the card holds at once (``tts_lb2p_shape``); ``last_shape`` reads the
shape and route of a source's last launch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .dispatch import count_launch
from .lb1_kernel import chunk_operands
from .pfsp_device import PFSPDeviceTables, lb2_chunk

#: The plain PyTorch version of the kernel.
plain = lb2_chunk

#: The most jobs the lb2 kernels take (their global route, 32 free-mask
#: words), and the most their shared-memory route takes (byte job ids).
MAX_JOBS = 1024
SMEM_JOBS = 256
#: Dynamic shared memory a block may ask for on sm_90 (227 KB), less room
#: for the kernels' static shared variables.
SMEM_LIMIT = 232448 - 1024
#: The table routes by number, as the sources name them.
ROUTES = ("smem", "global")

_ENTRIES = {torch.int8: "lb2_bounds_i8", torch.int32: "lb2_bounds_i32"}
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


@dataclass
class Lb2Operands:
    """What an lb2 kernel reads on its route: ``tab`` (P, n, 4) int16
    (``smem``) or int32 (``global``), ``inv`` (P, n) int16 (read on the
    global route only), ``pairinfo`` (P, 4) int32."""

    route: int
    tab: torch.Tensor
    inv: torch.Tensor
    pairinfo: torch.Tensor
    pair_count: int

    @property
    def tables(self) -> str:
        return ROUTES[self.route]


def lb2p_smem_bytes(glob: bool, n: int, m: int, P: int, PB: int) -> int:
    """Dynamic shared memory of a block of PB parents of kernels 6, 8 and 9c
    (``tts_lb2p_smem_bytes``): on the smem route the tables (pair rows,
    the int16 ordered table at stride n | 1, its byte inverse, ptm, heads
    and tails) and the parents; on the global route the tails and the
    parents (16-bit job ids)."""
    ms, ns, nw = m | 1, n | 1, ((n + 3) // 4) | 1
    per = PB * (4 + 8 * ms + 4 * n * ms + (2 if glob else 1) * n)
    if glob:
        return 4 * m + per
    return 16 * P + 8 * P * ns + 4 * P * nw + 4 * (n * m + 2 * m) + per


def route(source: str, n: int, m: int, P: int, packed16: bool) -> int:
    """The table route of the lb2 kernel of ``csrc/<source>.cu`` at this
    shape: 0 smem, 1 global, -1 refused."""
    if source == "lb2_self_bounds":
        from .lb2_self_kernel import block_shape

        def fits(glob):
            return block_shape(n, m, P, glob)["smem_bytes"] <= SMEM_LIMIT
    else:
        def fits(glob):
            return lb2p_smem_bytes(glob, n, m, P, 1) <= SMEM_LIMIT
    if n <= SMEM_JOBS and packed16 and fits(False):
        return 0
    if n <= MAX_JOBS and fits(True):
        return 1
    return -1


def block_smem(source: str, tables: PFSPDeviceTables,
               glob: bool = False) -> int:
    """Bytes of dynamic shared memory a block of the lb2 kernel of
    ``csrc/<source>.cu`` needs for these tables on a route (its C entry
    ``<source>_smem``)."""
    _, smem = _build.entry(source, f"{source}_smem", (ctypes.c_int,) * 4,
                           ctypes.c_longlong)
    return smem(tables.jobs, tables.machines, tables.johnson.pair_count,
                int(glob))


def last_shape(source: str) -> dict:
    """The block shape of the last launch of kernel 6 (``lb2_bounds``) or of
    kernel 8's or 9c's bounds launch (``cycle_lb2``, ``tiled_lb2``) in this
    process: parents and threads a block, its dynamic shared memory,
    whether the whole grid was on the card at once (``fits``), and its
    table route (``tables``)."""
    _, fn = _build.entry(source, f"{source}_last_shape",
                         (ctypes.POINTER(ctypes.c_int),), None)
    out = (ctypes.c_int * 5)()
    fn(out)
    return {"parents": out[0], "threads": out[1], "smem_bytes": out[2],
            "fits": bool(out[3]), "tables": ROUTES[out[4]]}


def johnson_operands(source: str, tables: PFSPDeviceTables) -> Lb2Operands:
    """The operands of the lb2 kernel of ``csrc/<source>.cu`` on the route
    it takes at this shape; ``NotImplementedError`` when it takes none."""
    J = tables.johnson
    if J is None:
        raise ValueError("these tables have no lb2 part: build them for "
                         "lb='lb2'")
    n, m, P = tables.jobs, tables.machines, J.pair_count
    r = route(source, n, m, P, J.packed is not None)
    if r < 0:
        why = (f"n = {n} jobs > {MAX_JOBS}" if n > MAX_JOBS else
               f"one parent's state at (n, m, P) = ({n}, {m}, {P}) passes "
               f"the {SMEM_LIMIT} B of shared memory a block may hold")
        raise NotImplementedError(
            f"{source}: the lb2 kernels do not take this instance ({why}); "
            "see ROADMAP.md §C")
    return Lb2Operands(r, J.packed if r == 0 else J.packed32, J.inv,
                       J.pairinfo, P)


def lb2_bounds_cuda(prmu: torch.Tensor, limit1: torch.Tensor,
                    tables: PFSPDeviceTables) -> torch.Tensor:
    """(B, n) int32 lb2 child bounds of ``prmu`` (B, n) / ``limit1`` (B,),
    computed by the CUDA kernel on the current stream."""
    out = _launch(prmu, limit1, tables)
    count_launch(lb2_bounds_cuda)
    return out


def lb2_block_cuda(prmu: torch.Tensor, limit1: torch.Tensor,
                   block: PFSPDeviceTables) -> torch.Tensor:
    """Kernel 6 on one mp pair block (``PFSPDeviceTables.pair_blocks``):
    the (B, n) int32 max over the block's pairs only, on the route the
    block's pair count takes. Its launches are counted apart from
    ``lb2_bounds_cuda``'s (the mp path's pair-block row)."""
    out = _launch(prmu, limit1, block)
    count_launch(lb2_block_cuda)
    return out


def _launch(prmu: torch.Tensor, limit1: torch.Tensor,
            tables: PFSPDeviceTables) -> torch.Tensor:
    """One launch of kernel 6 over the pairs of ``tables``."""
    prmu, limit1 = chunk_operands("lb2_bounds", _ENTRIES, prmu, limit1, tables)
    J = johnson_operands("lb2_bounds", tables)
    B, n = prmu.shape
    out = torch.empty((B, n), dtype=torch.int32, device=prmu.device)
    lib, fn = _build.entry("lb2_bounds", _ENTRIES[prmu.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(prmu.device).cuda_stream
    err = fn(prmu.data_ptr(), limit1.data_ptr(), tables.ptm_t.data_ptr(),
             tables.min_heads.data_ptr(), J.pairinfo.data_ptr(),
             J.tab.data_ptr(), J.inv.data_ptr(), out.data_ptr(), B, n,
             tables.machines, J.pair_count, J.route, stream)
    _build.check(lib, err, "lb2_bounds")
    return out


lb2_bounds_cuda.launches = 0  # type: ignore[attr-defined]
lb2_bounds_cuda.captures = 0  # type: ignore[attr-defined]
lb2_block_cuda.launches = 0  # type: ignore[attr-defined]
lb2_block_cuda.captures = 0  # type: ignore[attr-defined]
