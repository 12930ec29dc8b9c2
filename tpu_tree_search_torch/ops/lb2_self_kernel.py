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
``lb2_self_block_cuda`` is the same kernel on one mp pair block
(`pfsp_device.lb2_self_bounds_mp`), its launches counted apart.
``n_active`` — the rows to bound — is read by the kernel from device
memory: give it as a CUDA int32 tensor (the staged evaluator's candidate
count) so that the host never waits for it, or as an int. The grid is one
wave of blocks; a block with no rows below ``n_active`` returns at once,
and rows past it are not written. ``lb2_self_bounds_cuda.launches`` counts
the launches.

The block shape mirrors the source: ``block_shape`` and ``block_bytes``
(the table's stride, threads, rows a thread and dynamic shared memory, on
the shared-memory or the global table route of `ops/lb2_kernel.py`;
`tts_lb2s_block`, `tts_lb2s_smem_bytes`), ``split`` (the lanes a row and
rows a thread the kernel picks from ``n_active``, `lb2s_split`);
``last_shape`` reads the shape of the last launch in this process, and
``last_split`` the split that launch took, as its block 0 wrote it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dispatch import count_launch
from .lb1_kernel import chunk_operands
from .lb2_kernel import ROUTES, SMEM_LIMIT, johnson_operands
from .pfsp_device import PFSPDeviceTables, lb2_self_chunk

#: The plain PyTorch version of the kernel.
plain = lb2_self_chunk

#: Threads of a block (`TTS_LB2S_THREADS`) and the most rows a thread takes
#: at once (`TTS_LB2S_ROWS`), each halved while the block's shared memory
#: does not fit (threads first, down to one warp).
THREADS = 128
ROWS = 4

_ENTRIES = {torch.int8: "lb2_self_bounds_i8",
            torch.int32: "lb2_self_bounds_i32"}
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def block_bytes(n: int, m: int, P: int, ns: int, threads: int,
                rows: int = 1, glob: bool = False) -> int:
    """Dynamic shared memory of a block of ``threads`` threads taking up to
    ``rows`` rows a thread: the pair rows, the ordered table at the stride
    ``ns``, ptm and min_heads (16-aligned; none on the global route), then
    for U = threads * rows rows the staged rows (bytes; 16-bit ids on the
    global route) with 16 bytes of head room, their limit1 and their fronts
    at the odd stride m | 1."""
    U = threads * rows
    tables = 0 if glob else 16 * P + 8 * P * ns + 4 * (n * m + m)
    stash = (U * n * (2 if glob else 1) + 15) // 16 * 16 + 16
    return (tables + 15) // 16 * 16 + stash + 4 * U * (1 + (m | 1))


def block_shape(n: int, m: int, P: int, glob: bool = False) -> dict:
    """A block at this shape: the ordered table's stride (n | 1, odd, or n
    where only that fits; n on the global route), threads, the most rows a
    thread (one on the global route), and its dynamic shared memory."""
    for ns in ((n,) if glob else (n | 1, n)):
        threads = THREADS
        while threads > 32 and block_bytes(n, m, P, ns, threads, 1,
                                           glob) > SMEM_LIMIT:
            threads //= 2
        if block_bytes(n, m, P, ns, threads, 1, glob) <= SMEM_LIMIT:
            break
    rows = 1 if glob else ROWS
    while rows > 1 and block_bytes(n, m, P, ns, threads, rows,
                                   glob) > SMEM_LIMIT:
        rows //= 2
    return {"ns": ns, "threads": threads, "rows": rows,
            "smem_bytes": block_bytes(n, m, P, ns, threads, rows, glob)}


def split(n_active: int, blocks: int, threads: int, rows: int, P: int,
          m: int) -> tuple[int, int]:
    """(lanes a row, rows a thread) of a launch of ``blocks`` blocks at
    ``n_active`` (clipped to R): the lanes the smallest power of two, up to
    32, that covers the pairs and the machines, halved while the rows'
    lanes exceed the grid's threads; at one lane a row, the rows a thread
    that the threads need, up to ``rows``."""
    lanes = blocks * threads
    G = 32
    while G > 1 and G // 2 >= max(P, m):
        G //= 2
    while G > 1 and n_active * G > lanes:
        G //= 2
    return G, (1 if G > 1 else min(-(-n_active // lanes), rows))


def last_shape() -> dict:
    """The block shape of the last launch in this process: threads, the
    most rows a thread, blocks, dynamic shared memory, blocks an SM by the
    occupancy, the ordered table's stride, and the table route."""
    _, fn = _build.entry("lb2_self_bounds", "lb2_self_bounds_last_shape",
                         (ctypes.POINTER(ctypes.c_int),), None)
    out = (ctypes.c_int * 7)()
    fn(out)
    return {"threads": out[0], "rows": out[1], "blocks": out[2],
            "smem_bytes": out[3], "per_sm": out[4], "ns": out[5],
            "tables": ROUTES[out[6]]}


def last_split() -> tuple[int, int]:
    """(lanes a row, rows a thread) that the last launch on the current
    device took from its ``n_active``, read from device memory ((0, 0)
    when it had no rows). Waits for that launch."""
    lib, fn = _build.entry("lb2_self_bounds", "lb2_self_bounds_last_split",
                           (ctypes.POINTER(ctypes.c_int),))
    out = (ctypes.c_int * 2)()
    _build.check(lib, fn(out), "lb2_self_bounds_last_split")
    return out[0], out[1]


def lb2_self_bounds_cuda(rows: torch.Tensor, limit1: torch.Tensor, n_active,
                         tables: PFSPDeviceTables) -> torch.Tensor:
    """(R,) int32 self lb2 of the first ``n_active`` of ``rows`` (R, n) /
    ``limit1`` (R,), computed by the CUDA kernel on the current stream;
    the other entries are left unwritten."""
    out = _launch(rows, limit1, n_active, tables)
    count_launch(lb2_self_bounds_cuda)
    return out


def lb2_self_block_cuda(rows: torch.Tensor, limit1: torch.Tensor, n_active,
                        block: PFSPDeviceTables) -> torch.Tensor:
    """Kernel 7 on one mp pair block (``PFSPDeviceTables.pair_blocks``):
    the max over the block's pairs only, on the block shape and route of
    its pair count; launches counted apart from
    ``lb2_self_bounds_cuda``'s."""
    out = _launch(rows, limit1, n_active, block)
    count_launch(lb2_self_block_cuda)
    return out


def _launch(rows: torch.Tensor, limit1: torch.Tensor, n_active,
            tables: PFSPDeviceTables) -> torch.Tensor:
    """One launch of kernel 7 over the pairs of ``tables``."""
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
             J.pairinfo.data_ptr(), J.tab.data_ptr(), out.data_ptr(), R, n,
             tables.machines, J.pair_count, J.route, stream)
    _build.check(lib, err, "lb2_self_bounds")
    return out


lb2_self_bounds_cuda.launches = 0  # type: ignore[attr-defined]
lb2_self_bounds_cuda.captures = 0  # type: ignore[attr-defined]
lb2_self_block_cuda.launches = 0  # type: ignore[attr-defined]
lb2_self_block_cuda.captures = 0  # type: ignore[attr-defined]
