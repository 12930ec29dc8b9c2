"""Kernel 3: the N-Queens safety labels, as a CUDA kernel for Hopper.

Replaces the TPU kernel `_nqueens_kernel` (`tpu_tree_search/ops/pallas_kernels.py`,
entry `nqueens_labels`); source `csrc/nqueens_labels.cu`, whose header note
says what bounds it on the card and how the design answers that.

``nqueens_labels_cuda`` launches the kernel on CUDA tensors and raises on
anything it does not take: board uint8 (B, N) with N <= 256 (what a uint8
board holds; past 32 the kernel runs its scalar per-slot check), depth (B,)
int8 or int32 (the device pool's storage types). ``plain`` is its plain PyTorch
version (`ops/nqueens_device.labels_chunk`).
``nqueens_labels_cuda.launches`` counts the launches; ``last_shape`` reads
the block shape of the last one.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dispatch import count_launch
from .nqueens_device import labels_chunk

#: The plain PyTorch version of the kernel.
plain = labels_chunk

#: Widest board the N-Queens kernels take (csrc/nqueens_common.cuh): a
#: uint8 board holds the rows 0..255.
MAX_N = 256

_ENTRIES = {torch.int8: "nqueens_labels_i8", torch.int32: "nqueens_labels_i32"}
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def last_shape() -> dict:
    """The block shape of kernel 3's last launch in this process: parents
    a tile (the threads of a block), blocks, tiles, packed words of queens
    a parent, and the blocks an SM holds at once (parents, tiles and words
    0: the wide boards' per-slot kernel)."""
    _, fn = _build.entry("nqueens_labels", "nqueens_labels_last_shape",
                         (ctypes.POINTER(ctypes.c_int),), None)
    out = (ctypes.c_int * 5)()
    fn(out)
    return {"parents": out[0], "blocks": out[1], "tiles": out[2],
            "words": out[3], "blocks_per_sm": out[4]}


def nqueens_labels_cuda(board: torch.Tensor, depth: torch.Tensor, N: int,
                        g: int = 1) -> torch.Tensor:
    """(B, N) uint8 safety labels of ``board`` (B, N) / ``depth`` (B,),
    computed by the CUDA kernel on the current stream."""
    if not board.is_cuda or depth.device != board.device:
        raise ValueError("nqueens_labels_cuda takes CUDA tensors on one device "
                         "(nqueens_device.nqueens_labels routes CPU tensors)")
    if board.dtype != torch.uint8 or depth.dtype not in _ENTRIES:
        raise TypeError("board must be uint8 and depth int8 or int32, got "
                        f"{board.dtype} and {depth.dtype}")
    if board.dim() != 2 or board.shape[1] != N or depth.shape != (board.shape[0],):
        raise ValueError("board must be (B, N) and depth (B,)")
    if not 1 <= N <= MAX_N or g < 1:
        raise ValueError(f"the kernel takes 1 <= N <= {MAX_N} and g >= 1 "
                         f"(got N={N}, g={g})")
    B = board.shape[0]
    board = board.contiguous()
    depth = depth.contiguous()
    out = torch.empty((B, N), dtype=torch.uint8, device=board.device)
    lib, fn = _build.entry("nqueens_labels", _ENTRIES[depth.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(board.device).cuda_stream
    err = fn(board.data_ptr(), depth.data_ptr(), out.data_ptr(), B, N, g,
             stream)
    _build.check(lib, err, "nqueens_labels")
    count_launch(nqueens_labels_cuda)
    return out


nqueens_labels_cuda.launches = 0  # type: ignore[attr-defined]
nqueens_labels_cuda.captures = 0  # type: ignore[attr-defined]
