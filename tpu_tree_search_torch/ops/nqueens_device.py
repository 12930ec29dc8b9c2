"""N-Queens safety labels on the device — the port of
`tpu_tree_search/ops/nqueens_device.py`.

``labels_chunk`` is the plain PyTorch version (the ``make_core`` contract):
one (B, N, N) clash tensor — (parent, placed queen i, candidate slot k) —
reduced over i. ``nqueens_labels`` routes by device: a CUDA tensor goes to
the CUDA kernel (`ops/nqueens_kernel.py`, which launches or raises), a CPU
tensor to ``labels_chunk``.
"""

from __future__ import annotations

import torch

from .dispatch import route


def labels_chunk(board: torch.Tensor, depth: torch.Tensor, N: int,
                 g: int = 1) -> torch.Tensor:
    """(B, N) uint8 labels of ``board`` (B, N) / ``depth`` (B,), any integer
    dtypes: labels[b, k] == 1 iff swapping slot k into position depth_b
    keeps every diagonal safe. Slots k < depth are 0.

    The ``g`` rounds are real work, each one the whole clash tensor (the
    reference repeats the comparisons g times, `nqueens_gpu_chpl.chpl:115-118`;
    PyTorch runs eagerly, so nothing folds them).
    """
    B = board.shape[0]
    board = board.to(torch.int32)
    depth = depth.to(torch.int32)
    qk = board[:, None, :]  # candidate row for slot k: (B, 1, N)
    bi = board[:, :, None]  # placed queen rows:        (B, N, 1)
    i = torch.arange(N, dtype=torch.int32, device=board.device)
    d = (depth[:, None] - i[None, :])[:, :, None]  # (B, N, 1): depth - i
    placed = (i[None, :] < depth[:, None])[:, :, None]  # mask over i
    safe = torch.ones((B, N), dtype=torch.bool, device=board.device)
    for _ in range(g):
        clash = (bi == qk - d) | (bi == qk + d)
        safe = safe & ~torch.any(clash & placed, dim=1)
    valid = i[None, :] >= depth[:, None]
    return (safe & valid).to(torch.uint8)


def nqueens_labels(board: torch.Tensor, depth: torch.Tensor, N: int,
                   g: int = 1) -> torch.Tensor:
    """Safety labels routed by device: the CUDA kernel for a CUDA tensor,
    ``labels_chunk`` for a CPU tensor. Same contract as ``labels_chunk``."""
    with route("nqueens_labels_cuda"):
        if board.is_cuda:
            from .nqueens_kernel import nqueens_labels_cuda

            return nqueens_labels_cuda(board, depth, N, g)
        return labels_chunk(board, depth, N, g)
