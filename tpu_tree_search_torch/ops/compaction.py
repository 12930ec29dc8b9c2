"""Survivor-path stream compaction for the unfused resident cycle — the
port's counterpart of `tpu_tree_search/ops/compaction.py` (plain PyTorch:
the JAX module holds no Pallas kernel either).

One cycle ends by pushing the surviving children contiguously onto the pool
in (parent, slot) order — the reference's child push order
(`pfsp_gpu_chpl.chpl:276-298`). Ranking survivors is a pair of prefix sums;
inverting the rank map is done by one of two modes that return identical
ids:

  * ``scatter`` — one int32-id scatter to unique destinations;
  * ``dense``   — stream compaction by LSB-first binary shifts: every
    survivor moves left by ``dist = flat_index - rank``; shifting by 2^b for
    bit b of the remaining distance, b ascending, never collides (see
    ``shift_compact``).

``resolve_compact_mode`` (`ops/compact_policy.py`, which imports no torch:
the serve pool and the fleet router compute class keys with it) keeps the
JAX auto policy's rows that apply here:
N-Queens always ``dense``; otherwise the GPU row, ``dense`` for grids of at
most 2^16 slots and ``scatter`` above. The fused cycles (`ops/cycle.py`,
`ops/cycle_nqueens.py`) compact inside their kernels and use none of this.
"""

from __future__ import annotations

import torch


def _shift_left(x: torch.Tensor, s: int) -> torch.Tensor:
    """x shifted s positions toward index 0 along axis 0, zero-filled."""
    pad = torch.zeros((s,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x[s:], pad], dim=0)


def shift_compact(dist: torch.Tensor, payloads: tuple) -> tuple:
    """Stable left-packing by LSB-first binary shifts.

    ``dist``: (L,) int32 — how far each element must move toward index 0
    (0 for non-survivors, ``index - rank`` for survivors). ``payloads``:
    tensors with leading axis L, moved in lockstep. After the last round,
    ranks 0..count-1 hold the survivors in order; everything past them is
    garbage (dead by the pool contract).
    """
    L = dist.shape[0]
    for b in range(max(1, int(L - 1).bit_length())):
        s = 1 << b
        if s >= L:
            break
        sh_d = _shift_left(dist, s)
        take = (sh_d & s) != 0
        moving = (dist & s) != 0
        payloads = tuple(
            torch.where(take.reshape((-1,) + (1,) * (p.dim() - 1)),
                        _shift_left(p, s), p)
            for p in payloads
        )
        dist = torch.where(take, sh_d - s,
                           torch.where(moving, torch.zeros_like(dist), dist))
    return payloads


def survivor_ranks(keep: torch.Tensor):
    """Survivor ranks of a (M, n) keep mask in (parent, slot) order: lane
    scan + per-parent prefix. Returns ``(ranks (M, n) int32, tree_inc)``
    with ``tree_inc`` a 0-d int32 tensor (no host sync)."""
    k = keep.to(torch.int32)
    cnt = torch.sum(k, dim=1, dtype=torch.int32)
    offs = torch.cumsum(cnt, dim=0, dtype=torch.int32) - cnt
    lane = torch.cumsum(k, dim=1, dtype=torch.int32) - k
    return offs[:, None] + lane, offs[-1] + cnt[-1]


def compact_ids(keep: torch.Tensor, S: int, mode: str):
    """Stream-compaction ids of the surviving (parent, slot) pairs.

    keep: (M, n) bool. Returns (ids, tree_inc): ids (S,) int32 with
    ids[s] = flat index i*n+k of the s-th survivor in (parent, slot) order
    for s < tree_inc; rows past tree_inc are in-bounds garbage (the same
    garbage as the JAX module's in each mode).
    """
    M, n = keep.shape
    Mn = M * n
    ranks, tree_inc = survivor_ranks(keep)
    flat = keep.reshape(Mn)
    flat_idx = torch.arange(Mn, dtype=torch.int32, device=keep.device)
    if mode == "dense":
        dist = torch.where(flat, flat_idx - ranks.reshape(Mn),
                           torch.zeros_like(flat_idx))
        (ids,) = shift_compact(dist, (flat_idx,))
        return ids[:S], tree_inc
    if mode != "scatter":
        raise ValueError(f"unknown compaction mode {mode!r}")
    # Survivors of rank < S land at their rank (unique); non-survivors and
    # survivors past the budget land in the tail past S, which the slice
    # drops (the JAX scatter's mode="drop").
    dst = torch.where(flat, ranks.reshape(Mn), S + flat_idx)
    buf = torch.zeros(S + Mn, dtype=torch.int32, device=keep.device)
    buf[dst.long()] = flat_idx
    return buf[:S], tree_inc
