"""Survivor-path stream compaction for the unfused resident cycle — the
port's counterpart of `tpu_tree_search/ops/compaction.py` (plain PyTorch:
the JAX module holds no Pallas kernel either).

One cycle ends by pushing the surviving children contiguously onto the pool
in (parent, slot) order — the reference's child push order
(`pfsp_gpu_chpl.chpl:276-298`). Ranking survivors is a pair of prefix sums;
inverting the rank map is done by one of four modes (the JAX module's
``MODES``) that return identical ids, the rows past the survivors
included:

  * ``scatter`` — one int32-id scatter to unique destinations;
  * ``sort``    — a stable argsort of the rank key (a non-survivor's key is
    M*n);
  * ``search``  — the binary-search inverse: each output rank's parent by
    ``searchsorted`` on the parent offsets, then its lane;
  * ``dense``   — stream compaction by LSB-first binary shifts: every
    survivor moves left by ``dist = flat_index - rank``; shifting by 2^b for
    bit b of the remaining distance, b ascending, never collides (see
    ``shift_compact``).

Every mode has fixed shapes and no host read, so the unfused cycle that
calls it is captured into a graph (`ops/dispatch.py`); what the stable
sort allocates there comes from the graph's pool.

``resolve_compact_mode`` (`ops/compact_policy.py`, which imports no torch:
the serve pool and the fleet router compute class keys with it) takes the
explicit ``TTS_COMPACT`` (``--compact``) first, else the JAX auto policy's
rows that apply here: N-Queens always ``dense``; otherwise the GPU row,
``dense`` for grids of at most 2^16 slots and ``scatter`` above. The fused
cycles (`ops/cycle.py`, `ops/cycle_nqueens.py`) compact inside their
kernels and use none of this.
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
    if mode == "sort":
        key = torch.where(flat, ranks.reshape(Mn), Mn)
        return torch.argsort(key, stable=True)[:S].to(torch.int32), tree_inc
    if mode == "search":
        # Output rank s: its parent is the last p with offs[p] <= s (a
        # parent of no survivor shares the next one's offset, so right=True
        # passes it), its slot the lane whose exclusive lane count is the
        # rank within the parent; the clamp keeps the rows past the
        # survivors in bounds (the JAX module's `compaction.py:225-241`).
        cnt = torch.sum(keep, dim=1, dtype=torch.int32)
        offs = torch.cumsum(cnt, dim=0, dtype=torch.int32) - cnt
        lane = ranks - offs[:, None]
        pos = torch.arange(S, dtype=torch.int32, device=keep.device)
        parent = torch.clamp(
            torch.searchsorted(offs, pos, right=True, out_int32=True) - 1,
            0, M - 1).long()
        r = pos - offs[parent]
        # argmax takes no bool on CUDA; like jnp.argmax it returns the
        # first maximum (lane 0 on a row with none).
        hit = (lane[parent] == r[:, None]) & keep[parent]
        slot = torch.argmax(hit.to(torch.uint8), dim=1)
        return (parent * n + slot).to(torch.int32), tree_inc
    if mode != "scatter":
        raise ValueError(f"unknown compaction mode {mode!r}")
    # Survivors of rank < S land at their rank (unique); non-survivors and
    # survivors past the budget land in the tail past S, which the slice
    # drops (the JAX scatter's mode="drop").
    dst = torch.where(flat, ranks.reshape(Mn), S + flat_idx)
    buf = torch.zeros(S + Mn, dtype=torch.int32, device=keep.device)
    buf[dst.long()] = flat_idx
    return buf[:S], tree_inc


def children_of(parents: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Every child of each parent, ``(B*n, n)`` in (parent, slot) order:
    child (b, k) is ``parents[b]`` (B, n) with positions ``d[b]`` ((B, 1)
    int64, the parent's swap position) and k swapped, the branching of
    both problems. Two selects over broadcast lane masks, as the JAX push
    builds a child (`resident.py:316-344`): the (n, n) diagonal puts the
    parent's value at d in lane k, the (B, 1, n) mask of lane d the
    parent's value at k in lane d. Every operand but the inner select's
    output is a (B, n) plane or smaller, so the children are written twice
    and read once, with no scatter; the push then takes its ranked rows
    with its one gather of child values."""
    B, n = parents.shape
    lane = torch.arange(n, device=parents.device)
    inner = torch.where(lane[:, None] == lane[None, :],
                        parents.gather(1, d)[:, :, None], parents[:, None, :])
    return torch.where((lane == d)[:, None, :], parents[:, :, None],
                       inner).reshape(B * n, n)


# -- program contracts (`check`, analysis/contracts.py) ------------------------
# The survivor-path claims, declared next to the code that makes them and
# checked over the whole knob matrix by analysis/program_audit.py.

from ..analysis.contracts import (  # noqa: E402
    GATHER_OPS,
    SCATTER_OPS,
    SEARCH_OPS,
    SORT_OPS,
    WINDOW_OPS,
    contract,
    entry_counts,
)


@contract(
    "dense-step-no-sort-scatter",
    claim="an unfused cycle whose resolved survivor path is `dense` adds no "
          "sort, no searchsorted and no scatter (index_put, scatter, "
          "index_add, ...) beyond the bare evaluator's own record (the "
          "staged lb2 evaluator compacts its candidates with one) — the "
          "phase clock's marks are kernel routes, not scatters. The push "
          "writes its M*n rows with index_copy_ at an offset held on the "
          "device: that is the counterpart of the JAX "
          "dynamic_update_slice, allowed where its index is a contiguous "
          "window, and a scatter where it is not. The children are built "
          "by selects over lane masks, as in the JAX push: every child of "
          "each popped parent (`children_of`), then the push's one gather "
          "of child values by rank (see fused-push-single-gather), with no "
          "scatter",
    artifact="cycle",
    applies=lambda cell: cell is not None and not cell.fused,
)
def _contract_dense_step(art, cell):
    if art.prog.compact != "dense":
        return []
    counts = entry_counts(art.record.cycle_entries())
    out = []
    for name in sorted(SORT_OPS | SEARCH_OPS | SCATTER_OPS):
        extra = counts.get(name, 0) - art.eval_counts.get(name, 0)
        if extra > 0:
            out.append(f"{extra} {name} op(s) in the dense cycle beyond the "
                       "bare evaluator's")
    for e in art.record.body:
        if e.name in WINDOW_OPS and e.get("window") is False:
            out.append(f"{e.name} at a non-contiguous index: a scatter, not "
                       "the push's window write")
    return out


@contract(
    "dense-ids-shift-only",
    claim="the dense rank inversion (`compact_ids` mode='dense') is pure "
          "shifts and selects: no sort, no searchsorted, no scatter or "
          "index_put, and no gather or index (the push makes the cycle's "
          "one gather)",
    artifact="compact-ids",
)
def _contract_dense_ids(art, cell):
    if art["mode"] != "dense":
        return []
    banned = SORT_OPS | SEARCH_OPS | SCATTER_OPS | WINDOW_OPS | GATHER_OPS
    bad = sorted({e.name for e in art["entries"] if e.name in banned})
    if bad:
        return [f"dense compact_ids uses {bad} (must be shift-only)"]
    return []


@contract(
    "scatter-ids-unique",
    claim="the scatter rank inversion's one scatter is an index_put with "
          "accumulate=False whose destinations are distinct (checked on the "
          "recorded values on the CPU): the mode's whole cost model rests "
          "on a unique-indexed scatter",
    artifact="compact-ids",
)
def _contract_scatter_ids(art, cell):
    if art["mode"] != "scatter":
        return []
    scatters = [e for e in art["entries"] if e.name in SCATTER_OPS]
    if not scatters:
        return ["scatter compact_ids holds no scatter"]
    out = []
    for e in scatters:
        if e.get("accumulate") is not False:
            out.append(f"{e.name} is not accumulate=False")
        if e.get("unique") is False:
            out.append(f"{e.name} writes a destination twice")
    return out


@contract(
    "compact-auto-identity",
    claim="TTS_COMPACT=auto records the same program as the explicitly "
          "spelled mode it resolves to — the policy adds no behaviour of "
          "its own",
    artifact="variants",
)
def _contract_auto_identity(art, cell):
    explicit = [lb for lb in art.variants
                if lb.startswith("compact-") and lb != "compact-auto"]
    if "compact-auto" not in art.variants or not explicit:
        return []
    out = []
    for lb in explicit:
        if art.text("compact-auto") != art.text(lb):
            out.append(f"TTS_COMPACT=auto records a different program from "
                       f"{lb} (the mode it resolves to)")
    return out
