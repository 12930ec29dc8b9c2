"""PFSP lb1, lb1_d and lb2 on the device: instance tables and the plain
PyTorch bounds — the port of `tpu_tree_search/ops/pfsp_device.py`.

Forward branching fixes ``limit2 == jobs`` (`pfsp_chpl.chpl:23-26`), so the
tail schedule is always the constant ``min_tails`` table. A child's head
schedule is one ``add_forward`` step from its parent's
(`c_bound_simple.c:31-38` applied incrementally): the parent prefix is
scanned once, then every child slot takes one O(m) update and the m-long
machine chain of `machine_bound_from_parts` (`c_bound_simple.c:126-141`).

lb2 (`c_bound_johnson.c:190-254`) takes, per machine pair q, the Johnson
two-machine makespan of the free jobs in the pair's Johnson order, from the
child's front: ``tmp0 += p0; tmp1 = max(tmp1, tmp0 + lag) + p1`` over the
ordered free jobs, then ``max(tmp1 + tails1, tmp0 + tails0)``, maxed over
the pairs. The plain versions use the JAX module's closed form of that
max-plus recurrence (prefix and suffix sums along the ordered slots); the
kernels run the recurrence itself. Both are exact on integers. The C early
exit is dropped, as in the JAX module, so the planes are equal.

The gathers are integer indexing (``ptm_t[prmu]``, the Johnson order as job
ids); the JAX package's one-hot matrix products (``jorder``, ``msel*``) and
their bf16 exactness gate were TPU devices with no place here. All
arithmetic is int32 (bounds fit comfortably: makespans < 2^31).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .backend import resolve_device
from .compaction import children_of
from .dispatch import route

#: Below any bound: the value of a slot that is not free in the closed form
#: (the JAX module's ``NEG_INF``).
NEG = -(2**30)


class JohnsonTables:
    """The lb2 tables of one instance on one device, in Johnson schedule
    order (`pfsp_device.py:362-390` without the one-hot ``jorder`` and
    ``msel*``): for the t-th job of pair q's Johnson schedule, ``sched``
    its job id, ``p0_o``/``p1_o`` its times on the pair's two machines and
    ``lag_o`` its lag, all (P, n) int32; ``pairs`` (P, 2) the machine
    indices and ``tails0``/``tails1`` (P,) the ``min_tails`` of those
    machines. ``host`` holds the same arrays in numpy, for the plain pair
    loop. The kernels read packed copies: ``packed`` (P, n, 4) int16 rows
    (p0, p1, lag, job) — exact while every value is below 2^15, else None —
    for their shared-memory route, ``packed32`` (P, n, 4) int32 rows and
    ``inv`` (P, n) int16, the slot of each job in the pair's order, for
    their global-memory route, and ``pairinfo`` (P, 4) int32 rows (machine
    0, machine 1, tails0, tails1)."""

    def __init__(self, ptm_t, min_tails, pairs, lags, johnson_schedules,
                 device: torch.device):
        ptm = np.asarray(ptm_t, dtype=np.int64).T  # (m, n)
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        sched = np.asarray(johnson_schedules, dtype=np.int64)
        lags = np.asarray(lags, dtype=np.int64)
        tails = np.asarray(min_tails, dtype=np.int64)
        # The arrays the tables were built from (the JAX tables' fields):
        # a pair block's tables are built from slices of them.
        self.source = {"ptm_t": ptm.T, "min_tails": tails, "pairs": pairs,
                       "lags": lags, "johnson_schedules": sched}
        rows = np.arange(pairs.shape[0])[:, None]
        host = {
            "p0_o": ptm[pairs[:, 0][:, None], sched],
            "p1_o": ptm[pairs[:, 1][:, None], sched],
            "lag_o": lags[rows, sched],
            "sched": sched,
            "pairs": pairs,
            "tails0": tails[pairs[:, 0]],
            "tails1": tails[pairs[:, 1]],
        }
        self.host = {k: v.astype(np.int32) for k, v in host.items()}
        for k, v in self.host.items():
            setattr(self, k, torch.from_numpy(v).to(device).contiguous())
        self.sched_long = self.sched.long()
        slots = np.stack([host["p0_o"], host["p1_o"], host["lag_o"], sched], -1)
        self.packed = (torch.from_numpy(slots.astype(np.int16)).to(device)
                       .contiguous()
                       if slots.min() >= 0 and slots.max() < 2**15 else None)
        self.packed32 = torch.from_numpy(
            slots.astype(np.int32)).to(device).contiguous()
        inv = np.zeros(sched.shape, dtype=np.int16)
        np.put_along_axis(inv, sched, np.arange(sched.shape[1], dtype=np.int16)
                          [None, :].repeat(sched.shape[0], 0), axis=1)
        self.inv = torch.from_numpy(inv).to(device).contiguous()
        self.pairinfo = torch.from_numpy(np.stack(
            [pairs[:, 0], pairs[:, 1], host["tails0"], host["tails1"]], -1)
            .astype(np.int32)).to(device).contiguous()

        # The mp-padded arrays and pair blocks, built at first use
        # (``PFSPDeviceTables.mp_padded``, ``pair_blocks``).
        # guarded-by: lock -- threads of the multi-device tiers share one
        # problem's tables.
        self.lock = threading.Lock()
        self.padded: dict = {}
        self.blocks: dict = {}

    @property
    def pair_count(self) -> int:
        return self.pairs.shape[0]


class PFSPDeviceTables:
    """The instance tables on one device (`pfsp_gpu_chpl.chpl:362-371`:
    device-resident lbound1/lbound2 copies): ``ptm_t`` (n, m) job-major
    processing times, ``min_heads`` (m,) and ``min_tails`` (m,), all int32
    and contiguous — the layout the CUDA kernels read — and ``johnson``,
    the lb2 tables (`JohnsonTables`), or None when the tables were built
    for lb1 or lb1_d."""

    def __init__(self, ptm_t: torch.Tensor, min_heads: torch.Tensor,
                 min_tails: torch.Tensor,
                 johnson: JohnsonTables | None = None):
        n, m = ptm_t.shape
        if min_heads.shape != (m,) or min_tails.shape != (m,):
            raise ValueError("min_heads/min_tails must have shape (m,)")
        self.ptm_t = ptm_t.to(torch.int32).contiguous()
        self.min_heads = min_heads.to(torch.int32).contiguous()
        self.min_tails = min_tails.to(torch.int32).contiguous()
        self.johnson = johnson

    @classmethod
    def from_lb1(cls, lb1_data, device, lb2_data=None) -> "PFSPDeviceTables":
        """The tables of one instance; with ``lb2_data`` (`bounds.LB2Data`)
        the Johnson tables too."""
        lb2 = {} if lb2_data is None else dict(
            pairs=lb2_data.pairs, lags=lb2_data.lags,
            johnson_schedules=lb2_data.johnson_schedules)
        return tables_from_numpy(
            np.ascontiguousarray(lb1_data.p_times.T),
            lb1_data.min_heads, lb1_data.min_tails, device, **lb2,
        )

    def mp_padded(self, mp: int):
        """``(pairs, lags, johnson_schedules)`` (numpy) with the pair axis
        padded to a multiple of ``mp`` with copies of pair 0 — the JAX
        tables' ``mp_padded`` (`tpu_tree_search/ops/pfsp_device.py:
        332-360`; max over pairs is idempotent, so a copy only re-maxes a
        value). Cached per mp."""
        J = self.johnson
        if J is None:
            raise ValueError("these tables have no lb2 part: the mp pair "
                             "axis splits the lb2 Johnson pair loop")
        with J.lock:
            got = J.padded.get(mp)
            # tts-lint: uncaptured (an mp program builds its pair blocks before it captures a cycle)
            if got is None:
                src = J.source
                pairs, lags, scheds = (src["pairs"], src["lags"],
                                       src["johnson_schedules"])
                P = pairs.shape[0]
                reps = -(-P // mp) * mp - P
                if reps:
                    pairs, lags, scheds = (
                        np.concatenate([a, np.repeat(a[:1], reps, 0)])
                        for a in (pairs, lags, scheds))
                got = J.padded[mp] = (pairs, lags, scheds)
        return got

    def pair_blocks(self, mp: int) -> list["PFSPDeviceTables"]:
        """The ``mp`` pair blocks of these tables: block i holds pairs
        ``[i * P_local, (i + 1) * P_local)`` of ``mp_padded(mp)``, the
        rows the JAX mp shard i slices (``start = i * P_local``), as
        tables of their own (the same ``ptm_t``, heads and tails; the
        block's Johnson tables and the kernels' packed copies of them), on
        which the lb2 bounds and their kernels take the block's pairs
        only. Cached per mp; ``mp = 1`` is these tables."""
        if mp == 1:
            return [self]
        pairs, lags, scheds = self.mp_padded(mp)
        J = self.johnson
        with J.lock:
            got = J.blocks.get(mp)
            # tts-lint: uncaptured (an mp program builds its pair blocks before it captures a cycle)
            if got is None:
                P_local = pairs.shape[0] // mp
                src = J.source
                got = J.blocks[mp] = [
                    PFSPDeviceTables(self.ptm_t, self.min_heads,
                                     self.min_tails, JohnsonTables(
                                         src["ptm_t"], src["min_tails"],
                                         pairs[sl], lags[sl], scheds[sl],
                                         self.device))
                    for sl in (slice(i * P_local, (i + 1) * P_local)
                               for i in range(mp))]
        return got

    @property
    def device(self) -> torch.device:
        return self.ptm_t.device

    @property
    def jobs(self) -> int:
        return self.ptm_t.shape[0]

    @property
    def machines(self) -> int:
        return self.ptm_t.shape[1]


def tables_from_numpy(ptm_t, min_heads, min_tails, device=None, pairs=None,
                      lags=None, johnson_schedules=None) -> PFSPDeviceTables:
    """Tables from the arrays of the JAX package's ``PFSPDeviceTables``
    (``ptm_t`` (n, m), ``min_heads``/``min_tails`` (m,)) given as numpy;
    with its ``pairs`` (P, 2), ``lags`` and ``johnson_schedules`` (P, n)
    the Johnson tables too."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

    johnson = (None if pairs is None else
               JohnsonTables(ptm_t, min_tails, pairs, lags, johnson_schedules,
                             dev))
    return PFSPDeviceTables(put(ptm_t), put(min_heads), put(min_tails), johnson)


def add_forward(front: torch.Tensor, pt_job: torch.Tensor) -> torch.Tensor:
    """One ``add_forward`` step over arbitrary leading axes (broadcasting):
    ``front``/``pt_job`` (..., m) -> the child front (..., m)."""
    m = pt_job.shape[-1]
    cols = [front[..., 0] + pt_job[..., 0]]
    for j in range(1, m):
        cols.append(torch.maximum(cols[-1], front[..., j]) + pt_job[..., j])
    return torch.stack(cols, dim=-1)


def machine_bound_from_parts(front, back, remain) -> torch.Tensor:
    """`machine_bound_from_parts` (`c_bound_simple.c:126-141`) over leading
    axes: front/remain (..., m), back (m,). Returns (...)."""
    m = front.shape[-1]
    tmp0 = front[..., 0] + remain[..., 0]
    lb = tmp0 + back[0]
    for i in range(1, m):
        tmp1 = torch.maximum(tmp0, front[..., i] + remain[..., i])
        lb = torch.maximum(lb, tmp1 + back[i])
        tmp0 = tmp1
    return lb


def parent_state(prmu: torch.Tensor, limit1: torch.Tensor,
                 tables: PFSPDeviceTables):
    """Per-parent precomputation of a chunk (`pfsp_device.py:101-131`).

    prmu (B, n) and limit1 (B,) of any integer dtype. Returns
    ``(front, remain, ptg)``: front (B, m) = schedule_front
    (`c_bound_simple.c:51-69`, ``min_heads`` at limit1 == -1), remain (B, m)
    = sum_unscheduled (`c_bound_simple.c:108-124`), ptg (B, n, m) the
    processing times gathered per position — all int32.
    """
    B, n = prmu.shape
    limit1 = limit1.to(torch.int32)
    ptg = tables.ptm_t[prmu.long()]  # (B, n, m)
    front = torch.zeros((B, tables.machines), dtype=torch.int32,
                        device=prmu.device)
    for i in range(n):
        newf = add_forward(front, ptg[:, i, :])
        front = torch.where((i <= limit1)[:, None], newf, front)
    front = torch.where((limit1 == -1)[:, None], tables.min_heads[None, :],
                        front)
    pos = torch.arange(n, dtype=torch.int32, device=prmu.device)
    unsched = (pos[None, :] >= (limit1 + 1)[:, None]).to(torch.int32)
    remain = torch.sum(ptg * unsched[:, :, None], dim=1, dtype=torch.int32)
    return front, remain, ptg


def lb1_chunk(prmu: torch.Tensor, limit1: torch.Tensor,
              tables: PFSPDeviceTables) -> torch.Tensor:
    """Plain lb1 of every child of every parent (`pfsp_device._lb1_chunk`).

    Child slot (i, k): the full `lb1_bound` of the parent with the job at
    position k appended to its prefix (`evaluate.cu:25-49`). Returns (B, n)
    int32; slots k <= limit1 are not children and are never read (the
    reference's untouched-slot convention).
    """
    front, remain, ptg = parent_state(prmu, limit1, tables)
    child_front = add_forward(front[:, None, :], ptg)  # (B, n, m)
    child_remain = remain[:, None, :] - ptg
    return machine_bound_from_parts(child_front, tables.min_tails,
                                    child_remain)


def lb1_d_chunk(prmu: torch.Tensor, limit1: torch.Tensor,
                tables: PFSPDeviceTables) -> torch.Tensor:
    """Plain lb1_d of every child of every parent (`pfsp_device._lb1_d_chunk`:
    `add_front_and_bound`, `c_bound_simple.c:213-244`; device
    `evaluate.cu:51-71`): O(m) per child slot from the parent's front and
    remaining work, one pass for all children. Returns (B, n) int32; slots
    k <= limit1 are not children and are never read."""
    front, remain, ptg = parent_state(prmu, limit1, tables)
    back = tables.min_tails
    f = front[:, None, :]  # (B, 1, m)
    r = remain[:, None, :]
    lb = f[..., 0] + r[..., 0] + back[0]  # (B, 1) -> broadcasts to (B, n)
    tmp0 = f[..., 0] + ptg[..., 0]  # (B, n)
    for i in range(1, tables.machines):
        tmp1 = torch.maximum(tmp0, f[..., i])
        lb = torch.maximum(lb, tmp1 + r[..., i] + back[i])
        tmp0 = tmp1 + ptg[..., i]
    return lb


def _johnson(tables: PFSPDeviceTables) -> JohnsonTables:
    if tables.johnson is None:
        raise ValueError("these tables have no lb2 part: build them for "
                         "lb='lb2' (PFSPDeviceTables.from_lb1 with lb2_data)")
    return tables.johnson


def _free_by_job(prmu: torch.Tensor, limit1: torch.Tensor) -> torch.Tensor:
    """(B, n) int32: 1 where job j is unscheduled (its position is past
    limit1) — `set_flags` (`c_bound_johnson.c:180-188`) inverted."""
    B, n = prmu.shape
    pos = torch.arange(n, device=prmu.device)
    unsched = (pos[None, :] >= (limit1.to(torch.int32) + 1)[:, None])
    return torch.zeros((B, n), dtype=torch.int32, device=prmu.device).scatter_(
        1, prmu.long(), unsched.to(torch.int32))


def johnson_bound(front: torch.Tensor, free: torch.Tensor,
                  J: JohnsonTables) -> torch.Tensor:
    """lb2 over leading axes from a schedule front (..., m) and the free-job
    flags by job id (..., n): for each pair the closed form of the Johnson
    recurrence (`pfsp_device._lb2_chunk` pair body), maxed over the pairs
    from 0. Returns (...) int32."""
    i32 = torch.int32
    h = J.host
    lb = torch.zeros(front.shape[:-1], dtype=i32, device=front.device)
    for q in range(J.pair_count):
        ma0, ma1 = (int(v) for v in h["pairs"][q])
        u_o = free[..., J.sched_long[q]]  # ordered free flags
        mp0 = u_o * J.p0_o[q]
        mp1 = u_o * J.p1_o[q]
        f0 = front[..., ma0]
        f1 = front[..., ma1]
        t0 = f0[..., None] + torch.cumsum(mp0, -1, dtype=i32)
        suf1 = torch.flip(torch.cumsum(torch.flip(mp1, (-1,)), -1, dtype=i32),
                          (-1,))
        a = torch.where(u_o > 0, t0 + J.lag_o[q] + suf1, NEG)
        tmp1 = torch.maximum(f1 + mp1.sum(-1, dtype=i32), a.amax(-1))
        tmp0 = f0 + mp0.sum(-1, dtype=i32)
        lb = torch.maximum(lb, torch.maximum(tmp1 + int(h["tails1"][q]),
                                             tmp0 + int(h["tails0"][q])))
    return lb


def lb2_chunk(prmu: torch.Tensor, limit1: torch.Tensor,
              tables: PFSPDeviceTables) -> torch.Tensor:
    """Plain lb2 of every child of every parent (`pfsp_device._lb2_chunk`;
    device `evaluate.cu:73-91`): child slot (i, k) appends the job at
    position k to the parent's prefix (one ``add_forward`` step) and frees
    every other unscheduled job. Returns (B, n) int32; slots k <= limit1
    are not children and are never read."""
    J = _johnson(tables)
    n = prmu.shape[1]
    front, _, ptg = parent_state(prmu, limit1, tables)
    child_front = add_forward(front[:, None, :], ptg)  # (B, n, m)
    onehot = torch.nn.functional.one_hot(prmu.long(), n).to(torch.int32)
    free = _free_by_job(prmu, limit1)[:, None, :] * (1 - onehot)  # (B, k, job)
    return johnson_bound(child_front, free, J)


def lb2_self_chunk(rows: torch.Tensor, limit1: torch.Tensor, n_active,
                   tables: PFSPDeviceTables) -> torch.Tensor:
    """Plain lb2 of each row's own partial schedule
    (`pfsp_device._lb2_self_chunk`: `lb2_bound` of the node itself).
    Returns (R,) int32. Only the first ``n_active`` rows are read by the
    caller; the plain version computes every row."""
    del n_active
    front, _, _ = parent_state(rows, limit1, tables)
    return johnson_bound(front, _free_by_job(rows, limit1), _johnson(tables))


def lb2_bounds_staged(prmu: torch.Tensor, limit1: torch.Tensor,
                      cand: torch.Tensor, tables: PFSPDeviceTables,
                      mp: int = 1, blocks=None, exchange=None) -> torch.Tensor:
    """lb2 child bounds of the candidate slots only
    (`pfsp_device.lb2_bounds_staged`).

    ``cand`` (B, n) marks open, non-leaf children whose lb1 is below the
    incumbent; lb2 >= lb1 pointwise, so the others are pruned under lb2 too.
    The candidates' flat indices are compacted to the front of an
    (R + 1)-row buffer, R = B*n (every other slot writes the spill row R,
    then dropped), each is materialised as its parent with positions
    limit1+1 and k swapped, the self bound runs on the first ``count``
    rows, and the results are gathered back. The count stays a device
    tensor: the self kernel reads it from device memory, so staging adds no
    host synchronisation. Under ``mp`` > 1 the self bound runs on the mp
    pair blocks (``lb2_self_bounds_mp``; a mesh copy's ``blocks`` and
    ``exchange``: each copy compacts on its own, and only the self bounds
    of the first ``count`` rows are exchanged). Returns (B, n) int32;
    slots outside ``cand`` are garbage."""
    B, n = prmu.shape
    R = B * n
    dev = prmu.device
    flat = cand.reshape(R)
    pos = torch.cumsum(flat, 0, dtype=torch.int32) - 1
    count = flat.sum(dtype=torch.int32)
    tgt = torch.where(flat, pos, R).long()
    src = torch.zeros(R + 1, dtype=torch.long, device=dev)
    src[tgt] = torch.arange(R, device=dev)
    src = src[:R]
    # Each parent's swap position, its children's limit1; clamped only for
    # a leaf parent, none of whose children is a candidate.
    d = (limit1.long() + 1).clamp(max=n - 1)[:, None]
    child = children_of(prmu, d)[src]
    out = lb2_self_bounds_mp(child, d[src // n, 0].to(prmu.dtype), count,
                             tables, mp, blocks, exchange)
    return out[torch.where(flat, pos, 0).long()].reshape(B, n)


def lb2_chunk_mp(prmu: torch.Tensor, limit1: torch.Tensor,
                 tables: PFSPDeviceTables, mp: int) -> torch.Tensor:
    """The plain version of ``lb2_bounds_mp``: ``lb2_chunk`` over each pair
    block, the planes combined by an elementwise max."""
    out = None
    for blk in tables.pair_blocks(mp):
        local = lb2_chunk(prmu, limit1, blk)
        out = local if out is None else torch.maximum(out, local)
    return out


def lb2_bounds_mp(prmu: torch.Tensor, limit1: torch.Tensor,
                  tables: PFSPDeviceTables, mp: int,
                  placed: list | None = None, blocks=None,
                  exchange=None) -> torch.Tensor:
    """lb2 child bounds with the Johnson pair loop split in ``mp`` pair
    blocks (`tpu_tree_search/ops/pfsp_device.py` ``lb2_bounds_mp``): each
    block (``pair_blocks``) is bounded on its own — kernel 6 on a pair
    block for a CUDA tensor (``lb2_kernel.lb2_block_cuda``), ``lb2_chunk``
    for a CPU one — and the planes are combined by an elementwise max, the
    counterpart of the JAX ``lax.pmax`` over the mp axis. Exact: the max
    over the blocks is the max over the pairs. ``placed`` (one tables
    object a block, default ``tables`` for each) places block i on the
    device of ``placed[i]``, the replica (d, i) of the JAX (dp, mp) mesh:
    the chunk is copied there and the block's plane back. A mesh copy
    (`parallel/resident_mesh.py`) bounds only its ``blocks`` (indices; on
    its own device's tables) and joins the other copies' planes through
    its ``exchange`` endpoint (`ops/pair_exchange.py`). ``mp = 1`` is
    ``lb2_bounds``."""
    if mp == 1 and placed is None and exchange is None:
        return lb2_bounds(prmu, limit1, tables)
    out = None
    where = placed or [tables] * mp
    for i in (range(mp) if blocks is None else blocks):
        blk = where[i].pair_blocks(mp)[i]
        dev = blk.device
        a, b = prmu.to(dev), limit1.to(dev)
        with route("lb2_block_cuda"):
            if a.is_cuda:
                from .lb2_kernel import lb2_block_cuda

                local = lb2_block_cuda(a, b, blk)
            else:
                local = lb2_chunk(a, b, blk)
        local = local.to(prmu.device)
        out = local if out is None else torch.maximum(out, local)
    return out if exchange is None else exchange(out)


def lb2_self_bounds_mp(rows: torch.Tensor, limit1: torch.Tensor, n_active,
                       tables: PFSPDeviceTables, mp: int, blocks=None,
                       exchange=None) -> torch.Tensor:
    """Self lb2 with the pair loop split in ``mp`` pair blocks
    (`tpu_tree_search/ops/pfsp_device.py` ``lb2_self_bounds_mp``, the
    staged evaluator's second stage under mp): kernel 7 on each block for
    a CUDA tensor (``lb2_self_kernel.lb2_self_block_cuda``),
    ``lb2_self_chunk`` for a CPU one, combined by an elementwise max; a
    mesh copy's ``blocks`` and ``exchange`` as ``lb2_bounds_mp``'s (the
    first ``n_active`` words exchanged). Only the first ``n_active``
    entries are meant to be read. ``mp = 1`` is ``lb2_self_bounds``."""
    if mp == 1 and exchange is None:
        return lb2_self_bounds(rows, limit1, n_active, tables)
    out = None
    pair_blocks = tables.pair_blocks(mp)
    for i in (range(mp) if blocks is None else blocks):
        blk = pair_blocks[i]
        with route("lb2_self_block_cuda"):
            if rows.is_cuda:
                from .lb2_self_kernel import lb2_self_block_cuda

                local = lb2_self_block_cuda(rows, limit1, n_active, blk)
            else:
                local = lb2_self_chunk(rows, limit1, n_active, blk)
        out = local if out is None else torch.maximum(out, local)
    return out if exchange is None else exchange(out, n_active)


def lb2_bounds(prmu: torch.Tensor, limit1: torch.Tensor,
               tables: PFSPDeviceTables) -> torch.Tensor:
    """lb2 child bounds routed like ``lb1_bounds``: the CUDA kernel
    (`ops/lb2_kernel.py`) for a CUDA tensor, ``lb2_chunk`` for a CPU
    tensor."""
    with route("lb2_bounds_cuda"):
        if prmu.is_cuda:
            from .lb2_kernel import lb2_bounds_cuda

            return lb2_bounds_cuda(prmu, limit1, tables)
        return lb2_chunk(prmu, limit1, tables)


def lb2_self_bounds(rows: torch.Tensor, limit1: torch.Tensor, n_active,
                    tables: PFSPDeviceTables) -> torch.Tensor:
    """Self lb2 of (R, n) rows, of which the first ``n_active`` (an int or
    a 0-d int32 tensor on the rows' device) are read: the CUDA kernel
    (`ops/lb2_self_kernel.py`) for a CUDA tensor, ``lb2_self_chunk`` for a
    CPU tensor."""
    with route("lb2_self_bounds_cuda"):
        if rows.is_cuda:
            from .lb2_self_kernel import lb2_self_bounds_cuda

            return lb2_self_bounds_cuda(rows, limit1, n_active, tables)
        return lb2_self_chunk(rows, limit1, n_active, tables)


def lb1_bounds(prmu: torch.Tensor, limit1: torch.Tensor,
               tables: PFSPDeviceTables) -> torch.Tensor:
    """lb1 child bounds routed by device: a CUDA tensor goes to the CUDA
    kernel (`ops/lb1_kernel.py`, which launches or raises), a CPU tensor to
    the plain ``lb1_chunk``."""
    with route("lb1_bounds_cuda"):
        if prmu.is_cuda:
            from .lb1_kernel import lb1_bounds_cuda

            return lb1_bounds_cuda(prmu, limit1, tables)
        return lb1_chunk(prmu, limit1, tables)


def lb1_d_bounds(prmu: torch.Tensor, limit1: torch.Tensor,
                 tables: PFSPDeviceTables) -> torch.Tensor:
    """lb1_d child bounds routed like ``lb1_bounds``: the CUDA kernel
    (`ops/lb1_d_kernel.py`) for a CUDA tensor, ``lb1_d_chunk`` for a CPU
    tensor."""
    with route("lb1_d_bounds_cuda"):
        if prmu.is_cuda:
            from .lb1_d_kernel import lb1_d_bounds_cuda

            return lb1_d_bounds_cuda(prmu, limit1, tables)
        return lb1_d_chunk(prmu, limit1, tables)


# -- program contracts (`check`, analysis/contracts.py) ------------------------

from ..analysis.contracts import contract  # noqa: E402


@contract(
    "lb2-pair-blocks-one-launch",
    claim="under --mp the lb2 child and self evaluators run each pair block "
          "as ONE launch of kernel 6 (lb2_block_cuda) or kernel 7 "
          "(lb2_self_block_cuda), the planes maxed, with no loop over the "
          "machine pairs in the glue: the record's launches are mp and its "
          "operations do not grow with the pair count (mp = 1 is one "
          "lb2_bounds_cuda or lb2_self_bounds_cuda launch); a mesh copy "
          "launches its own blocks only, then ONE pair exchange "
          "(pair_exchange_cuda) with its peers",
    artifact="pair-blocks",
)
def _contract_pair_blocks(art, cell):
    mp = art["mp"]
    blocks = art.get("blocks")
    launches = mp if blocks is None else len(blocks)
    out = []
    for kind, one, block in (("child", "lb2_bounds_cuda", "lb2_block_cuda"),
                             ("self", "lb2_self_bounds_cuda",
                              "lb2_self_block_cuda")):
        entries = art[kind]
        routes = [e.name for e in entries if e.kind == "route"]
        want = [one] if mp == 1 else [block] * launches
        if art.get("exchange"):
            want = want + ["pair_exchange_cuda"]
        if routes != want:
            out.append(f"{kind} at mp={mp}: launches {routes}, want {want}")
        ops = [e for e in entries if e.kind != "route"]
        if len(ops) > 4 * mp:
            out.append(f"{kind} at mp={mp}: {len(ops)} operations around "
                       f"the launches over {art['pairs']} pairs (a per-pair "
                       "loop?)")
    return out
