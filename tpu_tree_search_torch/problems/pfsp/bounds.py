"""PFSP lower bounds — numpy oracle implementations.

These are the *semantic anchors* for the framework: straightforward integer
re-implementations of the canonical C bound library of the reference
(`baselines/pfsp/lib/c_bound_simple.c`, `baselines/pfsp/lib/c_bound_johnson.c`).
This is the PyTorch port's own copy of the JAX package's oracle module; the
port's torch bounds and CUDA kernels are tested against it on random
permutations/prefixes.

Where the reference's Chapel port diverges from the C library, we follow the
C semantics (SURVEY.md §7.3 "parity traps": the Chapel `fill_min_heads_tails`
min-heads accumulation bug at `Bound_simple.chpl:271` is NOT reproduced; cf.
correct C at `c_bound_simple.c:278-322`).

Conventions (match the C library):
  * ``p_times`` is ``(machines, jobs)`` int — ``p_times[machine, job]``.
  * ``prmu`` is a permutation of ``0..jobs-1``; jobs ``prmu[0..limit1]`` form
    the fixed prefix ("scheduled at the front"); jobs ``prmu[limit2..]`` the
    fixed suffix. Forward branching only, so ``limit2 == jobs`` everywhere in
    the search (`pfsp_chpl.chpl:23-26`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# ---------------------------------------------------------------------------
# lb1 — one-machine bound (c_bound_simple.c)
# ---------------------------------------------------------------------------


@dataclass
class LB1Data:
    """Per-instance tables for lb1 (`c_bound_simple.h:14-21`)."""

    p_times: np.ndarray  # (machines, jobs) int32
    min_heads: np.ndarray  # (machines,) int32 — min start times per machine
    min_tails: np.ndarray  # (machines,) int32 — min run-out times per machine

    @property
    def jobs(self) -> int:
        return self.p_times.shape[1]

    @property
    def machines(self) -> int:
        return self.p_times.shape[0]


def make_lb1(p_times: np.ndarray) -> LB1Data:
    """Build lb1 tables: `fill_min_heads_tails`, `c_bound_simple.c:277-322`.

    min_heads[k] = min over jobs of the earliest time machine k could start
    (head of the job on machines 0..k-1); 0 on machine 0. min_tails[k] = min
    over jobs of the run-out after machine k; 0 on the last machine.
    """
    p = np.asarray(p_times, dtype=np.int64)
    m, n = p.shape
    heads = np.cumsum(p, axis=0)  # heads[k, j] = sum of p[0..k, j]
    min_heads = np.empty(m, dtype=np.int64)
    min_heads[0] = 0
    if m > 1:
        # tmp[k-1] after the forward pass == cumulative head up to machine k-1
        min_heads[1:] = heads[:-1, :].min(axis=1)
    tails = np.cumsum(p[::-1, :], axis=0)[::-1, :]  # tails[k, j] = sum p[k.., j]
    min_tails = np.empty(m, dtype=np.int64)
    min_tails[m - 1] = 0
    if m > 1:
        min_tails[:-1] = tails[1:, :].min(axis=1)
    return LB1Data(
        p_times=np.asarray(p_times, dtype=np.int32),
        min_heads=min_heads.astype(np.int32),
        min_tails=min_tails.astype(np.int32),
    )


def add_forward(job: int, p: np.ndarray, front: np.ndarray) -> None:
    """Extend the head schedule by one job (`c_bound_simple.c:31-38`)."""
    m = p.shape[0]
    front[0] += p[0, job]
    for j in range(1, m):
        front[j] = max(front[j - 1], front[j]) + p[j, job]


def add_backward(job: int, p: np.ndarray, back: np.ndarray) -> None:
    """Extend the tail schedule by one job (`c_bound_simple.c:40-49`)."""
    m = p.shape[0]
    back[m - 1] += p[m - 1, job]
    for j in range(m - 2, -1, -1):
        back[j] = max(back[j], back[j + 1]) + p[j, job]


def schedule_front(d: LB1Data, prmu, limit1: int) -> np.ndarray:
    """Completion times of the fixed prefix per machine (`c_bound_simple.c:51-69`)."""
    if limit1 == -1:
        return d.min_heads.astype(np.int64)
    front = np.zeros(d.machines, dtype=np.int64)
    p = d.p_times
    for i in range(limit1 + 1):
        add_forward(int(prmu[i]), p, front)
    return front


def schedule_back(d: LB1Data, prmu, limit2: int) -> np.ndarray:
    """Tail times of the fixed suffix per machine (`c_bound_simple.c:71-90`)."""
    if limit2 == d.jobs:
        return d.min_tails.astype(np.int64)
    back = np.zeros(d.machines, dtype=np.int64)
    p = d.p_times
    for k in range(d.jobs - 1, limit2 - 1, -1):
        add_backward(int(prmu[k]), p, back)
    return back


def eval_solution(d: LB1Data, prmu) -> int:
    """Makespan of a complete permutation (`c_bound_simple.c:92-106`)."""
    tmp = np.zeros(d.machines, dtype=np.int64)
    for i in range(d.jobs):
        add_forward(int(prmu[i]), d.p_times, tmp)
    return int(tmp[d.machines - 1])


def sum_unscheduled(d: LB1Data, prmu, limit1: int, limit2: int) -> np.ndarray:
    """Total remaining work per machine (`c_bound_simple.c:108-124`)."""
    mid = np.asarray(prmu[limit1 + 1 : limit2], dtype=np.int64)
    if mid.size == 0:
        return np.zeros(d.machines, dtype=np.int64)
    return d.p_times[:, mid].astype(np.int64).sum(axis=1)


def machine_bound_from_parts(front, back, remain) -> int:
    """Chain the per-machine head+remain+tail bound (`c_bound_simple.c:126-141`)."""
    m = len(front)
    tmp0 = int(front[0]) + int(remain[0])
    lb = tmp0 + int(back[0])
    for i in range(1, m):
        tmp1 = max(tmp0, int(front[i]) + int(remain[i]))
        lb = max(lb, tmp1 + int(back[i]))
        tmp0 = tmp1
    return lb


def lb1_bound(d: LB1Data, prmu, limit1: int, limit2: int) -> int:
    """The full one-machine bound (`c_bound_simple.c:143-158`)."""
    front = schedule_front(d, prmu, limit1)
    back = schedule_back(d, prmu, limit2)
    remain = sum_unscheduled(d, prmu, limit1, limit2)
    return machine_bound_from_parts(front, back, remain)


def add_front_and_bound(d: LB1Data, job: int, front, back, remain) -> int:
    """O(m) bound after placing ``job`` at the prefix end (`c_bound_simple.c:213-244`)."""
    m = d.machines
    p = d.p_times
    lb = int(front[0]) + int(remain[0]) + int(back[0])
    tmp0 = int(front[0]) + int(p[0, job])
    for i in range(1, m):
        tmp1 = max(tmp0, int(front[i]))
        lb = max(lb, tmp1 + int(remain[i]) + int(back[i]))
        tmp0 = tmp1 + int(p[i, job])
    return lb


def lb1_children_bounds(d: LB1Data, prmu, limit1: int, limit2: int) -> np.ndarray:
    """Bounds for *all* children in one pass, indexed by job id
    (`c_bound_simple.c:160-211`). Entries for already-fixed jobs are 0.
    """
    front = schedule_front(d, prmu, limit1)
    back = schedule_back(d, prmu, limit2)
    remain = sum_unscheduled(d, prmu, limit1, limit2)
    lb_begin = np.zeros(d.jobs, dtype=np.int64)
    for i in range(limit1 + 1, limit2):
        job = int(prmu[i])
        lb_begin[job] = add_front_and_bound(d, job, front, back, remain)
    return lb_begin


# ---------------------------------------------------------------------------
# lb2 — two-machine / Johnson bound (c_bound_johnson.c)
# ---------------------------------------------------------------------------


#: The reference's ``enum lb2_variant`` pair subsets (`Bound_johnson.chpl:6`,
#: `fill_machine_pairs` `:50-88`): ``full`` takes every (i, j) with i < j
#: (P = m(m-1)/2, the default of every reference tier); ``nabeshima`` the
#: adjacent pairs (i, i+1) [Nabeshima'67]; ``lageweg`` every machine paired
#: with the last, (i, m-1) [Lageweg'78] — both P = m-1. (LB2_LEARN reuses
#: the full pair set with a learned visit order; visit order only matters
#: for the early exit, which the TPU formulation drops, so it is not a
#: distinct table shape here.)
LB2_VARIANTS = ("full", "nabeshima", "lageweg")


def machine_pairs(m: int, variant: str = "full") -> list[tuple[int, int]]:
    """The `fill_machine_pairs` pair subsets, one list per variant."""
    if variant == "full":
        return [(i, j) for i in range(m - 1) for j in range(i + 1, m)]
    if variant == "nabeshima":
        return [(i, i + 1) for i in range(m - 1)]
    if variant == "lageweg":
        return [(i, m - 1) for i in range(m - 1)]
    raise ValueError(
        f"lb2_variant must be one of {LB2_VARIANTS}, got {variant!r}"
    )


@dataclass
class LB2Data:
    """Per-instance tables for lb2 (`c_bound_johnson.h:16-27`)."""

    pairs: np.ndarray  # (P, 2) int32 machine pairs (m1 < m2)
    lags: np.ndarray  # (P, jobs) int32 — q_iuv term [Lageweg'78]
    johnson_schedules: np.ndarray  # (P, jobs) int32 — job ids in Johnson order

    @property
    def nb_machine_pairs(self) -> int:
        return self.pairs.shape[0]


def make_lb2(d: LB1Data, variant: str = "full") -> LB2Data:
    """Build lb2 tables: machine pairs (`c_bound_johnson.c:48-91`, subset per
    ``variant`` — see `LB2_VARIANTS`), lags (`:94-109`), and per-pair
    Johnson-optimal schedules (`:147-178`).

    The Johnson sort uses a *stable* argsort on key (partition, ptm1 | -ptm2):
    partition 0 (ptm1 < ptm2) first by ascending ptm1, then partition 1 by
    descending ptm2 (`johnson_comp`, `c_bound_johnson.c:120-141`). The C
    qsort's tie order is unspecified; any fixed tie-break yields a valid
    Johnson schedule, and all tiers of this framework share this one.
    """
    p = d.p_times.astype(np.int64)
    m, n = p.shape
    pair_list = machine_pairs(m, variant)
    pairs = np.array(pair_list, dtype=np.int32).reshape(-1, 2)
    P = pairs.shape[0]

    heads = np.cumsum(p, axis=0)
    lags = np.empty((P, n), dtype=np.int64)
    for k, (m1, m2) in enumerate(pair_list):
        # sum of p[m1+1 .. m2-1, j]
        lags[k] = heads[m2 - 1] - heads[m1]

    schedules = np.empty((P, n), dtype=np.int32)
    for k, (m1, m2) in enumerate(pair_list):
        ptm1 = p[m1] + lags[k]
        ptm2 = p[m2] + lags[k]
        partition = (ptm1 >= ptm2).astype(np.int64)  # 0: ptm1 < ptm2
        key = np.where(partition == 0, ptm1, -ptm2)
        order = np.lexsort((key, partition))  # stable: partition major, key minor
        schedules[k] = order.astype(np.int32)

    return LB2Data(pairs=pairs, lags=lags.astype(np.int32), johnson_schedules=schedules)


def set_flags(prmu, limit1: int, limit2: int, n: int) -> np.ndarray:
    """1 for jobs fixed in prefix/suffix, 0 for free (`c_bound_johnson.c:180-188`)."""
    flags = np.zeros(n, dtype=np.int64)
    for j in range(limit1 + 1):
        flags[int(prmu[j])] = 1
    for j in range(limit2, n):
        flags[int(prmu[j])] = 1
    return flags


def _compute_cmax_johnson(
    p: np.ndarray, d2: LB2Data, flags, tmp0: int, tmp1: int, ma0: int, ma1: int, ind: int
) -> tuple[int, int]:
    """Johnson two-machine cmax of the free jobs with lags
    (`c_bound_johnson.c:190-209`). Returns (tmp0, tmp1).
    """
    n = p.shape[1]
    for j in range(n):
        job = int(d2.johnson_schedules[ind, j])
        if flags[job] == 0:
            lag = int(d2.lags[ind, job])
            tmp0 += int(p[ma0, job])
            tmp1 = max(tmp1, tmp0 + lag)
            tmp1 += int(p[ma1, job])
    return tmp0, tmp1


def lb_makespan(
    p: np.ndarray, d2: LB2Data, flags, front, back, min_cmax: int
) -> int:
    """Max over machine pairs, with early exit once the bound already prunes
    (`c_bound_johnson.c:211-237`). Pair visit order is index order
    (machine_pair_order is identity for LB2_FULL, `c_bound_johnson.c:61-69`).
    """
    lb = 0
    for i in range(d2.nb_machine_pairs):
        ma0 = int(d2.pairs[i, 0])
        ma1 = int(d2.pairs[i, 1])
        tmp0 = int(front[ma0])
        tmp1 = int(front[ma1])
        tmp0, tmp1 = _compute_cmax_johnson(p, d2, flags, tmp0, tmp1, ma0, ma1, i)
        tmp1 = max(tmp1 + int(back[ma1]), tmp0 + int(back[ma0]))
        lb = max(lb, tmp1)
        if lb > min_cmax:
            break
    return lb


def lb2_bound(
    d1: LB1Data, d2: LB2Data, prmu, limit1: int, limit2: int, best_cmax: int
) -> int:
    """The full two-machine bound (`c_bound_johnson.c:239-254`)."""
    front = schedule_front(d1, prmu, limit1)
    back = schedule_back(d1, prmu, limit2)
    flags = set_flags(prmu, limit1, limit2, d1.jobs)
    return lb_makespan(d1.p_times, d2, flags, front, back, best_cmax)
