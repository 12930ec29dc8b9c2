"""PFSP (Permutation Flowshop Scheduling) as a Branch-and-Bound Problem plugin
— the port's counterpart of `tpu_tree_search/problems/pfsp/problem.py`.

Node and branching semantics mirror the reference exactly (golden-count
parity):
  * node = (depth, limit1, prmu); jobs prmu[0..limit1] are the fixed prefix;
    forward branching swaps prmu[depth] <=> prmu[i] for i in limit1+1..jobs-1
    (`lib/pfsp/PFSP_node.chpl:9-36`, `pfsp_chpl.chpl:88-113`);
  * a child with depth == jobs is a leaf: counted into exploredSol at
    generation, never pushed; it updates the incumbent if its bound (== its
    makespan) beats it (`pfsp_chpl.chpl:100-111`);
  * a non-leaf child is pushed (and counted into exploredTree) iff
    ``lowerbound < best`` strictly (`pfsp_chpl.chpl:106-111`);
  * initial incumbent = known optimum (ub=1) or +inf (ub=0)
    (`pfsp_chpl.chpl:40`).
"""

from __future__ import annotations

import threading

import numpy as np

from ..base import INF_BOUND, DecomposeResult, NodeBatch, Problem
from . import bounds as B
from . import taillard

ALLOWED_LOWER_BOUNDS = ("lb1", "lb1_d", "lb2")


class PFSPProblem(Problem):
    name = "pfsp"
    # The device pool's two columns: the (C, n) rows and the (C,) scalar.
    vals_field = "prmu"
    aux_field = "limit1"

    def __init__(
        self,
        inst: int = 14,
        lb: str = "lb1",
        ub: int = 1,
        p_times: np.ndarray | None = None,
        lb2_variant: str = "full",
    ):
        """``p_times`` overrides the Taillard instance (for reduced test
        instances); then ``ub`` must be 0 (no table optimum exists).
        ``lb2_variant`` selects the Johnson machine-pair subset
        (`bounds.LB2_VARIANTS`). The host and device paths serve every
        bound.
        """
        if lb not in ALLOWED_LOWER_BOUNDS:
            raise ValueError("Error - Unsupported lower bound")
        if ub not in (0, 1):
            raise ValueError("Error: unsupported upper bound initialization")
        if lb2_variant not in B.LB2_VARIANTS:
            raise ValueError(
                f"Error - Unsupported lb2 variant: {lb2_variant!r} "
                f"(choose from {B.LB2_VARIANTS})"
            )
        if p_times is None:
            if not (1 <= inst <= 120):
                raise ValueError("Error: unsupported Taillard's instance")
            p_times = taillard.processing_times(inst)
            self.initial_ub = taillard.best_ub(inst) if ub == 1 else INF_BOUND
            self.inst = inst
        else:
            if ub != 0:
                raise ValueError("custom instances have no table optimum; use ub=0")
            self.initial_ub = INF_BOUND
            self.inst = None
        self.lb = lb
        self.ub = ub
        self.lb2_variant = lb2_variant
        self.jobs = int(p_times.shape[1])
        self.machines = int(p_times.shape[0])
        self.child_slots = self.jobs
        self.lb1_data = B.make_lb1(p_times)
        self.lb2_data = B.make_lb2(self.lb1_data, lb2_variant)
        self._tables_lock = threading.Lock()
        self._device_tables: dict = {}  # guarded-by: _tables_lock

    def field_specs(self):
        # prmu holds job indices < jobs (int8 through 127 jobs, int16
        # through the ta111-class n=500); depth/limit1 are bounded by
        # jobs (limit1 >= -1), so int16 always fits.
        prmu_narrow = np.int8 if self.jobs <= 127 else np.int16
        return {
            "depth": ((), np.dtype(np.int32), np.dtype(np.int16)),
            "limit1": ((), np.dtype(np.int32), np.dtype(np.int16)),
            "prmu": ((self.jobs,), np.dtype(np.int32), np.dtype(prmu_narrow)),
        }

    def root(self) -> NodeBatch:
        fields = self.node_fields()
        return {
            "depth": np.zeros((1,), dtype=fields["depth"][1]),
            "limit1": np.full((1,), -1, dtype=fields["limit1"][1]),
            "prmu": np.arange(self.jobs, dtype=fields["prmu"][1])[None, :],
        }

    # -- host path ---------------------------------------------------------

    def _child_bound(self, child_prmu, child_limit1: int, best: int) -> int:
        if self.lb == "lb2":
            return B.lb2_bound(
                self.lb1_data, self.lb2_data, child_prmu, child_limit1, self.jobs, best
            )
        return B.lb1_bound(self.lb1_data, child_prmu, child_limit1, self.jobs)

    def decompose(self, node: dict, best: int) -> DecomposeResult:
        """One-node evaluate + branch (`pfsp_chpl.chpl:88-188`)."""
        if self.lb == "lb1_d":
            return self._decompose_lb1_d(node, best)
        depth = int(node["depth"])
        limit1 = int(node["limit1"])
        prmu = node["prmu"]
        jobs = self.jobs
        kept_prmu: list[np.ndarray] = []
        sol_inc = 0
        tree_inc = 0
        for i in range(limit1 + 1, jobs):
            child = prmu.copy()
            child[depth], child[i] = child[i], child[depth]
            lowerbound = self._child_bound(child, limit1 + 1, best)
            if depth + 1 == jobs:  # leaf
                sol_inc += 1
                if lowerbound < best:
                    best = lowerbound
            elif lowerbound < best:
                kept_prmu.append(child)
                tree_inc += 1
        return DecomposeResult(self._children(kept_prmu, depth, limit1), tree_inc, sol_inc, best)

    def _decompose_lb1_d(self, node: dict, best: int) -> DecomposeResult:
        """One `lb1_children_bounds` pass for all children
        (`pfsp_chpl.chpl:115-145`).
        """
        depth = int(node["depth"])
        limit1 = int(node["limit1"])
        prmu = node["prmu"]
        jobs = self.jobs
        lb_begin = B.lb1_children_bounds(self.lb1_data, prmu, limit1, jobs)
        kept_prmu: list[np.ndarray] = []
        sol_inc = 0
        tree_inc = 0
        for i in range(limit1 + 1, jobs):
            job = int(prmu[i])
            lowerbound = int(lb_begin[job])
            if depth + 1 == jobs:  # leaf
                sol_inc += 1
                if lowerbound < best:
                    best = lowerbound
            elif lowerbound < best:
                child = prmu.copy()
                child[depth], child[i] = child[i], child[depth]
                kept_prmu.append(child)
                tree_inc += 1
        return DecomposeResult(self._children(kept_prmu, depth, limit1), tree_inc, sol_inc, best)

    def _children(self, kept_prmu: list, depth: int, limit1: int) -> NodeBatch:
        k = len(kept_prmu)
        fields = self.node_fields()
        prmu_dt = fields["prmu"][1]
        return {
            "depth": np.full(k, depth + 1, dtype=fields["depth"][1]),
            "limit1": np.full(k, limit1 + 1, dtype=fields["limit1"][1]),
            "prmu": (
                np.stack(kept_prmu).astype(prmu_dt)
                if kept_prmu
                else np.zeros((0, self.jobs), dtype=prmu_dt)
            ),
        }

    # -- native host runtime -----------------------------------------------

    def _make_native(self, lib):
        from ...native import NativePFSP

        return NativePFSP(lib, self.lb1_data, self.lb2_data, self.lb)

    def native_sequential(self, best: int):
        nat = self._native()
        return None if nat is None else nat.sequential(best)

    def native_warmup(self, batch: NodeBatch, best: int, target: int):
        nat = self._native()
        return None if nat is None else nat.warmup(batch, best, target)

    def native_drain(self, batch: NodeBatch, best: int):
        nat = self._native()
        return None if nat is None else nat.drain(batch, best)

    # -- device path -------------------------------------------------------

    def device_tables(self, device):
        """The instance tables on ``device`` (a ``torch.device``), built
        once per device and shared by every program of this problem; under
        lb2 with the Johnson tables of ``lb2_variant`` (an lb1 or lb1_d
        problem does not build them).

        Built under a lock by the first thread that asks, on its current
        stream; on the card that stream is synchronised before the tables
        are published, so a kernel that reads them on any other stream
        (the multi-device tier gives each worker its own) comes after the
        copy. Every lookup takes the lock."""
        key = str(device)
        from ...ops.pfsp_device import PFSPDeviceTables

        with self._tables_lock:
            tables = self._device_tables.get(key)
            # tts-lint: uncaptured (a program builds its device's tables before it captures a cycle)
            if tables is None:
                tables = PFSPDeviceTables.from_lb1(
                    self.lb1_data, device,
                    self.lb2_data if self.lb == "lb2" else None,
                )
                if tables.device.type == "cuda":
                    import torch

                    torch.cuda.current_stream(tables.device).synchronize()
                self._device_tables[key] = tables
        return tables

    def device_bounds(self, prmu, limit1):
        """(B, n) int32 child bounds of a device chunk under ``self.lb``
        (the CUDA kernel for CUDA tensors, the plain version for CPU
        tensors)."""
        from ...ops import pfsp_device as P

        fns = {"lb1": P.lb1_bounds, "lb1_d": P.lb1_d_bounds,
               "lb2": P.lb2_bounds}
        return fns[self.lb](prmu, limit1, self.device_tables(prmu.device))

    def generate_children(
        self, parents: NodeBatch, count: int, results: np.ndarray, best: int
    ) -> DecomposeResult:
        """Vectorized prune/branch from device bounds
        (`pfsp_gpu_chpl.chpl:273-303`). Children are emitted in the
        reference's (parent, slot) ascending order. Within a chunk the
        incumbent used for pruning is the chunk-entry one folded with the
        chunk's leaf makespans — identical to the reference's sequential
        in-chunk updates whenever ub=1 (the incumbent never improves).
        """
        nat = self._native()
        if nat is not None:
            children, tree_inc, sol_inc, best = nat.generate_children(
                parents, count, np.asarray(results), best)
            return DecomposeResult(children, tree_inc, sol_inc, best)
        jobs = self.jobs
        depth = parents["depth"][:count].astype(np.int64)
        limit1 = parents["limit1"][:count].astype(np.int64)
        prmu = parents["prmu"][:count]
        bnds = np.asarray(results[:count]).astype(np.int64)  # (count, jobs)
        j = np.arange(jobs)[None, :]
        open_slot = j >= (limit1[:, None] + 1)
        is_leaf_child = (depth[:, None] + 1 == jobs) & open_slot
        sol_inc = int(is_leaf_child.sum())
        leaf_bounds = bnds[is_leaf_child]
        if leaf_bounds.size:
            best = min(best, int(leaf_bounds.min()))
        keep = open_slot & ~is_leaf_child & (bnds < best)
        pi, kj = np.nonzero(keep)
        child_prmu = prmu[pi].copy()
        rows = np.arange(pi.size)
        di = depth[pi]
        tmp = child_prmu[rows, di].copy()
        child_prmu[rows, di] = child_prmu[rows, kj]
        child_prmu[rows, kj] = tmp
        fields = self.node_fields()
        children = {
            "depth": (depth[pi] + 1).astype(fields["depth"][1]),
            "limit1": (limit1[pi] + 1).astype(fields["limit1"][1]),
            "prmu": child_prmu.astype(fields["prmu"][1]),
        }
        return DecomposeResult(children, int(pi.size), sol_inc, best)
