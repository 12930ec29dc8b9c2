"""Host phases of the device tier and the chunk offloader — the parts of
`tpu_tree_search/engine/device.py` the resident engine needs:

  step 1  host BFS warm-up: pop-front + host decompose until the pool holds
          at least ``target`` nodes (`nqueens_gpu_chpl.chpl:169-175`);
  step 3  host DFS drain of the remainder (`nqueens_gpu_chpl.chpl:230-236`);
  the offloader evaluates host-popped chunks on the device for the resident
  engine's capacity-stall fallback.

The JAX module's shape bucketing (``bucket_size``/``pad_chunk``) has no
counterpart: PyTorch runs eagerly and compiles nothing per chunk shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pool.pool import SoAPool
from ..problems.base import Problem, batch_length, index_batch
from .results import Diagnostics


class DeviceOffloader:
    """Evaluates host chunks on one device through the problem's device
    evaluator (``problem.device_bounds``: the lb1 or lb1_d bound for PFSP,
    the safety labels for N-Queens — the CUDA kernel for a CUDA device):
    H2D of the chunk's two pool columns in the resident pool's storage
    types, the evaluator, D2H of the result plane. Counts launches/copies
    like Chapel's GpuDiagnostics (`pfsp_gpu_chpl.chpl:454-466`)."""

    def __init__(self, problem: Problem, device: torch.device,
                 vals_dtype: torch.dtype, aux_dtype: torch.dtype):
        self.problem = problem
        self.device = device
        self.vals_dtype = vals_dtype
        self.aux_dtype = aux_dtype
        self.diagnostics = Diagnostics()

    def evaluate(self, parents: dict, count: int) -> np.ndarray:
        """(count, width) result plane of ``parents[:count]``."""
        p = self.problem

        def put(name, dtype):
            col = np.ascontiguousarray(parents[name][:count])
            return torch.from_numpy(col).to(self.device).to(dtype)

        vals = put(p.vals_field, self.vals_dtype)
        aux = put(p.aux_field, self.aux_dtype)
        self.diagnostics.host_to_device += 1
        out = p.device_bounds(vals, aux)
        self.diagnostics.kernel_launches += 1
        out = out.cpu().numpy()
        self.diagnostics.device_to_host += 1
        return out


def warmup(problem: Problem, pool: SoAPool, best: int, target: int):
    """Step 1: breadth-first host expansion until ``pool.size >= target``.
    Pops from the *front* so the leftover pool is shallow-first.
    Returns (tree_inc, sol_inc, best)."""
    tree = 0
    sol = 0
    while pool.size > 0 and pool.size < target:
        node = pool.pop_front()
        res = problem.decompose(node, best)
        tree += res.tree_inc
        sol += res.sol_inc
        best = res.best
        pool.push_back_bulk(res.children)
    return tree, sol, best


def drain(problem: Problem, pool: SoAPool, best: int):
    """Step 3: host DFS of whatever is left. Returns (tree, sol, best)."""
    tree = 0
    sol = 0
    while True:
        node = pool.pop_back()
        if node is None:
            break
        res = problem.decompose(node, best)
        tree += res.tree_inc
        sol += res.sol_inc
        best = res.best
        for i in range(batch_length(res.children)):
            pool.push_back(index_batch(res.children, i))
    return tree, sol, best
