"""N-Queens as a backtracking Problem plugin — the port's copy of
`tpu_tree_search/problems/nqueens.py`.

Semantics mirror the reference exactly (golden-count parity):
  * node = (depth, board) where board is a permutation of rows; columns
    0..depth-1 are placed, the rest are candidates
    (`lib/nqueens/NQueens_node.chpl:9-31`);
  * branching swaps board[depth] <=> board[j] for each safe j >= depth
    (`nqueens_chpl.chpl:70-89`);
  * a node popped at depth == N counts one solution; children are counted
    into exploredTree when pushed — including depth-N leaves
    (`nqueens_chpl.chpl:74-86`);
  * the safety check runs ``g`` redundant rounds as an artificial workload
    knob (`nqueens_chpl.chpl:51-67`, `README.md:67-68`).

On the device the node splits into the pool's two columns: ``board`` (the
rows) and ``depth`` (the one scalar); ``device_bounds`` is the (B, N) label
plane of `ops/nqueens_device.py`.
"""

from __future__ import annotations

import numpy as np

from .base import DecomposeResult, NodeBatch, Problem

#: The widest board: a uint8 board holds the rows 0..255.
MAX_N = 256


class NQueensProblem(Problem):
    name = "nqueens"
    # The device pool's two columns: the (C, N) rows and the (C,) scalar.
    vals_field = "board"
    aux_field = "depth"

    def __init__(self, N: int = 14, g: int = 1):
        if N <= 0 or g <= 0:
            raise ValueError("All parameters must be positive integers.")
        if N > MAX_N:
            raise ValueError(f"N = {N}: the board is uint8, so N <= {MAX_N}")
        self.N = int(N)
        self.g = int(g)
        self.child_slots = self.N

    def field_specs(self):
        # board is 1-byte; depth is bounded by N, so int16 always fits.
        return {
            "depth": ((), np.dtype(np.int32), np.dtype(np.int16)),
            "board": ((self.N,), np.dtype(np.uint8), np.dtype(np.uint8)),
        }

    def root(self) -> NodeBatch:
        depth_dt = self.node_fields()["depth"][1]
        return {
            "depth": np.zeros((1,), dtype=depth_dt),
            "board": np.arange(self.N, dtype=np.uint8)[None, :],
        }

    # -- host path ---------------------------------------------------------

    def is_safe(self, board: np.ndarray, queen_num: int, row_pos: int) -> bool:
        """Diagonal-safety check (`nqueens_chpl.chpl:51-67`). The ``g`` loop
        only repeats the same comparisons (workload knob), so one round
        decides the label.
        """
        if queen_num == 0:
            return True
        i = np.arange(queen_num)
        other = board[:queen_num].astype(np.int64)
        d = queen_num - i
        return bool(np.all((other != row_pos - d) & (other != row_pos + d)))

    def decompose(self, node: dict, best: int) -> DecomposeResult:
        depth = int(node["depth"])
        board = node["board"]
        N = self.N
        if depth == N:
            return DecomposeResult(self.empty_batch(0), 0, 1, best)
        kept = []
        for j in range(depth, N):
            if self.is_safe(board, depth, int(board[j])):
                child = board.copy()
                child[depth], child[j] = child[j], child[depth]
                kept.append(child)
        children = {
            "depth": np.full(len(kept), depth + 1,
                             dtype=self.node_fields()["depth"][1]),
            "board": (
                np.stack(kept) if kept else np.zeros((0, N), dtype=np.uint8)
            ),
        }
        return DecomposeResult(children, len(kept), 0, best)

    # -- native host runtime -----------------------------------------------

    def _make_native(self, lib):
        from ..native import NativeNQueens

        return NativeNQueens(lib, self.N, self.g)

    def native_sequential(self, best: int):
        nat = self._native()
        if nat is None:
            return None
        tree, sol = nat.sequential()
        return tree, sol, best

    def native_warmup(self, batch: NodeBatch, best: int, target: int):
        nat = self._native()
        if nat is None:
            return None
        frontier, tree, sol = nat.warmup(batch, target)
        return frontier, tree, sol, best

    def native_drain(self, batch: NodeBatch, best: int):
        nat = self._native()
        if nat is None:
            return None
        tree, sol = nat.drain(batch)
        return tree, sol, best

    # -- device path -------------------------------------------------------

    def device_bounds(self, board, depth):
        """(B, N) uint8 safety labels of a device chunk (the CUDA kernel for
        CUDA tensors, the plain version for CPU tensors)."""
        from ..ops.nqueens_device import nqueens_labels

        return nqueens_labels(board, depth, self.N, self.g)

    def generate_children(
        self, parents: NodeBatch, count: int, results: np.ndarray, best: int
    ) -> DecomposeResult:
        """Vectorized equivalent of `nqueens_gpu_chpl.chpl:126-149`."""
        nat = self._native()
        if nat is not None:
            children, tree_inc, sol_inc = nat.generate_children(
                parents, count, np.asarray(results))
            return DecomposeResult(children, tree_inc, sol_inc, best)
        N = self.N
        depth = parents["depth"][:count].astype(np.int64)
        board = parents["board"][:count]
        labels = np.asarray(results[:count]).astype(bool)  # (count, N)
        k = np.arange(N)[None, :]
        is_parent_leaf = depth == N
        sol_inc = int(is_parent_leaf.sum())
        mask = labels & (k >= depth[:, None]) & ~is_parent_leaf[:, None]
        pi, kj = np.nonzero(mask)
        children_board = board[pi].copy()
        rows = np.arange(pi.size)
        di = depth[pi].astype(np.int64)
        tmp = children_board[rows, di]
        children_board[rows, di] = children_board[rows, kj]
        children_board[rows, kj] = tmp
        children = {
            "depth": (depth[pi] + 1).astype(self.node_fields()["depth"][1]),
            "board": children_board,
        }
        return DecomposeResult(children, int(pi.size), sol_inc, best)
