"""Problem protocol — the plugin interface the engines are written against
(the port's copy of `tpu_tree_search/problems/base.py`).

A problem supplies:
  * an SoA node schema (fixed-size fields, narrow storage dtypes),
  * the root node,
  * host-side ``decompose`` (evaluate + branch one node) for the warm-up and
    drain phases of the device tier (`pfsp_chpl.chpl:88-172`),
  * device tables for the batched bound kernels (`problem.device_tables`),
  * vectorized host ``generate_children`` consuming device bounds
    (`pfsp_gpu_chpl.chpl:273-303`).

Node batches are plain dicts ``{field: np.ndarray[batch, ...]}`` (SoA). A
single node is the same dict with unbatched arrays.

The ``native_*`` hooks serve the host phases from the C++ runtime
(`native/`); each returns None under ``TTS_NATIVE=0``, and the caller then
takes the Python path, which stays the semantic oracle.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

# A node batch: field name -> array whose leading axis is the batch.
NodeBatch = dict[str, np.ndarray]


def narrow_mode() -> str:
    """``TTS_NARROW`` — narrow node storage dtypes (int8/int16 instead of
    int32) in the host pools. ``auto`` (default) narrows every field whose
    value range provably fits; ``0`` pins the int32 layout."""
    mode = os.environ.get("TTS_NARROW", "auto")
    if mode not in ("auto", "0"):
        raise ValueError(
            f"TTS_NARROW must be 'auto' or '0', got {mode!r}"
        )
    return mode


def narrow_enabled() -> bool:
    return narrow_mode() != "0"


# Guards the first build of a problem's native runtime (``Problem._native``):
# the multi-device tier's workers may ask for it at once.
_NATIVE_LOCK = threading.Lock()

# Sentinel "no incumbent" upper bound (C uses INT_MAX, `pfsp_c.c`; Chapel
# max(int)). Kept within int32 so device kernels can carry it.
INF_BOUND = 2**31 - 1


@dataclass
class DecomposeResult:
    children: NodeBatch  # surviving children, batch-first SoA
    tree_inc: int  # nodes pushed (exploredTree increment)
    sol_inc: int  # leaves visited (exploredSol increment)
    best: int  # possibly-improved incumbent


class Problem:
    """Interface; instantiated by `PFSPProblem` and `NQueensProblem`."""

    name: str = "problem"
    # Children slots per parent (== branching-factor upper bound): jobs for
    # PFSP, N for N-Queens. Device result slot [i*width + j] is child j of
    # parent i.
    child_slots: int
    # The node fields that form the device pool: the (C, width) rows and
    # the (C,) scalar column (PFSP: prmu/limit1; N-Queens: board/depth).
    vals_field: str
    aux_field: str

    def field_specs(
        self,
    ) -> Mapping[str, tuple[tuple[int, ...], np.dtype, np.dtype]]:
        """Field name -> (per-node shape, wide dtype, narrow storage dtype)."""
        raise NotImplementedError

    def node_fields(self) -> Mapping[str, tuple[tuple[int, ...], np.dtype]]:
        """Field name -> (per-node shape, storage dtype), with the
        ``TTS_NARROW`` knob resolved. Single source of truth for every
        host-side node buffer."""
        narrow = narrow_enabled()
        return {
            name: (shape, np.dtype(nd if narrow else wd))
            for name, (shape, wd, nd) in self.field_specs().items()
        }

    def root(self) -> NodeBatch:
        """Batch of one: the root node."""
        raise NotImplementedError

    def decompose(self, node: dict[str, Any], best: int) -> DecomposeResult:
        """Evaluate + branch one node on host (sequential-tier semantics)."""
        raise NotImplementedError

    def device_bounds(self, vals, aux):
        """The (B, width) device result plane of a chunk given as its two
        pool columns (torch tensors): child bounds or labels. Routed by the
        tensors' device: the CUDA kernel or the plain PyTorch version."""
        raise NotImplementedError

    def generate_children(
        self, parents: NodeBatch, count: int, results: np.ndarray, best: int
    ) -> DecomposeResult:
        """Vectorized host-side prune/branch from device results."""
        raise NotImplementedError

    # -- native host runtime (csrc/tts_native.cpp) -------------------------

    def _make_native(self, lib):
        """This problem's native runtime over the loaded library."""
        return None

    def _native(self):
        """The native runtime, or None under ``TTS_NATIVE=0``. Built at the
        first call; a failed build raises (`native.build`)."""
        if not hasattr(self, "_native_rt"):
            from .. import native

            with _NATIVE_LOCK:
                if not hasattr(self, "_native_rt"):
                    lib = native.load()
                    self._native_rt = (self._make_native(lib)
                                       if lib is not None else None)
        return self._native_rt

    def native_sequential(self, best: int):
        """Full sequential search -> (tree, sol, best) or None."""
        return None

    def native_warmup(self, batch: NodeBatch, best: int, target: int):
        """BFS warm-up -> (frontier_batch, tree, sol, best) or None."""
        return None

    def native_drain(self, batch: NodeBatch, best: int):
        """DFS a frontier to completion -> (tree, sol, best) or None."""
        return None

    def empty_batch(self, capacity: int) -> NodeBatch:
        return {
            name: np.zeros((capacity,) + shape, dtype=dtype)
            for name, (shape, dtype) in self.node_fields().items()
        }


def batch_length(batch: NodeBatch) -> int:
    for v in batch.values():
        return v.shape[0]
    return 0


def index_batch(batch: NodeBatch, idx) -> NodeBatch:
    return {k: v[idx] for k, v in batch.items()}
