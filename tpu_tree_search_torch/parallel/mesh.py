"""Chunk evaluation over a mesh of device positions — the port of
`tpu_tree_search/parallel/mesh.py` (``make_mesh``, ``MeshEvaluator``).

The JAX module builds one sharded step over a (dp, mp) device mesh:

  * ``dp`` axis: a chunk's parent rows are split in dp blocks, one a
    device;
  * ``mp`` axis (PFSP lb2 only): the Johnson machine-pair loop is split in
    mp pair blocks, each bounded on its own and combined by ``lax.pmax``;
  * the incumbent: the chunk's leaf makespans, rows at or past ``count``
    masked out, are min-reduced across the mesh (``lax.pmin``).

Here a mesh is a (dp, mp) grid of device positions (``Mesh``; a position
may repeat a card, and on one card every block runs there in turn). Row
block i is evaluated on the card of position (i, 0): N-Queens labels on
kernel 3, PFSP lb1 and lb1_d on kernels 1 and 5, lb2 on kernel 6 — under
mp > 1 on its mp pair blocks (`ops/pfsp_device.py` ``lb2_bounds_mp``),
pair block j on the card of position (i, j), the planes copied back to
(i, 0) and combined by an elementwise max. A CPU position takes the plain
versions. The planes come back to the first position's device; the leaf
fold is taken there. A library class, as in JAX: no CLI flag uses it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..obs import events as ev
from ..ops.backend import resolve_devices
from ..ops.pfsp_device import lb2_bounds_mp
from ..problems.base import INF_BOUND


@dataclass(frozen=True)
class Mesh:
    """A (dp, mp) grid of device positions (``devices[i][j]``: row block
    i's pair block j); ``shape`` as the JAX mesh's, ``{"dp": .., "mp":
    ..}``."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "mp": len(self.devices[0])}


def make_mesh(n_devices: int | None = None, mp: int = 1,
              devices=None) -> Mesh:
    """A (dp, mp) mesh over the first ``n_devices`` of ``devices`` (default:
    every card), row-major as the JAX ``make_mesh``: position (i, j) is
    ``devices[i * mp + j]``. ``mp`` > 1 carves off the machine-pair axis
    for lb2; the rest is data parallelism."""
    if devices is None:
        from .multidevice import default_devices

        devices = default_devices(None)
    devices = resolve_devices(devices)
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if n_devices % mp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by mp={mp}")
    return Mesh(tuple(tuple(devices[i * mp:(i + 1) * mp])
                      for i in range(n_devices // mp)))


def _pad_len(n: int, k: int) -> int:
    return (n + k - 1) // k * k


class MeshEvaluator:
    """Chunk evaluator for one problem over one mesh (the JAX class).

    ``__call__(parents, count, best) -> (results, new_best)``: ``parents``
    a host-side dict batch of ``pad_to_mesh`` rows (a multiple of dp),
    ``results`` the (rows, child slots) plane of labels or bounds (a
    tensor on the mesh's first device), ``new_best`` the incumbent folded
    with the chunk's valid leaf makespans (N-Queens: ``INF_BOUND``)."""

    def __init__(self, problem, mesh: Mesh):
        self.problem = problem
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.mp = mesh.shape["mp"]
        if self.mp > 1 and getattr(problem, "lb", None) != "lb2":
            raise ValueError("mp-axis sharding splits the lb2 Johnson pair "
                             "loop; use a single-axis mesh for other "
                             "problems/bounds")
        t_build = ev.now_us()
        # Each row block's device (its position's pair block 0) and, for
        # PFSP, the tables of every position (with the mp pair blocks
        # built): pair block j of row block i runs on position (i, j).
        self._devices = [row[0] for row in mesh.devices]
        self._tables = {}
        if problem.name == "pfsp":
            for dev in (d for row in mesh.devices for d in row):
                t = self._tables.setdefault(str(dev),
                                            problem.device_tables(dev))
                if self.mp > 1:
                    t.pair_blocks(self.mp)
        ev.complete("build", t_build, cat="compile", args={
            "program": "mesh_chunk_step", "problem": problem.name,
            "dp": int(self.dp), "mp": int(self.mp),
        })

    def pad_to_mesh(self, count: int) -> int:
        return _pad_len(count, self.dp)

    def __call__(self, parents: dict, count: int, best: int):
        t0 = ev.now_us()
        out = self._run(parents, count, best)
        ev.complete("chunk", t0, args={"count": int(count)})
        return out

    def _run(self, parents: dict, count: int, best: int):
        p = self.problem
        rows = len(parents[p.vals_field])
        if rows % self.dp:
            raise ValueError(f"{rows} parent rows are not a multiple of "
                             f"dp={self.dp}: pad them to pad_to_mesh(count)")
        local = rows // self.dp
        dev0 = self._devices[0]
        planes, leaf_mins = [], []
        for i, dev in enumerate(self._devices):
            blk = {k: torch.from_numpy(np.ascontiguousarray(
                v[i * local:(i + 1) * local])).to(dev)
                for k, v in parents.items()}
            if p.name == "pfsp":
                plane = self._bounds(blk, i)
                leaf_mins.append(_leaf_min(blk, plane, p.jobs, count,
                                           i * local).to(dev0))
            else:
                plane = p.device_bounds(blk["board"], blk["depth"])
            planes.append(plane.to(dev0))
        results = torch.cat(planes)
        if p.name != "pfsp":
            # No incumbent: backtracking never prunes (the JAX step).
            return results, INF_BOUND
        return results, min(int(best), int(torch.stack(leaf_mins).min()))

    def _bounds(self, blk: dict, i: int) -> torch.Tensor:
        """Row block i's child bounds on its device; under mp > 1 pair
        block j on position (i, j), the planes maxed on the first."""
        prmu, limit1 = blk["prmu"], blk["limit1"]
        if self.problem.lb == "lb2" and self.mp > 1:
            placed = [self._tables[str(d)] for d in self.mesh.devices[i]]
            return lb2_bounds_mp(prmu, limit1, placed[0], self.mp, placed)
        return self.problem.device_bounds(prmu, limit1)


def _leaf_min(blk: dict, bounds: torch.Tensor, jobs: int, count: int,
              row0: int) -> torch.Tensor:
    """The JAX ``_fold_leaf_best`` of one row block (before the mesh-wide
    min): the least leaf-child makespan of its rows below ``count``
    (global rows from ``row0``), ``INF_BOUND`` without one."""
    dev = bounds.device
    local, n = bounds.shape
    row = row0 + torch.arange(local, device=dev)
    depth = blk["depth"].to(torch.int32)
    limit1 = blk["limit1"].to(torch.int32)
    j = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    is_leaf = (((depth[:, None] + 1) == jobs) & (j >= limit1[:, None] + 1)
               & (row < count)[:, None])
    return torch.where(is_leaf, bounds, torch.full_like(bounds, INF_BOUND)
                       ).min()
