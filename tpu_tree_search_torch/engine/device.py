"""The single-device chunked-offload search and the host phases of the device
tiers — the port of `tpu_tree_search/engine/device.py`:

  step 1  host BFS warm-up: pop-front + host decompose until the pool holds
          at least ``target`` nodes (`nqueens_gpu_chpl.chpl:169-175`);
  step 2  (``device_search``, the reference's per-chunk round trip) pop a
          back chunk of ``m..M`` parents, evaluate every child on the
          device, prune and branch on the host, push the survivors
          (`nqueens_gpu_chpl.chpl:197-215`);
  step 3  host DFS drain of the remainder (`nqueens_gpu_chpl.chpl:230-236`).

The warm-up, the drain and the host prune/branch take the native runtime
(`native/`) first and the Python path under ``TTS_NATIVE=0``. The resident
engine (`engine/resident.py`) shares steps 1 and 3 and the offloader, which
serves its capacity-stall fallback.

Dispatch overlap, as in the JAX `device_search`: chunk i+1 is popped and dispatched
before chunk i is consumed, so its H2D, evaluation and D2H ride the stream
while the host branches chunk i. With a fixed incumbent (ub=1, or N-Queens,
which never prunes) the explored tree is the synchronous one; with an
improving incumbent it is a valid B&B relaxation, the JAX engine's tree
count for count, because the order is the same.

The JAX module's shape bucketing (``bucket_size``/``pad_chunk``) has no
counterpart: PyTorch runs eagerly and compiles nothing per chunk shape, so
a chunk is evaluated at its own size.

Telemetry (`obs/`): the offload search emits one ``explored`` sample a
phase and a flight-recorder heartbeat a consumed chunk (the JAX
`engine/device.py:227-260`; the JAX search emits no ``explored`` samples).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..obs import events as ev
from ..obs import flightrec as fr
from ..ops.backend import resolve_device
from ..pool.pool import SoAPool
from ..problems.base import INF_BOUND, Problem, batch_length, index_batch
from .results import Diagnostics, PhaseStats, SearchResult


def pool_dtype(n: int) -> torch.dtype:
    """PFSP device pool storage type: int8 rows (and limit1) through 127
    jobs, int32 beyond (the kernels take those two types)."""
    return torch.int8 if n <= 127 else torch.int32


def pool_dtypes(problem: Problem) -> tuple[torch.dtype, torch.dtype]:
    """The device storage types of the pool's two columns (the resident
    pool and the offloaded chunks): PFSP rows and limit1 ``pool_dtype``;
    N-Queens boards uint8, depth int8 through N = 127, int32 beyond."""
    if problem.name == "pfsp":
        return pool_dtype(problem.jobs), pool_dtype(problem.jobs)
    from ..ops.cycle_nqueens import depth_dtype

    return torch.uint8, depth_dtype(problem.N)


class DeviceOffloader:
    """Evaluates host chunks on one device through the problem's device
    evaluator: the lb1, lb1_d or lb2 bound for PFSP, the safety labels for
    N-Queens (the CUDA kernels for a CUDA device). Under lb2 the evaluation
    is staged unless ``staged=False`` (the JAX offload's kernel path,
    `ops/pfsp_device.py:950-991`): kernel 1 bounds every child slot, the
    chunk's leaves fold into ``best``, kernel 7 bounds the candidates
    ``open & ~leaf & lb1 < best`` only, and each slot reports ``where(cand,
    lb2, lb1)``; a slot left at lb1 is at or above the dispatch's ``best``,
    which the host's running incumbent only lowers, so the host prunes the
    same children as under the single-pass kernel 6.

    ``dispatch`` stages a chunk into one of two host buffers (pinned on the
    card), copies its two columns to the device, runs the evaluator and
    queues the D2H of the result plane behind an event, without waiting;
    ``collect`` waits for it. Two buffers are enough for the callers'
    one-pending discipline (dispatch chunk i+1, then consume chunk i).
    Counts launches and copies like Chapel's GpuDiagnostics
    (`pfsp_gpu_chpl.chpl:454-466`): one ``kernel_launches`` an evaluation,
    ``double_buffered`` for each dispatch made while another was in
    flight."""

    def __init__(self, problem: Problem, device: torch.device,
                 staged: bool = True):
        self.problem = problem
        self.device = device
        self.vals_dtype, self.aux_dtype = pool_dtypes(problem)
        self.staged = (staged and problem.name == "pfsp"
                       and problem.lb == "lb2")
        self.diagnostics = Diagnostics()
        self._cuda = device.type == "cuda"
        # Per buffer: {field: host array} and the result plane (lazy).
        self._host: list[dict | None] = [None, None]
        self._out: list[torch.Tensor | None] = [None, None]
        self._flip = 0

    def _buffer(self, i: int, chunk: dict) -> dict:
        """Staging buffer ``i``: ``{field: host tensor}`` (pinned on the
        card) shaped like ``chunk``, the M-row pop buffer of the caller."""
        if self._host[i] is None:
            self._host[i] = {
                name: torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                                  pin_memory=self._cuda)
                for name, arr in chunk.items()}
        return self._host[i]

    def _evaluate(self, vals: torch.Tensor, aux: torch.Tensor,
                  best: int) -> torch.Tensor:
        if not self.staged:
            return self.problem.device_bounds(vals, aux)
        from ..ops.pfsp_device import lb1_bounds, lb2_bounds_staged

        tables = self.problem.device_tables(vals.device)
        n = vals.shape[1]
        bounds1 = lb1_bounds(vals, aux, tables)
        limit1 = aux.to(torch.int32)
        kk = torch.arange(n, dtype=torch.int32, device=vals.device)[None, :]
        open_ = kk >= (limit1 + 1)[:, None]
        leaf = open_ & ((limit1 + 2) == n)[:, None]
        folded = torch.clamp(
            torch.where(leaf, bounds1, torch.full_like(bounds1, INF_BOUND))
            .min(), max=best)
        cand = open_ & ~leaf & (bounds1 < folded)
        return torch.where(cand, lb2_bounds_staged(vals, aux, cand, tables),
                           bounds1)

    def dispatch(self, chunk: dict, count: int, best: int,
                 overlapped: bool = False):
        """Stage ``chunk[:count]`` (``chunk``: the caller's M-row pop
        buffer), copy it to the device, evaluate, and queue the result's
        D2H; returns ``(staged parents, handle)``. The staged dict stays
        valid until the second-next ``dispatch``."""
        i = self._flip
        self._flip = 1 - i
        host = {name: t[:count] for name, t in self._buffer(i, chunk).items()}
        staged = {name: t.numpy() for name, t in host.items()}
        for name, arr in chunk.items():
            staged[name][:] = arr[:count]
        p = self.problem
        cols = [host[name].to(self.device, non_blocking=True).to(dtype)
                for name, dtype in ((p.vals_field, self.vals_dtype),
                                    (p.aux_field, self.aux_dtype))]
        self.diagnostics.host_to_device += 1
        if overlapped:
            self.diagnostics.double_buffered += 1
        out = self._evaluate(cols[0], cols[1], best)
        self.diagnostics.kernel_launches += 1
        if not self._cuda:
            return staged, (out.numpy(), None)
        if self._out[i] is None:
            self._out[i] = torch.empty(
                (chunk[p.vals_field].shape[0],) + tuple(out.shape[1:]),
                dtype=out.dtype, pin_memory=True)
        buf = self._out[i]
        buf[:count].copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return staged, (buf[:count].numpy(), done)

    def collect(self, handle) -> np.ndarray:
        """The result plane of a dispatch (waits for its D2H)."""
        out, done = handle
        if done is not None:
            done.synchronize()
        self.diagnostics.device_to_host += 1
        return out

    def evaluate(self, parents: dict, count: int, best: int):
        """One synchronous chunk: ``(staged parents, (count, width) result
        plane)``."""
        staged, handle = self.dispatch(parents, count, best)
        return staged, self.collect(handle)


def warmup(problem: Problem, pool: SoAPool, best: int, target: int):
    """Step 1: breadth-first host expansion until ``pool.size >= target``.
    Pops from the *front* so the leftover pool is shallow-first.
    Returns (tree_inc, sol_inc, best)."""
    if 0 < pool.size < target:
        native = problem.native_warmup(pool.as_batch(), best, target)
        if native is not None:
            frontier, tree, sol, best = native
            pool.reset_from(frontier)
            return tree, sol, best
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
    if pool.size > 0:
        native = problem.native_drain(pool.as_batch(), best)
        if native is not None:
            pool.clear()
            return native
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


def device_search(
    problem: Problem,
    m: int = 25,
    M: int = 50000,
    device=None,
    initial_best: int | None = None,
    overlap: bool = True,
    staged: bool = True,
) -> SearchResult:
    """3-phase search with a per-chunk host round trip (``--engine
    offload``): host warm-up to m nodes, then
    chunks of up to M parents popped from the back, evaluated on the device
    and branched on the host while at least m nodes remain, then a host
    drain. ``device`` defaults to ``cuda`` (raises when absent); pass
    ``"cpu"`` for the plain PyTorch path. ``overlap`` dispatches chunk i+1
    before consuming chunk i (the JAX order); under lb2 ``staged=False``
    evaluates with the single-pass kernel 6 in place of kernels 1 and 7."""
    dev = resolve_device(device)
    best = (initial_best if initial_best is not None
            else getattr(problem, "initial_ub", INF_BOUND))
    pool = SoAPool(problem.node_fields())
    pool.push_back(index_batch(problem.root(), 0))
    off = DeviceOffloader(problem, dev, staged=staged)
    problem._native()  # a first call builds it: outside the timed phases
    fr.arm("offload")
    phases: list[PhaseStats] = []
    t0 = time.perf_counter()

    # -- step 1: warm-up ---------------------------------------------------
    tree1, sol1, best = warmup(problem, pool, best, m)
    t1 = time.perf_counter()
    phases.append(PhaseStats(t1 - t0, tree1, sol1))
    ev.counter("explored", tree=tree1, sol=sol1, phase=1)

    # -- step 2: chunked offload loop --------------------------------------
    tree2 = sol2 = 0
    chunk_buf = problem.empty_batch(M)
    pending = None  # (staged parents, count, handle)
    n_chunk = 0  # consumed chunks (the flight recorder's sequence)

    def consume(p) -> None:
        nonlocal tree2, sol2, best, n_chunk
        parents, count, handle = p
        res = problem.generate_children(parents, count, off.collect(handle),
                                        best)
        tree2 += res.tree_inc
        sol2 += res.sol_inc
        best = res.best
        pool.push_back_bulk(res.children)
        n_chunk += 1
        fr.heartbeat("offload", seq=n_chunk, size=pool.size, best=best,
                     tree=tree2, sol=sol2)

    try:
        while True:
            count = pool.pop_back_bulk(m, M, chunk_buf)
            if count == 0:
                if pending is not None:
                    consume(pending)
                    pending = None
                    continue  # children may refill the pool past m
                break
            staged_parents, handle = off.dispatch(
                chunk_buf, count, best, overlapped=pending is not None)
            new = (staged_parents, count, handle)
            if overlap and pending is not None:
                consume(pending)
                pending = new
            elif overlap:
                pending = new
            else:
                consume(new)
    finally:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    t2 = time.perf_counter()
    phases.append(PhaseStats(t2 - t1, tree2, sol2))
    ev.counter("explored", tree=tree2, sol=sol2, phase=2)

    # -- step 3: drain ------------------------------------------------------
    tree3, sol3, best = drain(problem, pool, best)
    t3 = time.perf_counter()
    phases.append(PhaseStats(t3 - t2, tree3, sol3))
    ev.counter("explored", tree=tree3, sol=sol3, phase=3)

    return SearchResult(
        explored_tree=tree1 + tree2 + tree3,
        explored_sol=sol1 + sol2 + sol3,
        best=best,
        elapsed=t3 - t0,
        phases=phases,
        diagnostics=off.diagnostics,
        M=M,
        staged=off.staged,
        engine="offload",
    )
