"""The K-cycle dispatch of the fused and streamed cycles as one CUDA graph
that stops at termination — the port's counterpart of the JAX engine's
``lax.while_loop`` (`tpu_tree_search/engine/resident.py`, ``loop_fns``).

``DispatchGraph`` builds, once a (program, K rung), a graph of three parts
(`csrc/dispatch_graph.cu`): a kernel that zeroes tree, sol and cycles in
the loop state and sets the condition; a ``while`` node whose body is one
cycle, captured by calling the cycle's wrapper (kernels 2, 4, 8, 9a, 9b or
9c) on a side stream in capture mode; and a last body kernel that sets the
condition ``size >= m and size + M*n <= C and cycles < K`` from the state
and counts the body's runs in ``st[ST_RUNS]``. ``launch`` enqueues one
dispatch on the current stream: one ``cudaGraphLaunch``, no host
synchronisation, and no cycle launched past termination.

Launch counts: ``DispatchGraph.launches`` counts graph launches. A cycle
wrapper counts its launches through ``count_launch``: one where it launches
its kernels; under a capture it launches nothing, so it adds one to its
``captures`` and the graph records it. The graph's launches of the cycle
are counted when the dispatch's scalars are read: ``count`` adds the
body's runs, read from ``st[ST_RUNS]``, to each recorded wrapper's
``launches``.

The graph bakes in the addresses of the pool, the state, the scratch and
the tables; the engine keeps them for the graph's life (a re-uploaded
frontier is copied into the existing tensors) and keys its graphs on them.
The build time is ``build_s``. CUDA only: the CPU path runs the plain
cycles in a Python loop that stops when the condition is false.

Telemetry builds graphs of its own (the engine keys its graph cache on the
two flags); off, the graph is the one above, node for node:

  * the counter block (``TTS_OBS=1``, `obs/counters.py`): ``obs`` (the
    cycle's child slots a parent) makes the body's last node
    ``dispatch_cond_obs``, which folds each cycle into the block in
    ``st[ST_CTR:]`` before it sets the condition (the plain version:
    ``dispatch_cond_obs_plain``), and the init node zeroes the block;
  * the phase clock (``TTS_PHASEPROF=1``, `obs/phases.py`): ``clk`` (an
    int64 block of ``phases.BLOCK_LEN``) adds a seed ``phase_mark`` before
    the while node; the cycle entry, given the clock, enqueues its marks
    between its launches. ``phase_mark`` is also enqueued from Python by
    the unfused cycle; on a CPU tensor ``phase_mark_plain`` reads
    ``time.perf_counter_ns`` at the same boundaries.

Both kernels are in `csrc/dispatch_graph.cu` (``phase_mark`` in
`csrc/phase_clock.cuh`); neither replaces a TPU kernel. Their launches are
counted as the cycles' are: a body's captured marks and its
``dispatch_cond_obs`` by the body's runs, the seed by graph launches.

``BatchGraph`` is the batched engine's dispatch (`engine/batched.py`, the
counterpart of the JAX batched ``lax.while_loop``): B loop states in one
(B, ST_LEN) tensor, a row a slot; an init node ``batch_init`` (each slot's
counts zeroed, the condition the OR of the slots'), and a ``while`` node
whose body is each slot's cycle, captured in slot order, then one
``batch_cond`` (``batch_cond_obs`` with the counter block). A slot whose
condition is false runs an exact no-op: its cycle's launch 1 clears
``st[ST_ACTIVE]`` and the later launches return at once; ``batch_cond``
counts a run, and folds the counter block, only for a slot whose cycle ran.
So one batched dispatch is one ``cudaGraphLaunch``, and a wrapper's
launches are the sum of its slots' runs (``BatchGraph.count``). The plain
versions ``batch_init_plain`` and ``batch_cond_plain`` run the same
arithmetic on the host.
"""

from __future__ import annotations

import ctypes
import threading
import time
from contextlib import contextmanager

import torch

from ..obs import counters as obs_counters
from ..obs import phases as obs_phases
from . import _build

_VP = ctypes.c_void_p
#: ``_TLS.wrappers``: the wrappers called under this thread's capture in
#: progress (absent or None: no capture). A capture records the launches
#: of its own thread only: other threads may launch kernels meanwhile (the
#: multi-device tier's workers, the serve daemon's).
_TLS = threading.local()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` where it launches its kernels; under
    a ``DispatchGraph`` capture on this thread, add one to
    ``wrapper.captures`` and record the wrapper for the graph, which counts
    its launches (``count``)."""
    wrappers = getattr(_TLS, "wrappers", None)
    if wrappers is None:
        _build.add_launches(wrapper)
    else:
        _build.add_launches(wrapper, field="captures")
        wrappers.append(wrapper)


@contextmanager
def recording(wrappers: list):
    """Record into ``wrappers`` the wrappers this thread calls in the block
    (a capture's), in place of counting their launches."""
    prev = getattr(_TLS, "wrappers", None)
    _TLS.wrappers = wrappers
    try:
        yield
    finally:
        _TLS.wrappers = prev


_ENTRY_ARGS = {
    "dispatch_graph_create": (_VP, ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
                              ctypes.POINTER(_VP), ctypes.POINTER(_VP),
                              ctypes.POINTER(ctypes.c_ulonglong)),
    "batch_graph_create": (_VP, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(_VP), ctypes.POINTER(_VP),
                           ctypes.POINTER(ctypes.c_ulonglong)),
    "batch_graph_end_body": (_VP, ctypes.c_int, _VP, ctypes.c_int,
                             ctypes.c_ulonglong, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int),
    "dispatch_graph_begin_body": (_VP, _VP),
    "dispatch_graph_end_body": (_VP, ctypes.c_int, _VP, ctypes.c_ulonglong,
                                ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int),
    "phase_mark_enqueue": (_VP, ctypes.c_int, ctypes.c_int, _VP),
    "dispatch_graph_kernels": (_VP, ctypes.c_int, ctypes.c_char_p,
                               ctypes.c_int, ctypes.POINTER(ctypes.c_int)),
    "globaltimer_probe_enqueue": (_VP, ctypes.c_int, _VP),
    "dispatch_graph_instantiate": (_VP, ctypes.POINTER(_VP)),
    "dispatch_graph_launch": (_VP, _VP),
    "dispatch_graph_destroy": (_VP, _VP),
}


def _fn(name: str):
    return _build.entry("dispatch_graph", name, _ENTRY_ARGS[name])


class DispatchGraph:
    """One K-cycle dispatch as a CUDA graph over the loop state ``st``.

    ``cycle()`` enqueues one cycle of the program (its wrapper, at this K)
    on the current stream; it is called once, under capture. ``m``, ``Mn``
    (M times the child slots), ``C`` and ``K`` are the loop condition's.
    ``obs`` (the child slots a parent; 0 off) arms the counter block,
    ``clk`` (the phase clock, or None) the seed mark; ``cycle()`` passes
    the clock to its entry itself.
    """

    def __init__(self, cycle, st: torch.Tensor, m: int, Mn: int, C: int,
                 K: int, obs: int = 0, clk: torch.Tensor | None = None):
        if not st.is_cuda:
            raise ValueError("DispatchGraph takes a CUDA state tensor")
        t0 = time.perf_counter()
        self.K = K
        self.st = st
        self.clk = clk
        self.wrappers: list = [dispatch_cond_obs] if obs else []
        self._graph = _VP()
        self._exec = _VP()
        body = _VP()
        handle = ctypes.c_ulonglong()
        lib, create = _fn("dispatch_graph_create")
        _build.check(lib, create(st.data_ptr(), m, Mn, C, K, obs,
                                 clock_pointer(clk),
                                 ctypes.byref(self._graph), ctypes.byref(body),
                                 ctypes.byref(handle)),
                     "dispatch_graph_create")
        self._body = body
        try:
            self._capture(lib, cycle, body, handle.value, m, Mn, C, K, obs)
            _, inst = _fn("dispatch_graph_instantiate")
            _build.check(lib, inst(self._graph, ctypes.byref(self._exec)),
                         "dispatch_graph_instantiate")
        except BaseException:
            self.close()
            raise
        self.build_s = time.perf_counter() - t0
        _build.count_build("graphs")

    def _capture(self, lib, cycle, body, handle: int, m: int, Mn: int,
                 C: int, K: int, obs: int) -> None:
        """The while node's body: ``cycle()`` on a side stream captured
        into ``body``, then the condition kernel."""
        side = torch.cuda.Stream(self.st.device)
        _, begin = _fn("dispatch_graph_begin_body")
        _, end = _fn("dispatch_graph_end_body")
        _build.check(lib, begin(body, side.cuda_stream),
                     "dispatch_graph_begin_body")
        ok = 0
        try:
            with torch.cuda.stream(side), recording(self.wrappers):
                cycle()
            ok = 1
        finally:
            err = end(side.cuda_stream, ok, self.st.data_ptr(), handle, m,
                      Mn, C, K, obs)
        _build.check(lib, err, "dispatch_graph_end_body")

    def launch(self) -> None:
        """Enqueue one dispatch on the current stream."""
        lib, fn = _fn("dispatch_graph_launch")
        stream = torch.cuda.current_stream(self.st.device).cuda_stream
        _build.check(lib, fn(self._exec, stream), "dispatch_graph_launch")
        _build.add_launches(DispatchGraph)
        if self.clk is not None:
            _build.add_launches(phase_mark_cuda)  # the seed node

    def count(self, runs: int) -> None:
        """Count a dispatch's ``runs`` of the body (``st[ST_RUNS]`` after
        it) as launches of each wrapper the body captured."""
        for w in self.wrappers:
            _build.add_launches(w, runs)

    def kernels(self, body: bool = True) -> list[str]:
        """The (mangled) kernel names of the body's nodes, or with
        ``body=False`` of the graph's own nodes ("-": the while node): the
        nodes this graph runs a cycle, or a dispatch."""
        lib, fn = _fn("dispatch_graph_kernels")
        cap, width = 64, 256
        names = ctypes.create_string_buffer(cap * width)
        count = ctypes.c_int()
        _build.check(lib, fn(self._body if body else self._graph, cap, names,
                             width, ctypes.byref(count)),
                     "dispatch_graph_kernels")
        raw = names.raw
        return [raw[i * width:(i + 1) * width].split(b"\0", 1)[0].decode()
                for i in range(min(count.value, cap))]

    def close(self) -> None:
        """Free the graph (after the work it launched has finished)."""
        if self._graph or self._exec:
            lib, fn = _fn("dispatch_graph_destroy")
            _build.check(lib, fn(self._graph, self._exec),
                         "dispatch_graph_destroy")
            self._graph = _VP()
            self._exec = _VP()


#: Graph launches in this process (all programs).
# guarded-by: _COUNT_LOCK -- of ops/_build.py, as every wrapper's launches
# and captures: written through ``_build.add_launches`` only.
DispatchGraph.launches = 0


class BatchGraph(DispatchGraph):
    """One K-cycle dispatch of a batch of B slots as a CUDA graph over the
    (B, ST_LEN) states ``st``. ``cycles[i]()`` enqueues one cycle of slot i
    on the current stream; each is called once, under capture, in slot
    order. ``m``, ``Mn``, ``C``, ``K`` and ``obs`` as ``DispatchGraph``'s
    (no phase clock: the batched engine refuses it)."""

    def __init__(self, cycles: list, st: torch.Tensor, m: int, Mn: int,
                 C: int, K: int, obs: int = 0):
        if not st.is_cuda or st.dim() != 2 or len(cycles) != st.shape[0]:
            raise ValueError("BatchGraph takes a CUDA (B, ST_LEN) state "
                             "tensor and one cycle a row")
        t0 = time.perf_counter()
        self.K = K
        self.st = st
        self.clk = None
        self.B = len(cycles)
        # The wrappers each slot's capture recorded, and the condition node.
        self.slot_wrappers: list[list] = [[] for _ in cycles]
        self.cond = batch_cond_obs if obs else batch_cond
        self.wrappers = []
        self._graph = _VP()
        self._exec = _VP()
        body = _VP()
        handle = ctypes.c_ulonglong()
        lib, create = _fn("batch_graph_create")
        _build.check(lib, create(st.data_ptr(), self.B, m, Mn, C, K, obs,
                                 ctypes.byref(self._graph), ctypes.byref(body),
                                 ctypes.byref(handle)),
                     "batch_graph_create")
        self._body = body
        try:
            self._capture_batch(lib, cycles, body, handle.value, m, Mn, C, K,
                                obs)
            _, inst = _fn("dispatch_graph_instantiate")
            _build.check(lib, inst(self._graph, ctypes.byref(self._exec)),
                         "dispatch_graph_instantiate")
        except BaseException:
            self.close()
            raise
        self.build_s = time.perf_counter() - t0
        _build.count_build("graphs")

    def _capture_batch(self, lib, cycles: list, body, handle: int, m: int,
                       Mn: int, C: int, K: int, obs: int) -> None:
        """The while node's body: each slot's cycle on one side stream, in
        slot order, captured into ``body``, then the condition kernel."""
        side = torch.cuda.Stream(self.st.device)
        _, begin = _fn("dispatch_graph_begin_body")
        _, end = _fn("batch_graph_end_body")
        _build.check(lib, begin(body, side.cuda_stream),
                     "dispatch_graph_begin_body")
        ok = 0
        try:
            with torch.cuda.stream(side):
                for cycle, wrappers in zip(cycles, self.slot_wrappers):
                    with recording(wrappers):
                        cycle()
            ok = 1
        finally:
            err = end(side.cuda_stream, ok, self.st.data_ptr(), self.B,
                      handle, m, Mn, C, K, obs)
        _build.check(lib, err, "batch_graph_end_body")

    def launch(self) -> None:
        """Enqueue one batched dispatch on the current stream."""
        lib, fn = _fn("dispatch_graph_launch")
        stream = torch.cuda.current_stream(self.st.device).cuda_stream
        _build.check(lib, fn(self._exec, stream), "dispatch_graph_launch")
        _build.add_launches(BatchGraph)
        _build.add_launches(batch_init)

    def count(self, runs: list[int]) -> None:
        """Count a dispatch's ``runs`` (each slot's ``st[ST_RUNS]`` after
        it): each wrapper slot i's capture recorded launched ``runs[i]``
        times; the condition node ran once a round, ``max(runs)`` times (a
        round runs while any slot is live, and a slot is live in the
        dispatch's first rounds only)."""
        for wrappers, r in zip(self.slot_wrappers, runs):
            for w in wrappers:
                _build.add_launches(w, r)
        _build.add_launches(self.cond, max(runs, default=0))


#: Batched graph launches in this process (all batched programs).
# guarded-by: _COUNT_LOCK -- of ops/_build.py (``_build.add_launches``).
BatchGraph.launches = 0


def batch_init_plain(st: torch.Tensor, m: int, Mn: int, C: int, K: int,
                     obs: bool = False) -> bool:
    """What one ``batch_init`` node computes, on the (B, ST_LEN) states in
    place: each slot's tree, sol, cycles and runs (with ``obs`` its counter
    block and the values it last saw) zeroed; returns the OR of the
    slots' loop conditions."""
    from .cycle import ST_CTR, ST_CTR_SOL, ST_CYCLES, ST_RUNS, ST_TREE

    st[:, ST_TREE:ST_CYCLES + 1] = 0
    st[:, ST_RUNS] = 0
    if obs:
        st[:, ST_CTR:ST_CTR_SOL + 1] = 0
    return any(loop_active(v, m, Mn, C, K) for v in st.tolist())


def batch_cond_plain(st: torch.Tensor, n: int, m: int, Mn: int, C: int,
                     K: int) -> bool:
    """What one ``batch_cond`` node (``n`` > 0: ``batch_cond_obs`` of
    cycles of ``n`` child slots a parent) computes, on the (B, ST_LEN)
    states in place: each slot whose cycle ran this round
    (``st[ST_ACTIVE]``) counts the run and, with ``n``, folds the cycle
    into its counter block (``dispatch_cond_obs_plain``'s update); a frozen
    slot is left as it is. Returns the OR of the slots' loop conditions."""
    from .cycle import ST_ACTIVE, ST_RUNS

    live = False
    for i, v in enumerate(st.tolist()):
        if v[ST_ACTIVE]:
            if n:
                dispatch_cond_obs_plain(st[i], n, m, Mn, C, K)
            else:
                st[i, ST_RUNS] += 1
        live |= loop_active(st[i].tolist(), m, Mn, C, K)
    return live


def loop_active(v: list, m: int, Mn: int, C: int, K: int) -> bool:
    """The loop condition on one state's words (``st.tolist()``):
    ``size >= m``, ``size + Mn <= C``, ``cycles < K``."""
    from .cycle import ST_CYCLES, ST_SIZE

    size = v[ST_SIZE]
    return size >= m and size + Mn <= C and v[ST_CYCLES] < K


# -- the counter block (TTS_OBS=1) ---------------------------------------------


def dispatch_cond_obs_plain(st: torch.Tensor, n: int, m: int, Mn: int,
                            C: int, K: int) -> bool:
    """What one ``dispatch_cond_obs`` node computes, on ``st`` in place:
    the cycle just run folded into the counter block (`obs/counters.py`
    ``update``: ``cnt`` from ``st[ST_CNT]``, the tree and sol increments
    from ``st[ST_TREE]``/``st[ST_SOL]`` less the values the block last
    saw, no overflow, ``Mn`` push rows), the body's run counted, and the
    loop condition returned."""
    from .cycle import (ST_CNT, ST_CTR, ST_CTR_SOL, ST_CTR_TREE, ST_CYCLES,
                        ST_RUNS, ST_SIZE, ST_SOL, ST_TREE)

    v = st.tolist()
    tree_inc = v[ST_TREE] - v[ST_CTR_TREE]
    sol_inc = v[ST_SOL] - v[ST_CTR_SOL]
    block = obs_counters.update(v[ST_CTR:ST_CTR + obs_counters.NSLOTS],
                                v[ST_CNT], n, tree_inc, sol_inc, False,
                                v[ST_SIZE], Mn)
    v[ST_CTR:ST_CTR + obs_counters.NSLOTS] = block
    v[ST_CTR_TREE], v[ST_CTR_SOL] = v[ST_TREE], v[ST_SOL]
    v[ST_RUNS] += 1
    st.copy_(torch.tensor(v, dtype=st.dtype))
    size = v[ST_SIZE]
    return size >= m and size + Mn <= C and v[ST_CYCLES] < K


class _GraphKernel:
    """The launch count of a kernel that runs only as a node of a dispatch
    graph (``dispatch_cond_obs``: it sets the while node's condition)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0
        self.captures = 0


dispatch_cond_obs = _GraphKernel("dispatch_cond_obs")
#: The batched graph's nodes (``BatchGraph``): the init node once a
#: dispatch, the condition node once a round.
batch_init = _GraphKernel("batch_init")
batch_cond = _GraphKernel("batch_cond")
batch_cond_obs = _GraphKernel("batch_cond_obs")


# -- the phase clock (TTS_PHASEPROF=1) -------------------------------------------


def new_clock(device) -> torch.Tensor:
    """A zeroed phase-clock block (``phases.BLOCK_LEN`` int64)."""
    return torch.zeros(obs_phases.BLOCK_LEN, dtype=torch.int64, device=device)


def clock_pointer(clk: torch.Tensor | None):
    """The clock's address for a cycle entry (None: no marks), after the
    checks the kernel needs."""
    if clk is None:
        return None
    if not (clk.is_cuda and clk.dtype == torch.int64 and clk.is_contiguous()
            and clk.numel() >= obs_phases.BLOCK_LEN):
        raise ValueError("the phase clock is a contiguous CUDA int64 block "
                         f"of {obs_phases.BLOCK_LEN}")
    return clk.data_ptr()


def phase_mark_at(block: list, slot: int, flags: int, now: int) -> list:
    """One mark's arithmetic on a block (a list of ``BLOCK_LEN`` ints) at
    the reading ``now``: charge ``now - block[TPREV]`` to ``slot``; ``OPEN``
    also sets ``T0``, ``CLOSE`` adds ``now - block[T0]`` to ``total``;
    ``SEED`` zeroes the block. ``TPREV`` becomes ``now``."""
    P = obs_phases
    if flags & P.SEED:
        v = [0] * P.BLOCK_LEN
    else:
        v = list(block)
        v[slot] += now - v[P.TPREV]
        if flags & P.OPEN:
            v[P.T0] = now
        if flags & P.CLOSE:
            v[P.IDX["total"]] += now - v[P.T0]
    v[P.TPREV] = now
    return v


def phase_mark_plain(clk: torch.Tensor, slot: int, flags: int = 0) -> None:
    """What one ``phase_mark`` computes, on the host's clock
    (``time.perf_counter_ns``): ``phase_mark_at`` on ``clk``."""
    v = phase_mark_at(clk.tolist(), slot, flags, time.perf_counter_ns())
    clk.copy_(torch.tensor(v, dtype=torch.int64))


def phase_mark_cuda(clk: torch.Tensor, slot: int, flags: int = 0) -> None:
    """Enqueue one ``phase_mark`` on the current stream."""
    ptr = clock_pointer(clk)
    if not 0 <= slot < obs_phases.NSLOTS:
        raise ValueError(f"phase slot {slot} out of range")
    lib, fn = _fn("phase_mark_enqueue")
    stream = torch.cuda.current_stream(clk.device).cuda_stream
    _build.check(lib, fn(ptr, slot, flags, stream), "phase_mark")
    count_launch(phase_mark_cuda)


phase_mark_cuda.launches = 0  # type: ignore[attr-defined]
phase_mark_cuda.captures = 0  # type: ignore[attr-defined]


def phase_mark(clk: torch.Tensor, slot: int, flags: int = 0) -> None:
    """One mark routed by device: the kernel on a CUDA block (which
    launches or raises), the host clock on a CPU one."""
    if clk.is_cuda:
        phase_mark_cuda(clk, slot, flags)
    else:
        phase_mark_plain(clk, slot, flags)


def count_marks(clk: torch.Tensor | None, marks: int) -> None:
    """Count the ``marks`` a cycle entry enqueued with ``clk`` (none
    without a clock) as ``phase_mark`` launches (``count_launch``)."""
    if clk is not None:
        for _ in range(marks):
            count_launch(phase_mark_cuda)


def globaltimer_step_ns(device, reads: int = 4096) -> dict:
    """The step of ``%globaltimer`` on the card: one thread's ``reads``
    back-to-back reads; the smallest non-zero difference, the share of
    zero differences and the largest difference."""
    out = torch.zeros(reads, dtype=torch.int64, device=device)
    lib, fn = _fn("globaltimer_probe_enqueue")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _build.check(lib, fn(out.data_ptr(), reads, stream), "globaltimer_probe")
    d = out.cpu().tolist()
    nz = [x for x in d if x > 0]
    return {"step_ns": min(nz) if nz else None,
            "zero_share": 1 - len(nz) / len(d), "max_ns": max(d),
            "reads": reads}
