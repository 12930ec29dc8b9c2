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
"""

from __future__ import annotations

import ctypes
import time

import torch

from . import _build

_VP = ctypes.c_void_p
#: The wrappers called under the capture in progress (None: no capture).
_capturing: list | None = None


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` where it launches its kernels; under
    a ``DispatchGraph`` capture, add one to ``wrapper.captures`` and record
    the wrapper for the graph, which counts its launches (``count``)."""
    if _capturing is None:
        wrapper.launches += 1
    else:
        wrapper.captures += 1
        _capturing.append(wrapper)
_ENTRY_ARGS = {
    "dispatch_graph_create": (_VP, ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(_VP), ctypes.POINTER(_VP),
                              ctypes.POINTER(ctypes.c_ulonglong)),
    "dispatch_graph_begin_body": (_VP, _VP),
    "dispatch_graph_end_body": (_VP, ctypes.c_int, _VP, ctypes.c_ulonglong,
                                ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int),
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
    """

    def __init__(self, cycle, st: torch.Tensor, m: int, Mn: int, C: int,
                 K: int):
        if not st.is_cuda:
            raise ValueError("DispatchGraph takes a CUDA state tensor")
        t0 = time.perf_counter()
        self.K = K
        self.st = st
        self.wrappers: list = []
        self._graph = _VP()
        self._exec = _VP()
        body = _VP()
        handle = ctypes.c_ulonglong()
        lib, create = _fn("dispatch_graph_create")
        _build.check(lib, create(st.data_ptr(), m, Mn, C, K,
                                 ctypes.byref(self._graph), ctypes.byref(body),
                                 ctypes.byref(handle)),
                     "dispatch_graph_create")
        try:
            self._capture(lib, cycle, body, handle.value, m, Mn, C, K)
            _, inst = _fn("dispatch_graph_instantiate")
            _build.check(lib, inst(self._graph, ctypes.byref(self._exec)),
                         "dispatch_graph_instantiate")
        except BaseException:
            self.close()
            raise
        self.build_s = time.perf_counter() - t0

    def _capture(self, lib, cycle, body, handle: int, m: int, Mn: int,
                 C: int, K: int) -> None:
        """The while node's body: ``cycle()`` on a side stream captured
        into ``body``, then the condition kernel."""
        side = torch.cuda.Stream(self.st.device)
        _, begin = _fn("dispatch_graph_begin_body")
        _, end = _fn("dispatch_graph_end_body")
        _build.check(lib, begin(body, side.cuda_stream),
                     "dispatch_graph_begin_body")
        global _capturing
        ok = 0
        _capturing = self.wrappers
        try:
            with torch.cuda.stream(side):
                cycle()
            ok = 1
        finally:
            _capturing = None
            err = end(side.cuda_stream, ok, self.st.data_ptr(), handle, m,
                      Mn, C, K)
        _build.check(lib, err, "dispatch_graph_end_body")

    def launch(self) -> None:
        """Enqueue one dispatch on the current stream."""
        lib, fn = _fn("dispatch_graph_launch")
        stream = torch.cuda.current_stream(self.st.device).cuda_stream
        _build.check(lib, fn(self._exec, stream), "dispatch_graph_launch")
        DispatchGraph.launches += 1

    def count(self, runs: int) -> None:
        """Count a dispatch's ``runs`` of the body (``st[ST_RUNS]`` after
        it) as launches of each wrapper the body captured."""
        for w in self.wrappers:
            w.launches += runs

    def close(self) -> None:
        """Free the graph (after the work it launched has finished)."""
        if self._graph or self._exec:
            lib, fn = _fn("dispatch_graph_destroy")
            _build.check(lib, fn(self._graph, self._exec),
                         "dispatch_graph_destroy")
            self._graph = _VP()
            self._exec = _VP()


#: Graph launches in this process (all programs).
DispatchGraph.launches = 0
