"""The steady-state guard of the resident dispatch loops (``TTS_GUARD=1``,
``--guard``) — the port of `tpu_tree_search/analysis/guard.py`.

Once a resident loop reaches steady state, every dispatch must reuse what
the first one built and must not make the host wait for the card: the
host reads back only the sanctioned scalars of each dispatch, after its
enqueue. The loops wrap each dispatch's enqueue in
``SteadyStateGuard.step()``. The first dispatch of a program (and K rung)
is its warm one: graph capture, kernel loads and table uploads are
expected there and go unchecked. Every later dispatch is checked:

  * **it built nothing** (the JAX guard's "recompiled"): the calling
    thread's counts of dispatch graphs built, kernel libraries loaded and
    resident programs made (`ops/_build.py` ``build_counts``) are read
    before and after the enqueue and must not move. These counts work on
    the CPU too, where only the programs can move;
  * **it made no synchronising call** (the JAX guard's "implicit
    transfer"): on a CUDA device the enqueue runs under torch's sync debug
    mode, so a synchronising call of the guarded thread (``.item()``,
    ``.cpu()``, ``.tolist()`` of a CUDA tensor, a blocking copy, a stream
    or device synchronize) raises at that call.

A violation raises ``GuardViolation`` naming the guard's label, the
dispatch number and what happened.

Threads. torch's sync debug mode is one process-wide setting, where the
JAX transfer guard is per thread, and the serve daemon's workers and
dist_mesh's virtual hosts dispatch from several threads. So the guard sets
the mode to ``"warn"`` while any guarded enqueue is open (a count under a
module lock) and attributes each warning to the thread that made the call:
a synchronising call of a thread inside a guarded enqueue raises
``GuardViolation`` there; one made by any other thread (a sanctioned read
of another dispatch, a worker's download of its frontier) passes silently,
as it would unguarded. Nothing waits for anything, so no overlap is lost.
The mode goes back to its earlier setting when the last guarded enqueue
closes. The attribution is a ``warnings.showwarning`` hook and an
``"always"`` filter for torch's sync warning, put in place through the
public ``warnings`` API at the first arming and left there (the hook hands
everything else to the ``showwarning`` it replaced); each arming puts back
whatever a ``catch_warnings`` block took away. ``catch_warnings`` is not
thread-safe: a block in another thread that is open across a guarded
enqueue can hold the hook out for that time, and a synchronising call then
is printed as a warning rather than raised.

What it cannot see: the C entries behind ``ctypes`` (`ops/_build.py`) call
the CUDA runtime directly, so a ``cudaStreamSynchronize`` inside one would
pass unseen (the entries only enqueue, and must stay so); a CUDA event's
``synchronize`` is no synchronising call to torch's check; and torch calls
the mode a prototype that does not detect every synchronising operation.
On the CPU only the build counts are checked, and the run's ``guard``
record (``guard_record``) says so.
"""

from __future__ import annotations

import os
import re
import threading
import warnings
from contextlib import contextmanager

#: The text of torch's sync debug warning (`c10/cuda/CUDAFunctions.cpp`).
_SYNC_TEXT = re.compile(r"called a synchroniz", re.I)
#: The kinds ``build_counts`` reports, in the order violations name them.
BUILD_KINDS = ("graphs", "libraries", "programs")


class GuardViolation(RuntimeError):
    """A steady-state resident dispatch built something or synchronised."""


def guard_enabled(flag: bool | None = None) -> bool:
    """Explicit flag wins; else the TTS_GUARD env knob (``--guard`` in the
    CLI pins it for the run)."""
    if flag is not None:
        return flag
    return os.environ.get("TTS_GUARD", "0") not in ("", "0")


def _build_counts() -> dict:
    from ..ops._build import build_counts

    return build_counts()


class _SyncCheck:
    """The process-wide arming of torch's sync debug mode, shared by the
    guarded enqueues of every thread (see the module docstring)."""

    # requires-lock: _lock -- _install

    def __init__(self):
        # Reentrant: torch's mode switch may itself warn, and a warning
        # reaches ``_show``, which reads the saved state under this lock.
        self._lock = threading.RLock()
        self._open = 0  # guarded-by: _lock
        self._prev_mode = 0  # guarded-by: _lock
        self._delegate = warnings.showwarning  # guarded-by: _lock
        self._tls = threading.local()
        self._hook = self._show  # one bound method, compared by identity

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if issubclass(category, UserWarning) and _SYNC_TEXT.search(
                str(message)):
            active = getattr(self._tls, "active", None)
            if active is not None:
                label, n = active
                self._tls.hit = str(message)
                raise GuardViolation(
                    f"{label}: synchronising call in steady-state dispatch "
                    f"{n}: {message}")
            with self._lock:
                quiet = self._open > 0 and self._prev_mode == 0
            if quiet:
                return  # another thread's sanctioned read, silent unguarded
        with self._lock:
            delegate = self._delegate
        delegate(message, category, filename, lineno, file, line)

    def _install(self) -> None:
        """Put the hook and the filter in place where they are missing
        (under ``_lock``). Installed once and left: the hook passes every
        other warning, and every sync warning while no guarded enqueue is
        open, to the ``showwarning`` it replaced. Re-checked at every
        arming, because a ``catch_warnings`` block restores both on exit."""
        if warnings.showwarning is not self._hook:
            self._delegate = warnings.showwarning
            warnings.showwarning = self._hook
        if not any(f[0] == "always" and f[1] is not None
                   and f[1].pattern == _SYNC_TEXT.pattern
                   for f in warnings.filters[:1]):
            # "always": a repeat at one call site must reach the hook too.
            warnings.filterwarnings("always", message=_SYNC_TEXT.pattern,
                                    category=UserWarning)

    @contextmanager
    def armed(self, label: str, n: int):
        import torch

        with self._lock:
            self._install()
            if self._open == 0:
                self._prev_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            self._open += 1
        self._tls.active = (label, n)
        self._tls.hit = None
        try:
            yield
        finally:
            self._tls.active = None
            with self._lock:
                self._open -= 1
                if self._open == 0:
                    torch.cuda.set_sync_debug_mode(self._prev_mode)
        if self._tls.hit is not None:
            # The call's own raise was swallowed on its way out.
            raise GuardViolation(
                f"{label}: synchronising call in steady-state dispatch {n}: "
                f"{self._tls.hit}")


_SYNC = _SyncCheck()


class SteadyStateGuard:
    """Wraps a resident program's dispatches; asserts steady-state purity.

    ``program`` is the guarded program: its ``device`` decides whether the
    synchronising-call check arms (CUDA only). ``enabled=False`` collapses
    to a no-op so the loops can install it unconditionally and keep one
    code path."""

    def __init__(self, program, label: str = "resident step",
                 enabled: bool = True):
        self.program = program
        self.label = label
        self.enabled = enabled
        self.steps = 0  # dispatches seen (the first one is the warm one)
        self.warm = 0  # warm dispatches (the first, and one after rearm)
        self.checked = 0  # steady-state dispatches checked (or failed)
        dev = getattr(program, "device", None)
        self.sync_check = getattr(dev, "type", None) == "cuda"

    @contextmanager
    def step(self):
        if not self.enabled:
            yield
            return
        if self.steps == 0:
            # Warm dispatch: graph capture, kernel loads, uploads expected.
            yield
            self.steps += 1
            self.warm += 1
            return
        self.steps += 1
        self.checked += 1
        n = self.steps
        before = _build_counts()
        if self.sync_check:
            with _SYNC.armed(self.label, n):
                yield
        else:
            yield
        after = _build_counts()
        grew = [f"{k} {before.get(k, 0)} -> {after.get(k, 0)}"
                for k in BUILD_KINDS if after.get(k, 0) != before.get(k, 0)]
        if grew:
            raise GuardViolation(
                f"{self.label}: steady-state dispatch {n} built something "
                f"({', '.join(grew)}); a shape, K or state address is "
                "varying between dispatches")

    def rearm(self) -> None:
        """Accept the next dispatch as a new warm one (the loops call this
        after a sanctioned re-initialization: the capacity-stall fallback's
        re-upload)."""
        self.steps = 0


class RungGuards:
    """The guards of one search's program: one a K rung (each rung has a
    graph of its own, so its first dispatch is a warm one; re-selecting a
    rung reuses its guard). ``guard`` None reads ``TTS_GUARD``."""

    def __init__(self, program, label: str, guard: bool | None = None):
        self.program = program
        self.label = label
        self.enabled = guard_enabled(guard)
        self._by_k: dict[int, SteadyStateGuard] = {}

    def of(self) -> SteadyStateGuard:
        """The guard of the program's current K."""
        g = self._by_k.get(self.program.K)
        if g is None:
            g = self._by_k[self.program.K] = SteadyStateGuard(
                self.program, self.label, enabled=self.enabled)
        return g

    def record(self) -> dict | None:
        return guard_record(self._by_k.values())


def guard_record(guards) -> dict | None:
    """A search's guard record from its guards (one a program and K rung;
    None when the guard is off): the warm and the checked dispatches and
    the checks that ran, with what was not checked."""
    guards = [g for g in guards if g.enabled]
    if not guards:
        return None
    sync = all(g.sync_check for g in guards)
    rec = {"warm_dispatches": sum(g.warm for g in guards),
           "checked_dispatches": sum(g.checked for g in guards),
           "checks": ["builds", "sync"] if sync else ["builds"]}
    if not sync:
        rec["not_checked"] = ("synchronising calls: the sync debug mode is "
                              "CUDA's, and this run's tensors are not")
    return rec
