"""Termination detection for the work-stealing runtime — the port's copy of
`tpu_tree_search/utils/termination.py`.

Reproduces the reference's two-phase idle-scan with sticky fast-exit flag
(`lib/commons/util.chpl:7-30`, C: `baselines/commons/util.c:18-30`): a task
that finds no work and no victim sets its state IDLE and asks "is everyone
idle?"; the first scan that observes all-idle sets a sticky global flag so
every other task exits on its next check without rescanning. A task that
finds or steals work flips itself back to BUSY first (the
become-BUSY-again transition the scan's correctness depends on,
`pfsp_multigpu_chpl.chpl:416-419`).

CPython note: the per-element reads/writes are plain list slots guarded by
the GIL (each is a single bytecode-level store, the atomicity class of the
reference's relaxed atomics); the sticky flag is an Event for cross-thread
visibility.
"""

from __future__ import annotations

import threading

BUSY = False  # `util.chpl:3`
IDLE = True  # `util.chpl:4`


class TaskStates:
    """One BUSY/IDLE slot per task plus the sticky all-idle flag."""

    def __init__(self, n: int):
        self.states = [BUSY] * n
        self.flag = threading.Event()

    def set_busy(self, tid: int) -> None:
        self.states[tid] = BUSY

    def set_idle(self, tid: int) -> None:
        self.states[tid] = IDLE

    def _all_idle(self) -> bool:
        """`util.chpl:7-14`."""
        return all(s == IDLE for s in self.states)

    def all_idle(self) -> bool:
        """`util.chpl:16-30`: sticky fast path, else scan and latch."""
        if self.flag.is_set():
            return True
        if self._all_idle():
            self.flag.set()
            return True
        return False
