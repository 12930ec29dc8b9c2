"""SoA work-pool deque (the port's copy of `tpu_tree_search/pool/pool.py`):
``SoAPool`` and the lock-protected ``ParallelSoAPool`` of the multi-device
tier.

The reference keeps one growable deque of nodes per task: back ops drive DFS,
front ops drive the BFS warm-up (`lib/commons/Pool.chpl:1-75`). Here the
pool is a struct-of-arrays over the problem's node fields, so a popped chunk
is already in the layout the device wants: a contiguous slice per field.
"""

from __future__ import annotations

import math
import threading

import numpy as np

INITIAL_CAPACITY = 1024  # `Pool.chpl:10`


class SoAPool:
    """Serial growable SoA deque (`lib/commons/Pool.chpl`).

    fields: dict name -> (per-node shape, dtype).
    """

    def __init__(self, fields, capacity: int = INITIAL_CAPACITY):
        self.fields = dict(fields)
        self.capacity = int(capacity)
        self.front = 0
        self.size = 0
        self.data = {
            name: np.empty((self.capacity,) + tuple(shape), dtype=dtype)
            for name, (shape, dtype) in self.fields.items()
        }

    # -- growth ------------------------------------------------------------

    def _ensure(self, extra: int) -> None:
        needed = self.front + self.size + extra
        if needed <= self.capacity:
            return
        if self.size + extra <= self.capacity // 2 and self.front > 0:
            # Plenty of room once the consumed [0:front) prefix is dropped:
            # compact in place instead of growing.
            for arr in self.data.values():
                arr[: self.size] = arr[self.front : self.front + self.size]
            self.front = 0
            return
        # Grow by powers of two like `Pool_par.chpl:79`, compacting away the
        # dead prefix while copying.
        live = self.size + extra
        new_cap = self.capacity * 2 ** max(1, math.ceil(math.log2(live / self.capacity)))
        for name, arr in self.data.items():
            grown = np.empty((new_cap,) + arr.shape[1:], dtype=arr.dtype)
            grown[: self.size] = arr[self.front : self.front + self.size]
            self.data[name] = grown
        self.front = 0
        self.capacity = new_cap

    # -- single-node ops ---------------------------------------------------

    def push_back(self, node: dict) -> None:
        """`Pool.chpl:27-35`."""
        self._ensure(1)
        end = self.front + self.size
        for name, arr in self.data.items():
            arr[end] = node[name]
        self.size += 1

    def pop_back(self) -> dict | None:
        """`Pool.chpl:38-47`."""
        if self.size <= 0:
            return None
        self.size -= 1
        end = self.front + self.size
        return {name: arr[end].copy() for name, arr in self.data.items()}

    def pop_front(self) -> dict | None:
        """`Pool.chpl:62-73`."""
        if self.size <= 0:
            return None
        node = {name: arr[self.front].copy() for name, arr in self.data.items()}
        self.front += 1
        self.size -= 1
        return node

    # -- bulk ops ----------------------------------------------------------

    def push_back_bulk(self, batch: dict) -> None:
        """`Pool_par.chpl:73-92` (without the lock)."""
        k = 0
        for v in batch.values():
            k = v.shape[0]
            break
        if k == 0:
            return
        self._ensure(k)
        end = self.front + self.size
        for name, arr in self.data.items():
            arr[end : end + k] = batch[name]
        self.size += k

    def pop_back_bulk(self, m: int, M: int, out: dict) -> int:
        """Pop min(size, M) from the back into ``out`` iff size >= m; else 0
        (`Pool.chpl:50-59`). ``out`` arrays must have capacity >= M.
        """
        if self.size < m:
            return 0
        k = min(self.size, M)
        self.size -= k
        start = self.front + self.size
        for name, arr in self.data.items():
            out[name][:k] = arr[start : start + k]
        return k

    def pop_back_bulk_all(self, M: int, out: dict) -> int:
        """Drain up to M from the back unconditionally (the drain when fewer
        than m nodes remain; `pool.py:124`)."""
        if self.size == 0:
            return 0
        k = min(self.size, M)
        self.size -= k
        start = self.front + self.size
        for name, arr in self.data.items():
            out[name][:k] = arr[start : start + k]
        return k

    def pop_front_bulk_half(self, m: int, perc: float = 0.5,
                            cap: int | None = None) -> dict | None:
        """Steal a ``perc`` fraction of the pool from the *front* (oldest,
        shallowest subtrees) iff size >= 2m, or None (`pool.py:137`).
        perc = 0.5 is the steal-half rule of `Pool_par.chpl:180-191`;
        other fractions the CUDA baseline's ``--perc`` (`Pool_ext.c:
        138-151`). ``cap`` bounds the stolen block."""
        if self.size < 2 * m:
            return None
        k = max(1, int(self.size * perc))
        k = min(k, self.size)
        if cap is not None:
            k = min(k, cap)
        batch = {
            name: arr[self.front : self.front + k].copy()
            for name, arr in self.data.items()
        }
        self.front += k
        self.size -= k
        return batch

    def as_batch(self) -> dict:
        """Copy out the whole pool contents (front..front+size)."""
        return {
            name: arr[self.front : self.front + self.size].copy()
            for name, arr in self.data.items()
        }

    def reset_from(self, batch: dict) -> None:
        """Replace the whole contents with ``batch``."""
        self.clear()
        self.push_back_bulk(batch)

    def clear(self) -> None:
        self.front = 0
        self.size = 0


class ParallelSoAPool(SoAPool):
    """Lock-protected pool of the multi-device tier (`pool.py:178-219`,
    `lib/commons/Pool_par.chpl`). The reference spins on an atomic bool
    with task yields (`Pool_par.chpl:28-40`); host threads here take a
    mutex, with ``try_lock`` for the bounded-retry steal loop
    (`nqueens_multigpu_chpl.chpl:268-293`).

    Once shared with worker threads, the pool's state is touched only with
    ``lock`` held: through the ``locked_*`` methods, ``with pool.lock:``,
    or the taken branch of ``if pool.try_lock():``. The inherited methods
    leave the lock to the caller.
    """

    def __init__(self, fields, capacity: int = INITIAL_CAPACITY):
        super().__init__(fields, capacity)
        self.lock = threading.Lock()

    def try_lock(self) -> bool:
        return self.lock.acquire(blocking=False)

    def unlock(self) -> None:
        self.lock.release()

    def locked_push_back_bulk(self, batch: dict) -> None:
        with self.lock:
            self.push_back_bulk(batch)

    def locked_pop_back_bulk(self, m: int, M: int, out: dict) -> int:
        with self.lock:
            return self.pop_back_bulk(m, M, out)

    def locked_pop_back_bulk_all(self, M: int, out: dict) -> int:
        with self.lock:
            return self.pop_back_bulk_all(M, out)
