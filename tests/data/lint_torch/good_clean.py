"""Known-good fixture: device-idiomatic captured code that must produce no
findings (the torch twin of tests/data/lint/good_clean.py)."""
import threading

import numpy as np
import torch

from tpu_tree_search_torch.engine.resident import take_cached
from tpu_tree_search_torch.ops.dispatch import DispatchGraph


# tts-lint: traced (a cycle a dispatch graph captures)
def step(pool, size, best):
    cnt = torch.clamp(size, max=8)
    bounds = pool[:8].sum(dim=-1)
    best = torch.minimum(best, bounds.min())
    keep = bounds < best
    return pool, size - cnt, best, keep


def host_driver(pool_np, best: int):
    # Host-side code may sync freely: none of this is captured.
    arr = np.asarray(pool_np)
    total = int(arr.sum())
    if total > 0:
        best = min(best, total)
    return float(best)


class Pool:
    # guarded-by: lock -- size

    def __init__(self):
        self.lock = threading.Lock()
        self.size = 0


def consume(p: Pool) -> int:
    with p.lock:
        return p.size


def shapes(x):
    n = x.shape[-1]
    if n <= 32:  # static: shape metadata
        return x.reshape(n, -1)
    return x


shaped = DispatchGraph(lambda: shapes(torch.zeros(8)), torch.zeros(16), 1, 8,
                       64, 4)


# tts-lint: traced (a cycle a dispatch graph captures)
def blocked(x, block: int = 1):
    # An int parameter is a Python value under the capture: branching on
    # it specializes the captured graph (the pair-block pattern).
    if block > 1:
        for b in range(x.shape[0] // block):
            x = x + b
        return x
    acc = block * 2
    while acc < 8:  # static: derived from the static param only
        acc *= 2
    return x * acc


# tts-lint: traced (a cycle a dispatch graph captures)
def routed(x, n_active):
    # A kernel wrapper's device test: under a capture the tensor is on the
    # card, so the plain branch, which reads the host, is not captured.
    if x.is_cuda:
        return x * 2
    return x[: int(n_active)].cpu() * 2


def make(problem, M: int, K: int):
    # Every parameter the build reads keys the cache (problem owns it).
    return take_cached(problem, "_programs", (M, K), lambda: (problem, M, K))
