"""Known-bad fixture: host syncs in captured code (the torch twin of
tests/data/lint/bad_host_sync.py, line for line)."""
import numpy as np
import torch

from tpu_tree_search_torch.ops.dispatch import BatchGraph, DispatchGraph


# tts-lint: traced (a cycle a dispatch graph captures)
def decorated_step(pool, size):
    total = pool.sum()
    return total.item()  # BAD: .item() under capture


def helper(x):
    return float(x) + 1.0  # BAD via call closure: float() on a tensor


def body(st):
    x = st[0]
    np.asarray(x)  # BAD: np.asarray in the captured cycle
    return helper(x), st + 1


def cond(st):
    return st[1] < 10


def run(st):
    return DispatchGraph(lambda: body(st), st, 1, 8, 64, 4)


def bound_step(pool, best):
    torch.cuda.synchronize()  # BAD: a wait in a captured cycle
    pool.cpu()  # BAD: a copy to the host in a captured cycle
    return pool.min(best)


run_graph = BatchGraph([bound_step], torch.zeros(1, 16), 1, 8, 64, 4)


# tts-lint: traced
def marked(frontier):
    return int(frontier[0])  # BAD: int() on a tensor (marker form)
