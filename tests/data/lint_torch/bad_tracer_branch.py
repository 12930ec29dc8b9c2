"""Known-bad fixture: Python control flow on tensors in captured code
(the torch twin of tests/data/lint/bad_tracer_branch.py, line for line)."""
import torch
from tpu_tree_search_torch.ops.dispatch import DispatchGraph


# tts-lint: traced (a cycle a dispatch graph captures)
def prune(bounds, best):
    if bounds.min() < best:  # BAD: `if` on a tensor comparison
        best = bounds.min()
    n = 0
    while best > 0:  # BAD: `while` on a tensor
        n += 1
    size = bounds.shape[0]
    if size > 128:  # OK: shape metadata is static
        return best
    return torch.minimum(best, torch.zeros_like(best))


def kernel(x, flag):
    y = x * 2
    z = y + 1
    if z.sum() > 0:  # BAD: a derived tensor (assignment chain)
        return z
    if flag is None:  # OK: identity check is static
        return x
    return y


wrapped = DispatchGraph(kernel, torch.zeros(16), 1, 8, 64, 4)


# The JAX twin's static_argnames param: a parameter annotated int.


# tts-lint: traced (a cycle a dispatch graph captures)
def rebound(x, k: int):
    k = x.sum()  # rebind: the static name now carries a tensor
    if k > 0:  # BAD: branch on the re-tainted name
        return x
    return x * 2
