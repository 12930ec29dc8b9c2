"""Known-bad fixture: program caches whose key leaves out a parameter their
build reads (the torch twin of tests/data/lint/bad_static_args.py)."""
from tpu_tree_search_torch.engine.resident import take_cached


def build(*args):
    return args

def decorated(problem, m: int, flip: bool):
    return take_cached(problem, "_programs", (), lambda: build(m, flip))  # BAD x2


def partial_ok(problem, m: int):  # OK: m keys the cache
    return take_cached(problem, "_programs", (m,), lambda: build(m))


def stepper(problem, k: int, best):  # BAD: k left out of the key below
    # The key holds best alone: a program built for one k would serve a
    # search that asks for another, with the graphs captured for the
    # first. (The JAX twin's jax.jit(stepper) call site is this take_cached
    # call.)
    #
    # The problem argument owns the cache: it needs no key.
    return take_cached(problem, "_steps", (best,), lambda: build(k, best))


def clean(problem, best):  # OK: every parameter the build reads is keyed
    return take_cached(problem, "_clean", (best,), lambda: build(best))


clean_program = clean(None, 0)
