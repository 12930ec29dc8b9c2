"""Shape-class keyed program pool — the daemon's admission control
(`tpu_tree_search/serve/pool.py`).

The resident engines cache their programs on the problem instance
(``problem._resident_programs``, ``problem._batched_programs``,
``problem._mesh_programs``, keyed by
(m, M, K, capacity, device, cycle, telemetry flags)), each with the CUDA
graphs built on its own state. What a one-shot CLI cannot do is reuse them
across runs: every process rebuilds its problem and its graphs. The pool
closes that gap by making the problem instance the shared resource:
requests map to a **shape class** — (problem family, identity, bound
variant, the resolved compaction mode, tier, m/M/K/D) — and every job of a
class runs against the same problem object, so the second same-class job
finds its program and graphs already built (zero new programs, zero new
graphs).

  * same identity, different class (e.g. two M values) -> same problem
    instance, distinct program-cache entries;
  * same class -> same program entry, a pure cache hit.

The class key is computed without touching process env or torch: the
port's one per-class routing choice, the unfused cycle's compaction mode,
is resolved by the engine's own policy (``resolve_compact_mode``), and the
server-wide knobs are captured once at daemon start.
"""

from __future__ import annotations

import threading
import time


def identity_key(spec: dict) -> tuple:
    """The problem-instance identity: two specs with equal identity share
    one problem object (and therefore one program cache)."""
    if spec["problem"] == "nqueens":
        return ("nqueens", spec["N"], spec["g"])
    return ("pfsp", spec["inst"], spec["lb"], spec["ub"],
            spec.get("lb2_variant", "full"))


def server_env_token() -> tuple:
    """The port's program-shaping knobs, read once per daemon: flipping
    them requires a restart (the telemetry flags select distinct graphs,
    ``TTS_PIPELINE`` and ``TTS_K`` the dispatch, ``TTS_NATIVE`` the host
    phases, ``TTS_COSTMODEL`` AdaptiveK's band)."""
    import os

    return tuple(
        (k, os.environ.get(k))
        for k in ("TTS_OBS", "TTS_PHASEPROF", "TTS_PIPELINE", "TTS_K",
                  "TTS_NATIVE", "TTS_COSTMODEL")
    )


def _problem_shape(spec: dict) -> tuple:
    """(n, machines) without constructing the problem (host-only data)."""
    if spec["problem"] == "nqueens":
        return spec["N"], None
    from ..problems.pfsp import taillard

    return taillard.nb_jobs(spec["inst"]), taillard.nb_machines(spec["inst"])


def resolved_knobs(spec: dict) -> dict:
    """The per-class routing knobs as the engine resolves them, without
    env mutation: ``{"compact": mode, "lb2_pairblock": None}`` — the
    unfused cycle's compaction mode (the job's ``compact``, else
    ``TTS_COMPACT``, an explicit mode as it is and ``auto`` through the
    engine's policy) and no pair block (the port has none)."""
    import os

    from ..ops.compact_policy import auto_compact

    n, _machines = _problem_shape(spec)
    knob = spec.get("compact") or os.environ.get("TTS_COMPACT", "auto")
    if knob == "auto":
        # The policy only reads problem.name; a shim spares building the
        # real problem in the admission path.
        shim = type("S", (), {"name": spec["problem"]})()
        knob = auto_compact(shim, spec["M"], n)
    return {"compact": knob, "lb2_pairblock": None}


def class_key(spec: dict) -> str:
    """The human-readable shape-class token. Everything that selects a
    distinct program is in here; two jobs with equal keys hit the same
    program-cache entry."""
    ident = identity_key(spec)
    knobs = resolved_knobs(spec)
    parts = ["-".join(str(p) for p in ident), spec["tier"],
             f"m{spec['m']}", f"M{spec['M']}"]
    if spec.get("K") is not None:
        parts.append(f"K{spec['K']}")
    if spec["tier"] == "mesh":
        parts.append(f"D{spec.get('D', 1)}")
        if spec.get("mp", 1) != 1:
            parts.append(f"mp{spec['mp']}")
    parts.append(f"compact={knobs['compact']}")
    return "-".join(parts)


_CACHES = ("_resident_programs", "_batched_programs", "_mesh_programs")


def _programs(problem) -> list:
    # Snapshot: a scheduler worker may be inserting a program while a
    # stats request iterates (list() of a dict's values is atomic under
    # the GIL).
    return [p for attr in _CACHES
            for p in list((getattr(problem, attr, None) or {}).values())]


def compile_stats(problem) -> tuple[int, int]:
    """(programs cached on a problem instance, resident, batched and mesh;
    dispatch graphs built on them) — the pool's rebuild accounting unit.
    Measured around each job slice: a warm-class admission must leave both
    deltas at zero (the number ``warmup`` and the job records report)."""
    progs = _programs(problem)
    return len(progs), sum(len(getattr(p, "_graphs", {})) for p in progs)


def resident_pool_bytes(problem) -> int:
    """Device-resident pool bytes across every program cached on a problem
    instance: capacity x the pool's bytes a node (rows and the scalar
    column), times B for a batched program and D for a mesh one
    (`tpu_tree_search/serve/pool.py:140-172`), and a mesh program's balance
    scratch on the card (its staging copy of D // 2 shards). Read at scrape
    time for the ``tts_serve_pool_bytes{cls}`` gauge (Python attributes
    only)."""
    total = 0
    for prog in _programs(problem):
        inner = getattr(prog, "inner", prog)
        per_node = (problem.child_slots * inner.vals_dtype.itemsize
                    + inner.aux_dtype.itemsize)
        copies = int(getattr(prog, "B", 0) or getattr(prog, "D", 0) or 1)
        total += copies * int(inner.capacity) * per_node
        scratch = getattr(prog, "scratch", None)
        if scratch is not None:
            total += scratch.nbytes
    return total


class ClassEntry:
    """One shape class: the shared problem instance plus admission
    bookkeeping. ``warm`` flips after the first job of the class has run —
    later admissions are promised zero new programs and graphs."""

    def __init__(self, key: str, spec: dict, problem):
        self.key = key
        self.spec = dict(spec)  # the first admitting spec (class exemplar)
        self.problem = problem
        self.created = time.time()
        self.jobs_admitted = 0
        self.warm = False

    def stats(self) -> dict:
        progs, steps = compile_stats(self.problem)
        return {
            "class": self.key,
            "jobs_admitted": self.jobs_admitted,
            "warm": self.warm,
            "programs": progs,
            # The JAX record's name (there, jit step-cache entries): here
            # the dispatch graphs built on the class's programs.
            "step_cache_entries": steps,
            "pool_bytes": resident_pool_bytes(self.problem),
        }


class ProgramPool:
    """class key -> ClassEntry, with identity-level problem sharing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._classes = {}  # guarded-by: _lock
        self._problems = {}  # guarded-by: _lock  (identity -> problem)
        self.server_token = server_env_token()

    def admit(self, spec: dict) -> ClassEntry:
        """Map a validated spec to its class entry, constructing the
        shared problem on first contact. Called by the scheduler's
        workers; the constructor runs under the lock — problem construction
        is host-only table building."""
        key = class_key(spec)
        with self._lock:
            entry = self._classes.get(key)
            if entry is None:
                ident = identity_key(spec)
                problem = self._problems.get(ident)
                if problem is None:
                    from .jobs import build_problem

                    problem = build_problem(spec)
                    self._problems[ident] = problem
                entry = ClassEntry(key, spec, problem)
                self._classes[key] = entry
            entry.jobs_admitted += 1
            return entry

    def peek(self, spec: dict) -> dict:
        """Admission-time class info for the submit response (HTTP thread;
        must not build problems): the key plus whether it is already warm."""
        key = class_key(spec)
        with self._lock:
            entry = self._classes.get(key)
            return {"class": key, "warm": entry.warm if entry else False}

    def mark_warm(self, entry: ClassEntry) -> None:
        with self._lock:
            entry.warm = True

    def stats(self) -> list[dict]:
        with self._lock:
            entries = list(self._classes.values())
        return [e.stats() for e in entries]

    def release(self) -> None:
        """Free the programs and graphs cached on every shared problem (the
        daemon's close, once no slice runs)."""
        from ..engine.resident import release_programs

        with self._lock:
            problems = list(self._problems.values())
        for problem in problems:
            release_programs(problem)
