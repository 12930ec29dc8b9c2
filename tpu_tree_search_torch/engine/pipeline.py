"""Speculative dispatch and adaptive K for the resident host loop — the port
of `tpu_tree_search/engine/pipeline.py`.

One dispatch runs up to K device cycles and the host reads back only its
scalars. Enqueueing dispatch k+1 before reading dispatch k's scalars keeps
the device busy across the host's read. Speculation is exact, not
approximate: the loop condition (``size >= m``, the pool's headroom and
``cycles < K``) is evaluated on the device, so a dispatch on a terminated
or stalled pool runs zero cycles and changes no counter.

Knobs
-----

``TTS_PIPELINE``: dispatch queue depth. ``0``/``1`` = synchronous (one
dispatch in flight), ``2``/``3`` = that many dispatches in flight, ``auto``
(default) = 2. The depth never changes a count.

``TTS_K``: the K schedule. An integer pins K; ``auto`` enables the
:class:`AdaptiveK` controller, which measures the host period of each
dispatch and moves K along a geometric ladder toward a target period, so
the engine builds at most ``len(ladder)`` dispatch programs (on the card,
one CUDA graph a rung, `ops/dispatch.py`).

``TTS_COSTMODEL``: a measured cost-model profile (``obs/costmodel.py``)
whose per-dispatch latency fit sets the AdaptiveK band
(``resolve_target_band``).

Not ported: the JAX module's ``@contract`` (``analysis.contracts``, the
program audit of ``tts check``, which has no counterpart in the port).
"""

from __future__ import annotations

import os
from collections import deque

from ..ops.backend import profile_backend

#: Hard cap on the in-flight dispatch queue: beyond 3 the lagged scalars
#: stop informing anything (termination is seen `depth` dispatches late,
#: each a no-op after the fact but still enqueue latency at shutdown).
MAX_DEPTH = 3

#: Default host-period target band (seconds) for ``TTS_K=auto`` on the
#: single-device resident tier: shorter dispatches waste a growing share
#: of wall time on host round trips; longer ones delay termination
#: detection and checkpoint cadence.
RESIDENT_TARGET = (0.100, 0.250)

#: Tighter band for the mesh and dist tiers (ROADMAP A.9): incumbent
#: folds, balancing and exchange happen at dispatch boundaries.
MESH_TARGET = (0.050, 0.150)


def resolve_target_band(
    tier: str,
    default: tuple[float, float],
    problem=None,
    topology: str = "",
    device=None,
) -> tuple[tuple[float, float], str | None]:
    """The AdaptiveK target band for one run: ``(band, source)`` — the JAX
    function (`tpu_tree_search/engine/pipeline.py:67-110`).

    With ``TTS_COSTMODEL=<profile>`` set and a usable entry in it, the band
    derives from the profile's MEASURED per-dispatch latency fit
    (``obs/costmodel.py``) and the source is the entry's key; otherwise
    ``default`` with source None (a missing or corrupt profile too, as the
    JAX ``costmodel.load`` returns None). The profile's backend key is
    ``gpu`` for a run on the card, ``cpu`` for one on the CPU
    (``device``; None: the card when there is one). A band only moves K
    along the ladder: the search's counts do not depend on it."""
    path_env = os.environ.get("TTS_COSTMODEL", "") or ""
    if path_env in ("", "0"):
        return default, None
    from ..obs import costmodel as cm

    profile = cm.load(path_env)
    if not profile:
        return default, None
    hit = cm.lookup(profile, profile_backend(device), topology,
                    cm.shape_class(problem))
    if hit is None:
        return default, None
    key, entry = hit
    band = cm.resolve_band(entry, tier)
    if band is None:
        return default, None
    return band, key


def pipeline_mode() -> str:
    """The raw ``TTS_PIPELINE`` knob (``auto`` default)."""
    return os.environ.get("TTS_PIPELINE", "auto") or "auto"


def resolve_pipeline_depth(knob: str | int | None = None) -> int:
    """Dispatch queue depth: 1 = synchronous, >= 2 = pipelined.

    ``0`` and ``1`` both mean synchronous (``0`` is the natural "off"
    spelling; a queue always holds at least the dispatch being read).
    ``auto`` resolves to 2: speculation is exact at any depth, and one
    speculative dispatch already hides a host round trip.
    """
    if knob is None:
        knob = pipeline_mode()
    if knob == "auto":
        return 2
    try:
        depth = int(knob)
    except (TypeError, ValueError):
        raise ValueError(
            f"TTS_PIPELINE must be 'auto' or an integer 0..{MAX_DEPTH}, "
            f"got {knob!r}"
        ) from None
    if depth < 0 or depth > MAX_DEPTH:
        raise ValueError(
            f"TTS_PIPELINE must be in 0..{MAX_DEPTH} (got {depth}); "
            "0/1 = synchronous, 2/3 = speculative depth"
        )
    return max(1, depth)


def resolve_k(K: int | str, default_max: int) -> tuple[bool, int]:
    """Resolve the K schedule for one search: ``(auto, k)``.

    ``auto=True``: adaptive ladder capped at ``k``; ``auto=False``: fixed
    ``k``. The ``TTS_K`` env knob (``auto`` or an integer) overrides the
    engine parameter, and a parameter of ``"auto"`` (the CLI's ``--K
    auto``) requests adaptation capped at the tier default.
    """
    knob = (os.environ.get("TTS_K") or "").strip()
    if knob:
        if knob == "auto":
            kmax = default_max if isinstance(K, str) else int(K)
            return True, max(1, kmax)
        try:
            return False, max(1, int(knob))
        except ValueError:
            raise ValueError(
                f"TTS_K must be 'auto' or a positive integer, got {knob!r}"
            ) from None
    if isinstance(K, str):
        if K != "auto":
            raise ValueError(f"K must be an integer or 'auto', got {K!r}")
        return True, max(1, default_max)
    return False, max(1, int(K))


class AdaptiveK:
    """Geometric-ladder K controller (``TTS_K=auto``).

    Rungs are ``k_max, k_max/4, k_max/16, ...`` down to 1, at most 8
    (ascending internally); the controller starts on the lowest rung (fast
    first feedback) and, fed one ``observe(period_s, cycles)`` a dispatch,
    climbs one rung when a full-K dispatch at the next rung is still
    predicted inside the target band, and drops rungs when the measured
    period overshoots the band.
    """

    def __init__(self, k_max: int, target: tuple[float, float] | None = None,
                 factor: int = 4):
        k_max = max(1, int(k_max))
        rungs = [k_max]
        while rungs[-1] > 1 and len(rungs) < 8:
            rungs.append(max(1, rungs[-1] // factor))
        self.ladder: tuple[int, ...] = tuple(rungs[::-1])
        self.idx = 0
        self.lo, self.hi = target if target is not None else RESIDENT_TARGET
        self.factor = factor
        self.resizes = 0

    @property
    def K(self) -> int:
        return self.ladder[self.idx]

    def observe(self, period_s: float, cycles: int) -> bool:
        """Feed one dispatch's host period (scalars-ready to scalars-ready)
        and its device cycle count; returns True when K should change (the
        caller switches to its program for the new ``.K``).

        Dispatches can end early (the pool drained below m mid-block), so
        the decision uses the per-cycle rate scaled to a full-K block, not
        the raw period.
        """
        if cycles <= 0 or period_s <= 0.0:
            return False
        per_cycle = period_s / cycles
        est = per_cycle * self.K
        if (self.idx + 1 < len(self.ladder)
                and est * self.factor <= self.hi):
            # The next rung's predicted full block still fits the band:
            # climbing can never overshoot, so no up/down oscillation.
            self.idx += 1
            self.resizes += 1
            return True
        if est > self.hi and self.idx > 0:
            while self.idx > 0 and per_cycle * self.ladder[self.idx] > self.hi:
                self.idx -= 1
            self.resizes += 1
            return True
        return False


class DispatchQueue:
    """Bounded FIFO of in-flight speculative dispatches.

    The engine owns the dispatch call and the scalar read; this class owns
    only the queue mechanics. Entries are ``(out, enqueue_us)``: the
    dispatch's handle on its scalars and its enqueue timestamp.
    """

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.depth

    def push(self, out, enqueue_us: float) -> None:
        if self.full:
            raise RuntimeError(
                f"dispatch queue overfull (depth {self.depth})"
            )
        self._q.append((out, enqueue_us))

    def pop(self):
        """Oldest in-flight dispatch ``(out, enqueue_us)``."""
        return self._q.popleft()

    def drain(self):
        """Yield every remaining entry, oldest first, emptying the queue.
        The engine drains (accumulating the scalar counts: zeros for no-op
        speculative dispatches, real work otherwise) before any action
        that must see coherent totals: termination, K resizes and the
        capacity-stall fallback."""
        while self._q:
            yield self._q.popleft()
