"""``tpu_tree_search_torch.obs`` — the port's telemetry (the port of
`tpu_tree_search/obs/`, with the same knobs, event schema, trace and metrics
formats: a trace from either package reads in the other's ``report``).

Device legs (built into their own dispatch graphs; off, the graphs are
the untelemetered ones node for node):

  * ``counters`` — the per-cycle counter block (``TTS_OBS=1``): popped,
    pushed, leaves, pruned, overflow, pool and survivor high-water marks,
    push rows; folded on the device after every cycle and read once a
    dispatch with the loop state.
  * ``phases`` — the per-phase cycle clock (``TTS_PHASEPROF=1`` /
    ``profile``): ``%globaltimer`` marks between the cycle's launches,
    decomposing the cycle into pop/eval/compact/push/overflow; plus the
    steady-state ``torch.profiler`` window (``TTS_TORCH_TRACE``).

Host legs:

  * ``events`` — structured event tracing: thread-local buffers, merged at
    drain (dispatch spans, incumbents, K resizes, stall fallbacks,
    checkpoint cuts, per-phase ``explored`` samples).
  * ``export`` / ``report`` — Chrome-trace JSON for Perfetto, metrics JSON
    lines, and the ``report`` summarizer; ``roofline`` — the per-phase
    memory-roofline audit; ``quality`` — the anytime incumbent curve
    (``TTS_QUALITY``); ``costmodel`` — measured link profiles
    (``COSTMODEL.json``) from which AdaptiveK resolves its band
    (``TTS_COSTMODEL``).
  * ``flightrec`` — the crash-safe flight recorder (``TTS_FLIGHTREC``);
    ``live`` — ``--obs-serve`` HTTP/SSE snapshots and the ``watch`` client.

Knobs: ``TTS_OBS=1`` (everything), ``TTS_OBS=host`` (host events only —
the graphs untouched), off by default. ``--trace out.json`` /
``--metrics-file m.jsonl`` on the CLI. Nothing here imports torch at
import time: ``report`` runs without it.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

from . import costmodel, counters, events, export, flightrec, live, phases, report

__all__ = [
    "capture",
    "costmodel",
    "counters",
    "events",
    "export",
    "flightrec",
    "live",
    "obs_enabled",
    "phases",
    "report",
]


def obs_enabled() -> bool:
    return events.enabled()


class Capture:
    """Result handle of a ``capture()`` block."""

    def __init__(self):
        self.events: list[dict] = []

    def explored_totals(self) -> tuple[int, int]:
        """(tree, sol) summed over the engines' per-phase ``explored``
        counter samples — the obs-side mirror of
        ``SearchResult.explored_tree/explored_sol`` (tests pin exact
        parity)."""
        tree = sol = 0
        for e in self.events:
            if e.get("name") == "explored":
                a = e.get("args") or {}
                tree += a.get("tree", 0)
                sol += a.get("sol", 0)
        return tree, sol

    def summary(self) -> dict:
        return report.summarize(self.events)


@contextmanager
def capture(trace_path: str | None = None, metrics_path: str | None = None,
            mode: str = "1"):
    """Run-scoped telemetry capture: pins ``TTS_OBS`` to ``mode``
    (``"1"`` full / ``"host"`` events-only), clears the recorder, and on
    exit drains the events into the yielded ``Capture`` (optionally
    writing the trace / metrics files). Restores the previous ``TTS_OBS``
    so a caller's explicit setting is never clobbered.

    Device-counter note: ``mode="1"`` takes effect for programs *built*
    inside the block — a resident program reads the flags when it is made
    and keys its dispatch graphs on them.
    """
    prev = os.environ.get("TTS_OBS")
    os.environ["TTS_OBS"] = mode
    events.reset()
    cap = Capture()
    try:
        yield cap
    finally:
        cap.events = events.drain()
        if prev is None:
            os.environ.pop("TTS_OBS", None)
        else:
            os.environ["TTS_OBS"] = prev
        if trace_path is not None:
            export.write_chrome_trace(cap.events, trace_path)
        if metrics_path is not None:
            export.write_metrics_jsonl(cap.events, metrics_path)
