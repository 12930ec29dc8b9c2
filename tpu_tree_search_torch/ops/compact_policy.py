"""The unfused cycle's compaction policy (`ops/compaction.py`), apart from
the compaction itself so that host-only callers (the serve pool's class
key, the fleet router, the CLI) import no torch."""

from __future__ import annotations

import os

MODES = ("scatter", "sort", "search", "dense")


def compact_mode() -> str:
    """The raw ``TTS_COMPACT`` knob: one of ``MODES`` or ``auto`` (the
    default, resolved per shape by ``resolve_compact_mode``); the JAX
    ``compact_mode`` and its error text."""
    mode = os.environ.get("TTS_COMPACT", "auto")
    if mode != "auto" and mode not in MODES:
        raise ValueError(
            "TTS_COMPACT must be 'auto', 'scatter', 'sort', 'search', or "
            f"'dense', got {mode!r}"
        )
    return mode


def auto_compact(problem, M: int, n: int) -> str:
    """The ``auto`` policy: the JAX ``_auto_compact`` rows that apply here
    (`compaction.py`): N-Queens ``dense``; otherwise the gpu row, ``dense``
    for grids of at most 2^16 slots and ``scatter`` above."""
    if getattr(problem, "name", None) == "nqueens":
        return "dense"
    return "dense" if M * n <= (1 << 16) else "scatter"


def resolve_compact_mode(problem, M: int, n: int) -> str:
    """The unfused cycle's compaction mode: the explicit ``TTS_COMPACT``
    when set, else ``auto_compact``."""
    mode = compact_mode()
    return mode if mode != "auto" else auto_compact(problem, M, n)


def auto_chosen(compact: str | None) -> bool:
    """A result's ``compact_auto``: whether the ``auto`` policy chose the
    mode ``compact`` a program baked in (None, the fused cycle: False)."""
    return compact is not None and compact_mode() == "auto"
