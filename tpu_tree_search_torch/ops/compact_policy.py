"""The unfused cycle's compaction policy (`ops/compaction.py`), apart from
the compaction itself so that host-only callers (the serve pool's class
key, the fleet router) import no torch."""

from __future__ import annotations

MODES = ("scatter", "dense")


def resolve_compact_mode(problem, M: int, n: int) -> str:
    """The unfused cycle's compaction mode (`compaction.py` ``_auto_compact``
    of the JAX package, its N-Queens and gpu rows)."""
    if getattr(problem, "name", None) == "nqueens":
        return "dense"
    return "dense" if M * n <= (1 << 16) else "scatter"
