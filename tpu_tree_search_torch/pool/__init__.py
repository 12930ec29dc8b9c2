"""Host-side work pool (SoA deque)."""

from .pool import SoAPool

__all__ = ["SoAPool"]
