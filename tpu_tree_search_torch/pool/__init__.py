"""Host-side work pools (SoA deques)."""

from .pool import ParallelSoAPool, SoAPool

__all__ = ["ParallelSoAPool", "SoAPool"]
