"""Search drivers: host phases and the device-resident engine."""

from .resident import pool_from_numpy, resident_search
from .results import SearchResult

__all__ = ["SearchResult", "pool_from_numpy", "resident_search"]
