"""Search engines: the sequential tier, the host phases and the offload
engine, the device-resident engine, and checkpoints."""

from .device import device_search
from .resident import pool_from_numpy, resident_search
from .results import SearchResult
from .sequential import sequential_search

__all__ = ["SearchResult", "device_search", "pool_from_numpy",
           "resident_search", "sequential_search"]
