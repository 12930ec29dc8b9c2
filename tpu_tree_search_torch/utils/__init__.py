"""Shared runtime utilities: idle-state tracking and termination detection
(the port's copy of `tpu_tree_search/utils/`, without its JAX shims)."""

from .termination import BUSY, IDLE, TaskStates

__all__ = ["BUSY", "IDLE", "TaskStates"]
