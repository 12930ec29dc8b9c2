"""Problem plugins: PFSP (Branch-and-Bound)."""

from .base import INF_BOUND, DecomposeResult, NodeBatch, Problem
from .pfsp.problem import PFSPProblem

__all__ = ["INF_BOUND", "DecomposeResult", "NodeBatch", "Problem", "PFSPProblem"]
