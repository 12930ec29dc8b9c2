"""Problem plugins: PFSP (Branch-and-Bound) and N-Queens (backtracking)."""

from .base import INF_BOUND, DecomposeResult, NodeBatch, Problem
from .nqueens import NQueensProblem
from .pfsp.problem import PFSPProblem

__all__ = ["INF_BOUND", "DecomposeResult", "NodeBatch", "NQueensProblem",
           "Problem", "PFSPProblem"]
