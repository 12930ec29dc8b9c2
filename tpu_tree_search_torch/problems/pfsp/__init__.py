"""PFSP problem family: Taillard instances, numpy oracle bounds, plugin."""

from . import bounds, taillard
from .problem import PFSPProblem

__all__ = ["bounds", "taillard", "PFSPProblem"]
