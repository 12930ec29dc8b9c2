"""tpu_tree_search_torch: the PyTorch/CUDA port of tpu_tree_search.

The JAX package beside it stays the reference; this package imports none of
it (and no JAX). Its paths are the device-resident searches
(`engine/resident.py`) of PFSP (lb1, lb1_d) and N-Queens, whose bounds,
labels and fused search cycles are CUDA kernels written for Hopper (`csrc/`,
built at first use by `ops/_build.py`). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, which takes the kernels' plain PyTorch
versions.

Layout:
  problems/  PFSP and N-Queens plugins, Taillard instances, numpy oracle bounds
  ops/       device selection, tables, kernel wrappers, compaction, build
  csrc/      the CUDA C++ kernels
  pool/      host SoA deque (warm-up, drain, capacity-stall fallback)
  engine/    host phases and the device-resident engine
  cli.py     ``python -m tpu_tree_search_torch {pfsp,nqueens} ...``
"""

__version__ = "0.1.0"
