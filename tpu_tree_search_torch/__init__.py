"""tpu_tree_search_torch: the PyTorch/CUDA port of tpu_tree_search.

The JAX package beside it stays the reference; this package imports none of
it (and no JAX). Its main path is the device-resident PFSP lb1 search
(`engine/resident.py`), whose bound and fused search cycle are CUDA kernels
written for Hopper (`csrc/`, built at first use by `ops/_build.py`). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``, which takes
the kernels' plain PyTorch versions.

Layout:
  problems/  PFSP plugin, Taillard instances, numpy oracle bounds
  ops/       device selection, tables, kernel wrappers, compaction, build
  csrc/      the CUDA C++ kernels
  pool/      host SoA deque (warm-up, drain, capacity-stall fallback)
  engine/    host phases and the device-resident engine
  cli.py     ``python -m tpu_tree_search_torch pfsp ...``
"""

__version__ = "0.1.0"
