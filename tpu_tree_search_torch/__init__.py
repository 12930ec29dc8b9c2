"""tpu_tree_search_torch: the PyTorch/CUDA port of tpu_tree_search.

The JAX package beside it stays the reference; this package imports none of
it (and no JAX). Its paths are the device-resident searches
(`engine/resident.py`, with checkpoints) and the chunked-offload searches
(`engine/device.py`) of PFSP (lb1, lb1_d, lb2) and N-Queens, whose bounds,
labels and fused search cycles are CUDA kernels written for Hopper (`csrc/`,
built at first use by `ops/_build.py`), and the host's sequential search
(`engine/sequential.py`). Device entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, which takes the kernels' plain PyTorch
versions. The host phases run on a C++ runtime (`native/`, built with g++
at first use; ``TTS_NATIVE=0`` takes the Python path).

Layout:
  problems/  PFSP and N-Queens plugins, Taillard instances, numpy oracle bounds
  ops/       device selection, tables, kernel wrappers, compaction, build
  csrc/      the CUDA C++ kernels and the C++ host runtime (tts_native.cpp)
  native/    the host runtime's ctypes bindings and g++ build
  pool/      host SoA deque (warm-up, drain, offload, capacity-stall fallback)
  engine/    sequential tier, host phases, offload and device-resident
             engines, checkpoints
  cli.py     ``python -m tpu_tree_search_torch {pfsp,nqueens} ...``
"""

__version__ = "0.1.0"
