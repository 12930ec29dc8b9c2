"""Parallel runtimes of the port: the multi-device tier (host threads, one
private pool and one offloader a worker, work stealing, idle-scan
termination; `multidevice.py`) and the mesh-resident tier (D pool shards in
one program, one CUDA graph a dispatch with the incumbent fold and the ring
diffusion; `resident_mesh.py`). The port of `tpu_tree_search/parallel/`'s
single-host tiers; the multi-host ones are ROADMAP.md A.9's second half.
"""

from .multidevice import host_pipeline, multidevice_search, run_workers
from .resident_mesh import get_mesh_program, mesh_resident_search

__all__ = ["get_mesh_program", "host_pipeline", "mesh_resident_search",
           "multidevice_search", "run_workers"]
