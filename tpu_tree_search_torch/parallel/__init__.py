"""Parallel runtimes of the port (`tpu_tree_search/parallel/`): the
multi-device tier (host threads, one private pool and one offloader a
worker, work stealing, idle-scan termination; `multidevice.py`), the
mesh-resident tier (D pool shards in one program on one or several device
positions, one CUDA graph a dispatch and group with the incumbent fold
and the ring diffusion, the lb2 pair axis ``mp``; `resident_mesh.py`),
the multi-host tiers on them: ``dist`` (each host the multi tier's workers
with an inter-host communicator; `dist.py`, with the collectives of
virtual hosts and of a process a host) and ``dist_mesh`` (each host a
mesh, exchanging at dispatch boundaries; `dist_mesh.py`), with the steal
topology of `topology.py`; and the library's chunk evaluator over a (dp,
mp) mesh of device positions (`mesh.py`, ``make_mesh``,
``MeshEvaluator``).
"""

from .dist import dist_search
from .dist_mesh import dist_mesh_search
from .mesh import MeshEvaluator, make_mesh
from .multidevice import host_pipeline, multidevice_search, run_workers
from .resident_mesh import get_mesh_program, mesh_resident_search

__all__ = ["MeshEvaluator", "dist_mesh_search", "dist_search",
           "get_mesh_program", "host_pipeline", "make_mesh",
           "mesh_resident_search", "multidevice_search", "run_workers"]
