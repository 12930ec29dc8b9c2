"""Parallel runtimes of the port (`tpu_tree_search/parallel/`): the
multi-device tier (host threads, one private pool and one offloader a
worker, work stealing, idle-scan termination; `multidevice.py`), the
mesh-resident tier (D pool shards in one program, one CUDA graph a
dispatch with the incumbent fold and the ring diffusion;
`resident_mesh.py`), and the multi-host tiers on them: ``dist`` (each host
the multi tier's workers with an inter-host communicator; `dist.py`, with
the collectives of virtual hosts and of a process a host) and
``dist_mesh`` (each host a mesh, exchanging at dispatch boundaries;
`dist_mesh.py`), with the steal topology of `topology.py`. The mesh's
``--mp`` axis and shards on several cards are ROADMAP.md A.9's steps 3-4.
"""

from .dist import dist_search
from .dist_mesh import dist_mesh_search
from .multidevice import host_pipeline, multidevice_search, run_workers
from .resident_mesh import get_mesh_program, mesh_resident_search

__all__ = ["dist_mesh_search", "dist_search", "get_mesh_program",
           "host_pipeline", "mesh_resident_search", "multidevice_search",
           "run_workers"]
