"""The single-host multi-device paths: one thread per rank over a mesh of
devices (``mesh``), data-parallel ICP with the source split over the
ranks (``sharded``), the target split into x-slabs with a halo and a
collective repair (``partition``), and the edge-sharded pose-graph solve
(``posegraph``). Counterpart of the JAX package's ``parallel/``; its
multi-process ingest (``init_multihost``, ``to_global``,
``parallel/ingest.py``) is ROADMAP P15b."""

from iterativeclosestpoint_tpu_torch.parallel.mesh import Mesh, make_mesh
from iterativeclosestpoint_tpu_torch.parallel.partition import (
    icp_register_partitioned,
    prepare_partition,
)
from iterativeclosestpoint_tpu_torch.parallel.posegraph import (
    optimize_pose_graph_sharded,
)
from iterativeclosestpoint_tpu_torch.parallel.sharded import (
    icp_register_sharded,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "icp_register_sharded",
    "icp_register_partitioned",
    "optimize_pose_graph_sharded",
    "prepare_partition",
]
