"""The multi-device paths: a mesh of ranks over one process's devices or
over the processes of a ``torch.distributed`` group (``mesh``),
data-parallel ICP with the source split over the ranks (``sharded``), the
target split into x-slabs with a halo and a collective repair
(``partition``), the edge-sharded pose-graph solve (``posegraph``), and
the streamed per-process LAS ingest (``ingest``). Counterpart of the JAX
package's ``parallel/``."""

from iterativeclosestpoint_tpu_torch.parallel.ingest import (
    coarse_carry_from_files,
    estimate_partition_grid_params,
    header_center,
    load_las_partitioned_source,
    load_las_partitioned_target,
    load_las_sharded,
    sample_points,
    sample_x_walls,
)
from iterativeclosestpoint_tpu_torch.parallel.mesh import (
    Mesh,
    RankFailed,
    init_multihost,
    make_mesh,
)
from iterativeclosestpoint_tpu_torch.parallel.partition import (
    fill_partition_normals,
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
    "RankFailed",
    "make_mesh",
    "init_multihost",
    "icp_register_sharded",
    "icp_register_partitioned",
    "optimize_pose_graph_sharded",
    "load_las_sharded",
    "load_las_partitioned_target",
    "load_las_partitioned_source",
    "sample_x_walls",
    "sample_points",
    "header_center",
    "estimate_partition_grid_params",
    "coarse_carry_from_files",
    "fill_partition_normals",
    "prepare_partition",
]
