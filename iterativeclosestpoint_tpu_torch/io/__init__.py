"""LAS 1.2 point-cloud ingest/egress."""

from iterativeclosestpoint_tpu_torch.io.las import (
    LASHeader,
    read_las,
    read_las_batches,
    write_las,
)

__all__ = ["LASHeader", "read_las", "read_las_batches", "write_las"]
