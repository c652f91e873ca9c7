"""Parallelism on torch.distributed (port of exllama_tpu/parallel): the
mesh and tensor / data parallelism (``mesh``), sequence parallelism
(``sequence``), joining a world and the pod mesh (``multihost``), a
launcher for worlds of ranks on one machine (``launch``), and the relay by
which rank 0's front end leads the other ranks (``relay``)."""

from exllama_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_axis_sizes,
    shard_params,
    validate_tp,
)

__all__ = ["Mesh", "make_mesh", "mesh_axis_sizes", "shard_params",
           "validate_tp"]
