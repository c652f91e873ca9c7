"""Parallelism on torch.distributed (port of exllama_tpu/parallel): the
mesh and tensor / data parallelism (``mesh``), sequence parallelism
(``sequence``), joining a world and the pod mesh (``multihost``), and a
launcher for worlds of ranks on one machine (``launch``)."""

from exllama_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_axis_sizes,
    shard_params,
    validate_tp,
)

__all__ = ["Mesh", "make_mesh", "mesh_axis_sizes", "shard_params",
           "validate_tp"]
