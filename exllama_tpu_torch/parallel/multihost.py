"""Joining a world of ranks, and the pod mesh (port of
exllama_tpu/parallel/multihost.py).

  * :func:`initialize` joins ``torch.distributed`` (the JAX package's
    ``jax.distributed.initialize``): the address, rank and world size from
    the arguments or from torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); a second
    call is a no-op, and so is a call with neither (one rank);
  * :func:`make_pod_mesh` gives the ``("dcn", "dp", "tp")`` mesh: tp and dp
    within a host, the leading axis across hosts. The batch splits over dcn
    and dp together (``Mesh.dp``), tp over the ranks of one host;
  * :func:`local_batch_slice`: the rows of a global batch that this rank's
    data-parallel replica owns (cross-host continuous batching: each
    replica admits into its own slots).

The backend is the caller's: ``"nccl"`` by default, ``"gloo"`` where the
caller names it. NCCL refuses two ranks on one device, so a world of
several ranks on one card needs gloo, and the caller must say so; the port
never switches backend on its own. ``batch_sharding`` and
``pod_cache_sharding`` of the JAX package have no counterpart here: they
place global arrays over a single controller's devices, while a rank of an
SPMD world holds only its own shard from the start (``parallel.mesh``,
``cache.ExLlamaCache``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from exllama_tpu_torch.parallel.mesh import Mesh


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: str = "nccl",
               store=None, timeout: Optional[float] = None) -> bool:
    """Join the world (idempotent). ``init_method`` ("tcp://host:port",
    "file://path"), ``world_size`` and ``rank`` default from torchrun's
    environment; ``store`` (a ``torch.distributed`` store) replaces
    ``init_method``; ``timeout``: seconds a collective may wait (the
    backend's default otherwise). Under ``"nccl"`` the rank's card is
    ``LOCAL_RANK`` (else its rank modulo the cards). Returns whether a
    world was joined:
    with neither arguments nor environment it is one rank and nothing
    happens."""
    if dist.is_initialized():
        return True
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and store is None:
        if "MASTER_ADDR" not in os.environ:
            if world_size not in (None, 1):
                raise ValueError(f"world_size {world_size} without an "
                                 f"address (MASTER_ADDR or init_method)")
            return False
        init_method = "env://"
    if backend == "nccl" and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = dict(backend=backend, world_size=world_size, rank=rank)
    if timeout is not None:
        import datetime

        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method
    dist.init_process_group(**kw)
    return True


def make_pod_mesh(tp: int, dp_per_host: int = 1) -> Mesh:
    """The ``("dcn", "dp", "tp")`` mesh: ``tp * dp_per_host`` ranks a host,
    hosts along the leading axis (one host: a singleton dcn axis)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = tp * dp_per_host
    if world % local:
        raise ValueError(f"tp*dp_per_host={local} does not divide the "
                         f"world's {world} ranks")
    return Mesh(("dcn", "dp", "tp"), (world // local, dp_per_host, tp))


def local_batch_slice(global_batch: int, mesh: Optional[Mesh] = None) -> slice:
    """The rows of a ``global_batch`` owned by this rank's data-parallel
    replica (all of them without a mesh)."""
    dp = 1 if mesh is None else mesh.dp
    if global_batch % dp:
        raise ValueError(f"batch {global_batch} does not split over dp {dp}")
    per = global_batch // dp
    r = 0 if mesh is None else mesh.dp_rank
    return slice(r * per, (r + 1) * per)
