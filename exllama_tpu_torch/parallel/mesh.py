"""Tensor and data parallelism on torch.distributed (port of
exllama_tpu/parallel/mesh.py).

The JAX package is single-controller: one process drives every device of a
``("dp", "tp")`` mesh through ``shard_map``, which hands each device its
shard of globally placed arrays. The port follows PyTorch's SPMD idiom
instead: one process a rank (``torchrun``, or ``parallel.launch``), each
holding only its own shard and running the same program. The semantics are
the JAX package's:

  * ``tp`` (Megatron pairing): q / k / v / gate / up keep this rank's
    output columns, o / down its input rows, so a layer needs one
    all-reduce after o and one after down (``models.llama``); the
    embedding, the norms, the rope tables and the lm_head are whole on
    every rank, and every rank computes the head (the JAX package
    replicates it the same way, mesh.py:217-219), so every rank holds the
    same logits and, from the same seeded generator, samples the same
    token;
  * ``dp``: the batch rows of the activations and of the KV cache; a batch
    that ``dp`` does not divide (the engine's B = 1 admission scratch) is
    computed whole on every replica, as the JAX package does;
  * the KV cache of a rank holds ``kv_heads / tp`` heads and ``B / dp``
    rows (``cache.ExLlamaCache`` reads the model's mesh).

``Mesh`` is the port's mesh: named axes over the ranks of the world,
row-major as the JAX package reshapes its device list (the last axis varies
fastest), with one process group per axis of size > 1. Uneven splits use
a uniform chunk with zero-padded tails (``formats.gptq.tp_chunk``), aligned
to the port's own K rule (whole groups of a multiple of 32 rows), not the
JAX package's 128-lane step. Differences from the JAX package on purpose:
SPMD instead of a single controller; the head on every rank; the eager
decode step under tp (``generator.DecodeLoop``: a gloo collective cannot
be captured in a CUDA graph); the alignment step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from exllama_tpu_torch.formats.gptq import (
    slice_in_rows,
    slice_out_columns,
    tp_chunk,
    tp_row_step,
)

# the axes over which the batch splits; their sizes multiply into ``dp``
BATCH_AXES = ("dcn", "dp")


class Mesh:
    """Named axes over the world's ranks (row-major: rank = the mixed-radix
    number of its coordinates, the last axis fastest) and, per axis of size
    > 1, the process group of the ranks that differ from this one only
    there. ``dp`` is the product of the batch axes (``"dcn"`` and
    ``"dp"``), with one group over them together. Every rank of the world
    must build the same meshes in the same order (process groups are made
    collectively). A mesh of one rank needs no initialised world."""

    def __init__(self, axis_names, shape):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        assert len(self.axis_names) == len(self.shape)
        size = math.prod(self.shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if size != world:
            raise ValueError(f"a {dict(zip(self.axis_names, self.shape))} "
                             f"mesh needs {size} ranks, the world has "
                             f"{world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = dict(zip(self.axis_names,
                               np.unravel_index(self.rank, self.shape)))
        self.coords = {k: int(v) for k, v in self.coords.items()}
        self._groups = {}
        self._ranks = {}
        # the batch axes of more than one rank (their group is the dp group)
        self._batch = tuple(a for a in BATCH_AXES if self.size(a) > 1)
        sets = [(a,) for a in self.axis_names]
        if len(self._batch) > 1:
            sets.append(self._batch)
        for axes in sets:
            self._make_groups(axes)

    def _make_groups(self, axes):
        sizes = [self.size(a) for a in axes]
        if math.prod(sizes) == 1:
            return
        idx = np.arange(math.prod(self.shape)).reshape(self.shape)
        moved = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.shape)) if i not in moved]
        blocks = idx.transpose(rest + moved).reshape(-1, math.prod(sizes))
        for row in blocks:
            ranks = [int(r) for r in row]
            group = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups[axes] = group
                self._ranks[axes] = ranks

    def size(self, axis) -> int:
        """Ranks along ``axis`` (a name or a tuple of names; absent: 1)."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        return math.prod(dict(zip(self.axis_names, self.shape)).get(a, 1)
                         for a in axes)

    def coord(self, axis) -> int:
        """This rank's index along ``axis`` (a tuple: mixed radix)."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        c = 0
        for a in axes:
            c = c * self.size(a) + self.coords.get(a, 0)
        return c

    def group(self, axis):
        """The process group along ``axis``; None where it has one rank."""
        return self._groups.get(axis if isinstance(axis, tuple) else (axis,))

    def ranks(self, axis) -> list:
        """The global ranks of this rank's group along ``axis``, in order."""
        key = axis if isinstance(axis, tuple) else (axis,)
        return self._ranks.get(key, [self.rank])

    # the three axes the model reads
    @property
    def tp(self) -> int:
        return self.size("tp")

    @property
    def dp(self) -> int:
        return self.size(self._batch) if self._batch else 1

    @property
    def sp(self) -> int:
        return self.size("sp")

    @property
    def tp_rank(self) -> int:
        return self.coord("tp")

    @property
    def dp_rank(self) -> int:
        return self.coord(self._batch) if self._batch else 0

    @property
    def sp_rank(self) -> int:
        return self.coord("sp")

    @property
    def dp_group(self):
        return self.group(self._batch) if self._batch else None

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"rank {self.rank})")


def make_mesh(tp: int = 1, dp: int = 1) -> Mesh:
    """The ``("dp", "tp")`` mesh over a world of ``tp * dp`` ranks."""
    return Mesh(("dp", "tp"), (dp, tp))


def mesh_axis_sizes(mesh) -> "tuple[int, int]":
    """(dp, tp) sizes of a mesh (1 for absent axes; None: (1, 1))."""
    if mesh is None:
        return 1, 1
    return mesh.dp, mesh.tp


def validate_tp(config, tp: int) -> None:
    """What a tp-way split needs: heads and kv heads whole on every rank
    (attention runs on local heads over a head-split cache). The JAX
    package also asks head_dim % 128, a TPU lane rule; the port's kernels
    take the same head dims at tp > 1 as at 1 (K3, else the einsum route)."""
    if tp == 1:
        return
    problems = []
    if config.num_attention_heads % tp:
        problems.append(f"num_attention_heads {config.num_attention_heads} "
                        f"% tp")
    if config.num_key_value_heads % tp:
        problems.append(f"num_key_value_heads {config.num_key_value_heads} "
                        f"% tp")
    if problems:
        raise ValueError(f"config not tp={tp}-shardable: {problems}")


# ---------------------------------------------------------------------------
# This rank's parameters
# ---------------------------------------------------------------------------

def shard_layer(lp, tp: int, rank: int, fuse: bool = True):
    """This rank's slices of one unfused layer (mesh.py:73-134): q / k / v
    by output column (whole heads), o by input row (exactly qdim / tp, whole
    groups), gate / up by output column and down by input row at one
    uniform chunk (``tp_chunk`` at the kernels' K step: a zero tail where
    intermediate / tp is not whole groups, so a padded gate / up column
    gives silu(0) * 0 = 0 and a padded down row adds 0); then, with
    ``fuse``, q / k / v -> qkv and gate / up -> gateup on the rank, except
    for act-order layers (``fuse_layer_projections``)."""
    from exllama_tpu_torch.models.llama import fuse_layer_projections

    if lp.qkv is not None or lp.gateup is not None:
        raise ValueError("tensor parallelism slices unfused projections: "
                         "load unfused (the loader fuses after slicing)")
    if lp.down.x_map is not None:
        raise ValueError(
            "act-order down_proj under tensor parallelism requires the "
            "load-time fold (tuning.fold_act_order=True): its x_map "
            "crosses the row split")
    c_mlp = tp_chunk(lp.down.in_features, tp, tp_row_step(lp.down))
    c_o = lp.o.in_features // tp
    if lp.o.in_features % tp or c_o % tp_row_step(lp.o):
        raise ValueError(f"o_proj K split {lp.o.in_features} / {tp} not in "
                         f"whole groups of {tp_row_step(lp.o)}")
    lp = dataclasses.replace(
        lp,
        q=slice_out_columns(lp.q, tp, rank),
        k=slice_out_columns(lp.k, tp, rank),
        v=slice_out_columns(lp.v, tp, rank),
        o=slice_in_rows(lp.o, tp, rank, chunk=c_o),
        gate=slice_out_columns(lp.gate, tp, rank, chunk=c_mlp),
        up=slice_out_columns(lp.up, tp, rank, chunk=c_mlp),
        down=slice_in_rows(lp.down, tp, rank, chunk=c_mlp),
    )
    return fuse_layer_projections(lp) if fuse else lp


def shard_params(params, mesh: Optional[Mesh], fuse: bool = True):
    """This rank's ``ModelParams`` on ``mesh`` (mesh.py:265): at tp > 1
    every layer through ``shard_layer``; the embedding, the norms, the rope
    tables and the lm_head stay whole. The result carries the mesh
    (``ModelParams.mesh``), which ``forward_chunk`` reads."""
    if mesh is None:
        return params
    if params.mesh is not None:
        raise ValueError(f"params already on {params.mesh}")
    tp = mesh.tp
    layers = params.layers
    if tp > 1:
        layers = [shard_layer(lp, tp, mesh.tp_rank, fuse) for lp in layers]
    return dataclasses.replace(params, layers=layers, mesh=mesh)


# ---------------------------------------------------------------------------
# Collectives (plain torch.distributed calls; no host copies of our own)
# ---------------------------------------------------------------------------

def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The Megatron reduction of a row-parallel partial (JAX ``psum``):
    summed in f32 over ``group`` and rounded once to x's dtype. The
    partials come in as the kernels wrote them, each already rounded to
    bf16 (the JAX package's psum takes bf16 partials too), so a tp route
    rounds tp + 1 times where the unsplit product rounds once. Every rank
    receives the same bits."""
    if group is None:
        return x
    s = x.to(torch.float32)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return s.to(x.dtype)


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order (JAX
    ``all_gather(tiled=True)``): one ``all_gather_into_tensor`` along a
    leading dim, moved back to ``dim``."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0], *front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)
