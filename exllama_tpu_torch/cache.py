"""Preallocated KV cache (port of exllama_tpu/cache.py:ExLlamaCache).

One [B, Hkv, S_max, D] tensor per layer for K and for V, plus the host-side
position cursor ``current_seq_len``. ``TuningParams.kv_cache_dtype`` picks
the storage: bf16; int8 (one byte an element); or int4 (int8 bytes
[.., D/2], two elements a byte, ops/attention.quantize_kv_rows4). The
quantized caches carry ``k_scale`` / ``v_scale``, one f32 [B, Hkv, S_max]
tensor per layer (None for bf16). With ``pad_head_dim`` a bf16 / int8
cache of a head_dim that kernel K3 does not take is stored at the next
width it does (64, else a multiple of 128). At Llama-7B, S_max 2048, B 1
the tensors hold 1.00 GiB in bf16, 0.50 GiB + 16 MiB of scales in int8,
0.25 GiB + 16 MiB in int4.

Unlike the JAX version, whose arrays are immutable and rebound after each
step, the port updates these tensors IN PLACE (ops/attention.update_kv_cache,
and commit_kv_cache for the deferred rows of a decode step; ``roll_left``
and ``copy_states`` here too); ``clone`` copies them. Since they never move,
``kv_ptrs`` -- the device array of their base pointers that the batched
commit kernel K8 reads -- is built once, here, with K8's other operands:
``rows``, a bf16 [2, L, B, 1, Hkv, D] buffer into which a decode step's
layers write their K (``rows[0, l]``) and V (``rows[1, l]``) rows for the
commit (D: the width attended, head_dim or the padded one), and
``cursor``, an int32 [1] device buffer that ``forward_chunk`` fills with a
decode step's int cursor, once, for every kernel of the step (K3 / K7 and
K8) to read. A step given the cursor itself (``generator.DecodeLoop``, the
captured decode step) reads it and advances it on the device.

On a mesh (the model's, ``parallel.mesh``) a rank's cache holds its own
part: kv_heads / tp heads and, where dp divides the batch, B / dp rows
(``local_cache_dims``); a sequence-parallel rank keeps S / sp positions
(``parallel.sequence.shard_cache_sp``).

Beam search keeps a second cache whose rows are the beams: ``take_rows``
gathers its rows by parent and ``keep_rows`` cuts it to the first k (the
JAX package's ``_map_state`` with ``take`` / a slice), on every member, in
place: the gather goes through a temporary that is copied back into the
first rows of the same storage, and every member becomes a view of those
rows. So the tensors' addresses, and ``kv_ptrs``, stay those that a
captured graph holds, and beam steps replay the forward's graphs (one per
batch size). Only a gather to more rows than the storage holds
(``capacity``) allocates anew, and drops the cache's graphs.

``graphs`` (a ``graphs.GraphTable``) holds the graphs ``ExLlama.forward``
captured on this cache (models/llama.py), keyed by the chunk's shape and
static choices; they die with the cache.
"""

from __future__ import annotations

import math

import torch

from exllama_tpu_torch.graphs import GraphTable
from exllama_tpu_torch.ops.attention import kv_ptr_array


def stored_head_dim(head_dim: int, kv_cache_dtype: str, pad: bool) -> int:
    """Last dim of a cache tensor (cache.py:124-134): D/2 bytes for int4;
    with ``pad`` the next width K3 takes; else head_dim."""
    if kv_cache_dtype == "int4":
        return head_dim // 2
    if pad and head_dim != 64 and head_dim % 128:
        return 64 if head_dim < 64 else -(-head_dim // 128) * 128
    return head_dim


def local_cache_dims(batch: int, kv_heads: int, mesh=None):
    """(batch rows, kv heads) of one rank's cache (mesh.py:288-308): the
    heads split over tp; the rows over dp where dp divides them, else whole
    on every data-parallel replica (the engine's B = 1 scratch)."""
    if mesh is None:
        return batch, kv_heads
    if kv_heads % mesh.tp:
        raise ValueError(f"kv_heads {kv_heads} do not split over tp "
                         f"{mesh.tp}")
    if mesh.dp > 1 and batch % mesh.dp == 0:
        batch //= mesh.dp
    return batch, kv_heads // mesh.tp


class ExLlamaCache:
    def __init__(
        self,
        model=None,
        *,
        batch_size: int = 1,
        max_seq_len: "int | None" = None,
        copy_from: "ExLlamaCache | None" = None,
    ):
        if copy_from is not None:
            self.batch_size = copy_from.batch_size
            self.max_seq_len = copy_from.max_seq_len
            self.shape = copy_from.shape
            self.device = copy_from.device
            self.dtype = copy_from.dtype
            self.k = [t.clone() for t in copy_from.k]
            self.v = [t.clone() for t in copy_from.v]
            self.k_scale = self.v_scale = None
            if copy_from.k_scale is not None:
                self.k_scale = [t.clone() for t in copy_from.k_scale]
                self.v_scale = [t.clone() for t in copy_from.v_scale]
            self._rows_flat = torch.empty(
                (copy_from.rows.numel(),), dtype=copy_from.rows.dtype,
                device=copy_from.rows.device)
            self.rows = self._rows_flat.view(copy_from.rows.shape)
            self.cursor = torch.zeros_like(copy_from.cursor)
            self.current_seq_len = copy_from.current_seq_len
            self._adopt_storage()
            return

        if model is None:
            raise ValueError("need model= or copy_from=")
        cfg = model.config
        tune = cfg.tuning
        batch, kv_heads = local_cache_dims(
            batch_size or cfg.batch_size, cfg.num_key_value_heads,
            getattr(model, "mesh", None))
        shape = (
            cfg.num_hidden_layers,
            batch,
            max_seq_len or cfg.max_seq_len,
            kv_heads,
            cfg.head_dim,
        )
        self.batch_size = shape[1]
        self.max_seq_len = shape[2]
        self.shape = shape
        self.device = model.device
        quantized = tune.kv_cache_dtype != "bf16"
        self.dtype = torch.int8 if quantized else torch.bfloat16
        d_store = stored_head_dim(shape[4], tune.kv_cache_dtype,
                                  tune.pad_head_dim)
        layer_shape = (shape[1], shape[3], shape[2], d_store)  # B, Hkv, S, D*

        def layers(shp, dtype):
            return [torch.zeros(shp, dtype=dtype, device=self.device)
                    for _ in range(shape[0])]

        self.k = layers(layer_shape, self.dtype)
        self.v = layers(layer_shape, self.dtype)
        self.k_scale = self.v_scale = None
        if quantized:
            self.k_scale = layers(layer_shape[:3], torch.float32)
            self.v_scale = layers(layer_shape[:3], torch.float32)
        d_rows = shape[4] if tune.kv_cache_dtype == "int4" else d_store
        rows = (2, shape[0], shape[1], 1, shape[3], d_rows)
        self._rows_flat = torch.empty((math.prod(rows),),
                                      dtype=torch.bfloat16, device=self.device)
        self.rows = self._rows_flat.view(rows)
        self.cursor = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self.current_seq_len = 0
        self._adopt_storage()

    def _adopt_storage(self):
        """Take the members as they are as the cache's storage (its
        ``capacity`` rows), build ``kv_ptrs`` over them, and start with no
        graphs (also after a member was reassigned elsewhere:
        ``parallel.sequence.shard_cache_sp``)."""
        self._full = [list(ts) for ts in self._tensor_lists()]
        self.capacity = self.batch_size
        self.kv_ptrs = kv_ptr_array(self.k, self.v, self.k_scale,
                                    self.v_scale)
        self.graphs = GraphTable()

    def _tensor_lists(self):
        """The two or four per-layer lists; axes 0..2 of every tensor are
        B, Hkv, S."""
        return [x for x in (self.k, self.v, self.k_scale, self.v_scale)
                if x is not None]

    def nbytes(self) -> int:
        """Bytes of the cache tensors, scales included."""
        return sum(t.numel() * t.element_size()
                   for ts in self._tensor_lists() for t in ts)

    def zero(self):
        for ts in self._tensor_lists():
            for t in ts:
                t.zero_()
        self.current_seq_len = 0

    def clone(self) -> "ExLlamaCache":
        return ExLlamaCache(copy_from=self)

    def roll_left(self):
        """Drop position 0 and shift everything left by one, position 0
        wrapping to the end (cache.py:169), in place."""
        for ts in self._tensor_lists():
            for t in ts:
                t.copy_(torch.roll(t, -1, dims=2))
        self.current_seq_len -= 1

    def take_rows(self, index):
        """Keep the batch rows ``index`` (a [k] int tensor or list, in that
        order, repeats allowed) of every member -- K, V, the scales and the
        staged rows: the gather of beam rows by parent
        (exllama_tpu/generator.py:819-823). In place within ``capacity``
        rows (see the module docstring); ``batch_size`` and ``shape``
        follow; the shared [1] cursor stays."""
        idx = torch.as_tensor(index, dtype=torch.long).to(self.device)
        self._set_rows(lambda t, dim=0: t.index_select(dim, idx), idx.numel())

    def keep_rows(self, k: int):
        """Every member cut to its first ``k`` batch rows (views of the same
        storage; the JAX ``_map_state(lambda x: x[:k])``,
        generator.py:786-799). Within ``capacity`` a larger ``k`` widens
        the views again; the rows past the last ``batch_size`` hold stale
        values."""
        if k > self.capacity:
            raise ValueError(f"keep_rows({k}): the cache holds "
                             f"{self.capacity} rows")
        self._set_rows(None, k)

    def _set_rows(self, gather, b: int):
        """Every member as the first ``b`` rows of its storage, those rows
        first written with ``gather(member)`` where it is given (a new
        tensor: the storage is written after it is read)."""
        grow = b > self.capacity
        for ts, full in zip(self._tensor_lists(), self._full):
            for i, t in enumerate(ts):
                new = None if gather is None else gather(t)
                if grow:
                    full[i] = torch.empty((b, *t.shape[1:]), dtype=t.dtype,
                                          device=t.device)
                ts[i] = full[i][:b]
                if new is not None:
                    ts[i].copy_(new)
        shape = (*self.rows.shape[:2], b, *self.rows.shape[3:])
        # the staged rows: batch is their third axis, so a cut re-lays them
        # out in the storage (a copy; widened rows hold stale values)
        new = (gather(self.rows, 2) if gather is not None
               else self.rows[:, :, :b].clone() if b <= self.rows.shape[2]
               else None)
        if grow:
            self._rows_flat = torch.empty((math.prod(shape),),
                                          dtype=self.rows.dtype,
                                          device=self.rows.device)
        self.rows = self._rows_flat[:math.prod(shape)].view(shape)
        if new is not None:
            self.rows.copy_(new)
        self.batch_size = b
        self.shape = (self.shape[0], b, *self.shape[2:])
        if grow:
            self._adopt_storage()

    def copy_states(
        self,
        target: "ExLlamaCache",
        from_column: int,
        from_columns: int,
        to_column: int,
        to_columns: int,
        from_row: int = 0,
        from_rows: int = 1,
        to_row: int = 0,
        to_rows: int = 1,
    ):
        """Rectangle copy between caches (cache.py:177): ``from_columns``
        cache positions from ``from_column`` of ``from_rows`` batch rows from
        ``from_row`` go into ``target`` at ``to_column`` / ``to_row``, one
        row broadcast over ``to_rows`` rows and one column over
        ``to_columns`` columns. Writes ``target``'s tensors in place."""
        if from_columns != to_columns and from_columns != 1:
            raise ValueError("copy_states: from_columns must equal "
                             "to_columns or be 1")
        for srcs, dsts in zip(self._tensor_lists(), target._tensor_lists()):
            for src, dst in zip(srcs, dsts):
                s = src[from_row : from_row + from_rows, :,
                        from_column : from_column + from_columns]
                rows = to_rows if from_rows == 1 else from_rows
                cols = to_columns if from_columns == 1 else from_columns
                s = s.expand(rows, -1, cols, *s.shape[3:])
                if src is dst:
                    s = s.clone()       # overlapping rectangles of one cache
                dst[to_row : to_row + rows, :,
                    to_column : to_column + cols] = s.to(dst.dtype)
