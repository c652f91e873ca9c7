"""Preallocated KV cache (port of exllama_tpu/cache.py:ExLlamaCache).

One [B, Hkv, S_max, D] bf16 tensor per layer for K and for V, plus the
host-side position cursor ``current_seq_len``. Unlike the JAX version, whose
arrays are immutable and rebound after each step, the port updates these
tensors IN PLACE (ops/attention.update_kv_cache, and commit_kv_cache for
the deferred rows of a decode step); ``clone`` copies them. Since they never
move, ``kv_ptrs`` -- the device array of their base pointers that the
batched commit kernel K8 reads -- is built once, here.
"""

from __future__ import annotations

import torch

from exllama_tpu_torch.ops.attention import kv_ptr_array


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
            self.k = [t.clone() for t in copy_from.k]
            self.v = [t.clone() for t in copy_from.v]
            self.kv_ptrs = kv_ptr_array(self.k, self.v)
            self.current_seq_len = copy_from.current_seq_len
            return

        if model is None:
            raise ValueError("need model= or copy_from=")
        cfg = model.config          # TuningParams admits only a bf16 KV cache
        shape = (
            cfg.num_hidden_layers,
            batch_size or cfg.batch_size,
            max_seq_len or cfg.max_seq_len,
            cfg.num_key_value_heads,
            cfg.head_dim,
        )
        self.batch_size = shape[1]
        self.max_seq_len = shape[2]
        self.shape = shape
        self.device = model.device
        layer_shape = (shape[1], shape[3], shape[2], shape[4])  # B, Hkv, S, D
        self.k = [
            torch.zeros(layer_shape, dtype=torch.bfloat16, device=self.device)
            for _ in range(shape[0])
        ]
        self.v = [
            torch.zeros(layer_shape, dtype=torch.bfloat16, device=self.device)
            for _ in range(shape[0])
        ]
        self.kv_ptrs = kv_ptr_array(self.k, self.v)
        self.current_seq_len = 0

    def zero(self):
        for t in self.k + self.v:
            t.zero_()
        self.current_seq_len = 0

    def clone(self) -> "ExLlamaCache":
        return ExLlamaCache(copy_from=self)
