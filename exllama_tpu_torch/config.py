"""Model + runtime configuration (PyTorch/CUDA port of exllama_tpu/config.py).

``ExLlamaConfig`` parses a HuggingFace ``config.json`` for the Llama family
exactly as the JAX package does. ``TuningParams`` keeps only the knobs the
port implements; the JAX package's TPU knobs (VMEM budgets, ``q4_block_k``,
``prefill_w8*``, ``matmul_prefill_rows``) have no counterpart here.

The port runs "the slice configuration": separate (unfused) decode kernels,
plain per-layer KV commits after the layer loop, fused qkv / gate-up
projections, a bf16 KV cache, exact 4-bit matmuls and a bf16 lm_head. A knob
whose other values belong to a later slice is still accepted at its slice
value, so call sites written for the JAX package keep working, and raises
for any other value.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

# knob -> the only value this slice implements
_SLICE_ONLY = {
    "fuse_mlp": False,
    "fuse_attn": False,
    "fuse_qkv": False,
    "commit_impl": "xla",
    "quantize_lm_head": False,
    "pad_head_dim": False,
    "kv_cache_dtype": "bf16",
    "scale_dtype": "bf16",
    "fold_act_order": True,
}


@dataclasses.dataclass
class TuningParams:
    """Runtime knobs of the port."""

    # Decode-time attention length bucketing: the attended KV length is
    # rounded up to a multiple of this (0 = always the full max_seq_len).
    attn_len_bucket: int = 256
    # Fuse q/k/v and gate/up into one matmul each at load time (skipped
    # automatically for act-order layers, whose x_maps differ per tensor).
    fuse_projections: bool = True
    # KV cache storage; int8/int4 belong to a later slice.
    kv_cache_dtype: str = "bf16"
    # Storage dtype of the per-group scales; "f32" belongs to a later slice.
    scale_dtype: str = "bf16"
    # Knobs fixed at the slice configuration (see _SLICE_ONLY). The loader
    # always folds the act-order down-proj permutation into the gate/up
    # output columns (a pure weight transform).
    fold_act_order: bool = True
    fuse_mlp: bool = False
    fuse_attn: bool = False
    fuse_qkv: bool = False
    commit_impl: str = "xla"
    quantize_lm_head: bool = False
    pad_head_dim: bool = False

    def __setattr__(self, name, value):
        if name in _SLICE_ONLY and value != _SLICE_ONLY[name]:
            raise NotImplementedError(
                f"TuningParams.{name}={value!r}: this port implements only "
                f"{_SLICE_ONLY[name]!r} (the slice configuration)"
            )
        if name not in {f.name for f in dataclasses.fields(self)}:
            raise AttributeError(f"TuningParams has no knob {name!r}")
        object.__setattr__(self, name, value)


class ExLlamaConfig:
    """Parses config.json and holds runtime settings (same surface as
    exllama_tpu.config.ExLlamaConfig)."""

    def __init__(self, model_config_path: Optional[str] = None):
        if model_config_path is not None:
            with open(model_config_path) as f:
                read_config = json.load(f)
        else:
            read_config = {}

        self.model_config_path = model_config_path

        # -- model architecture (HF config.json fields)
        self.bos_token_id = read_config.get("bos_token_id", 1)
        self.eos_token_id = read_config.get("eos_token_id", 2)
        self.pad_token_id = read_config.get("pad_token_id", 0)
        self.hidden_size = read_config.get("hidden_size", 4096)
        self.initializer_range = read_config.get("initializer_range", 0.02)
        self.intermediate_size = read_config.get("intermediate_size", 11008)
        self.num_attention_heads = read_config.get("num_attention_heads", 32)
        self.num_hidden_layers = read_config.get("num_hidden_layers", 32)
        # GQA: absent for Llama-1 -> same as the number of query heads
        self.num_key_value_heads = read_config.get(
            "num_key_value_heads", self.num_attention_heads
        )
        self.vocab_size = read_config.get("vocab_size", 32000)
        self.rms_norm_eps = read_config.get("rms_norm_eps", 1e-6)
        self.rotary_embedding_base = read_config.get("rope_theta", 10000.0)
        self.head_dim = read_config.get(
            "head_dim", self.hidden_size // self.num_attention_heads
        )
        self.num_key_value_groups = (
            self.num_attention_heads // self.num_key_value_heads
        )

        # -- checkpoint location (set by the user after construction)
        self.model_path: Optional[str] = None

        # -- runtime knobs
        self.max_seq_len = 2048          # KV cache capacity / context limit
        self.max_input_len = 2048        # chunked-prefill max rows per chunk
        self.max_attention_size = 2048 ** 2  # bound on q_len*k_len per chunk
        self.compress_pos_emb = 1.0      # linear RoPE position compression
        self.alpha_value = 1.0           # NTK RoPE alpha scaling
        self.batch_size = 1              # KV cache batch dimension

        # -- quantization (normally detected from tensor shapes at load)
        self.groupsize: Optional[int] = None
        self.act_order: bool = False

        self.tuning = TuningParams()
        self.dtype = "bfloat16"          # activation dtype

    def calculate_rotary_embedding_base(self):
        """NTK alpha -> effective theta."""
        self.rotary_embedding_base = self.rotary_embedding_base * (
            self.alpha_value ** (self.head_dim / (self.head_dim - 2))
        )

    @property
    def rope_scale(self) -> float:
        return 1.0 / self.compress_pos_emb

    def model_files(self) -> list[str]:
        """All .safetensors shards under model_path (file or directory)."""
        if self.model_path is None:
            raise ValueError("config.model_path not set")
        if os.path.isdir(self.model_path):
            files = sorted(
                os.path.join(self.model_path, fn)
                for fn in os.listdir(self.model_path)
                if fn.endswith(".safetensors")
            )
        else:
            files = [self.model_path]
        if not files:
            raise FileNotFoundError(
                f"no .safetensors found under {self.model_path}"
            )
        return files
