"""Model + runtime configuration (PyTorch/CUDA port of exllama_tpu/config.py).

``ExLlamaConfig`` parses a HuggingFace ``config.json`` for the Llama family
exactly as the JAX package does. ``TuningParams`` keeps only the knobs the
port implements; the JAX package's TPU knobs (VMEM budgets, ``q4_block_k``,
``matmul_prefill_rows``) have no counterpart here.

By default the port runs the JAX package's default decode configuration:
the fused decode kernels (``fuse_mlp``, ``fuse_attn``; ``fuse_qkv`` off by
default, as there), ``commit_impl="auto"``, fused qkv / gate-up
projections, a bf16 KV cache, exact 4-bit matmuls (``matmul_impl="auto"``)
and a bf16 lm_head. ``kv_cache_dtype`` opts into the quantized KV caches
(``"int8"``, packed ``"int4"``; per-(token, head) f32 scales) and
``pad_head_dim`` into a cache padded to a width the attention kernel takes;
``attn_impl`` picks kernel K3 or the plain einsum attention by head dim, as
the JAX package does. Setting ``fuse_mlp``, ``fuse_attn`` and ``fuse_qkv`` to
False (any ``commit_impl``) gives the separate-kernel configuration of the
port's first slice. ``matmul_impl`` opts into the W4A8 turbo modes: int8
activations at decode M (``"pallas_a8"``, with a residual pass
``"pallas_a8x2"``) and int8 tensor-core prefill too (``"pallas_a8t"``,
against a resident int8 image of the weights where ``prefill_w8`` allows);
``"xla"`` is the plain path (dequantize + product, no 4-bit or lm_head
kernel), an oracle reached only by its name. ``scale_dtype="f32"`` stores
the scales in f32 (each kernel then runs its f32-scale build),
``quantize_lm_head`` quantizes the lm_head to 4 bits, and
``fold_act_order=False`` keeps the act-order down projection's gather.
Every value the JAX package takes is taken, except its TPU-only
``*_interpret`` matmul strings.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

COMMIT_IMPLS = ("auto", "xla", "pallas")
# attention routes (the JAX value names): "flash" = kernel K3 (and the fused
# decode kernels), "xla" = the plain einsum attention the reference runs
# outside its flash kernel, "auto" = "flash" where K3 takes the head dim
ATTN_IMPLS = ("auto", "flash", "xla")
# The JAX value names are kept so call sites port unchanged: "auto" and
# "pallas" are the exact kernels, the "pallas_a8*" ones the W4A8 modes and
# "xla" the plain path ("auto" never resolves to it).
MATMUL_IMPLS = ("auto", "pallas", "pallas_a8", "pallas_a8x2", "pallas_a8t",
                "xla")
A8_IMPLS = ("pallas_a8", "pallas_a8x2", "pallas_a8t")
SCALE_DTYPES = ("bf16", "f32")
PREFILL_W8 = ("auto", "on", "off")
# bytes per stored element, as exllama_tpu/models/llama.py:777
KV_CACHE_DTYPES = {"bf16": 2, "int8": 1, "int4": 0.5}


def check_matmul_impl(impl: str) -> str:
    """``impl`` if the port implements it. The JAX package's TPU-only
    interpret-mode strings raise NotImplementedError, anything else
    ValueError."""
    if impl in MATMUL_IMPLS:
        return impl
    if impl.removesuffix("_interpret") in MATMUL_IMPLS:
        raise NotImplementedError(
            f"matmul_impl {impl!r}: the port runs its kernels (or, on CPU "
            f"tensors, their plain versions) under {MATMUL_IMPLS}")
    raise ValueError(f"matmul_impl {impl!r} not in {MATMUL_IMPLS}")


@dataclasses.dataclass
class TuningParams:
    """Runtime knobs of the port."""

    # 4-bit matmul arithmetic: "auto" / "pallas" = the exact kernels (K1 at
    # M <= 32, K2 above); "pallas_a8" = int8 activations per (row, group)
    # against the nibbles at M <= 32 (K9), exact above; "pallas_a8x2" = K9
    # with a second int8 pass over the residual; "pallas_a8t" = K9 at
    # M <= 32 and int8 tensor-core products above (K11 against a resident
    # int8 image, K10 re-quantizing the 4-bit tile in the kernel); "xla" =
    # the plain path (dequantize + product, ops/quant._q4_matmul_plain) and
    # the plain lm_head, with K6 / K7 refused: an oracle, never a fallback.
    matmul_impl: str = "auto"
    # Turbo prefill ("pallas_a8t") weight strategy: "auto" keeps a
    # load-time int8 image of as many layer weights as the budget below
    # allows, "on" of all of them whatever it costs, "off" of none (every
    # prefill matmul re-quantizes in the kernel). No effect on other modes.
    prefill_w8: str = "auto"
    # Device memory "auto" may fill with packed weights + the KV cache +
    # images, in GiB. None: the card's total memory less 2.5 GiB for
    # activations and workspace, read when the images are attached.
    prefill_w8_budget_gb: Optional[float] = None
    # Attention route: "flash" = kernel K3 (and, at decode, the fused layer
    # kernel K7), "xla" = plain einsum attention (ops/attention.attend_xla,
    # what the JAX package runs outside Pallas), "auto" = "flash" where
    # ops/attention.flash_supported_head_dim holds for the width attended,
    # "xla" elsewhere (OpenLlama-3B's head_dim 100). "flash" with another
    # head dim raises. The JAX package's TPU-only short-attend demotion to
    # "xla" has no counterpart.
    attn_impl: str = "auto"
    # Decode-time attention length bucketing: the attended KV length is
    # rounded up to a multiple of this (0 = always the full max_seq_len).
    attn_len_bucket: int = 256
    # Fuse q/k/v and gate/up into one matmul each at load time (skipped
    # automatically for act-order layers, whose x_maps differ per tensor).
    fuse_projections: bool = True
    # KV cache storage: "bf16"; "int8" (one byte an element) or "int4" (two
    # elements a byte, dims d and d + D/2 paired), each with one f32 scale
    # per (token, kv head), quantized as the rows are written.
    kv_cache_dtype: str = "bf16"
    # Storage dtype of the per-group scales and zero-scales: "bf16" (the
    # JAX package's default) or "f32" (zscale = (z+1)*s rounded once, to
    # f32; every 4-bit kernel has an f32-scale build).
    scale_dtype: str = "bf16"
    # Decode MLP block (post-norm -> gate/up -> silu*up -> down -> +h) in
    # one launch of kernel K6 (ops/mlp.q4_mlp) where fused_mlp_applicable
    # holds; otherwise the separate kernels run regardless of this flag.
    fuse_mlp: bool = True
    # Deferred-commit decode layer tail (attention -> o-proj -> +h, and with
    # fuse_mlp the MLP too) in one launch of kernel K7 (ops/attn_block)
    # where attn_o_applicable holds.
    fuse_attn: bool = True
    # With fuse_attn and fuse_mlp: K7 also runs the input norm, the fused
    # qkv GEMV and rope (ops/attn_block.layer_step). Off by default, as in
    # the JAX package.
    fuse_qkv: bool = False
    # Deferred K/V commit of a decode step: "pallas" writes every layer's
    # rows in one launch of the port's CUDA kernel K8 (the JAX value name is
    # kept so call sites port unchanged); "xla" and "auto" write them with
    # one plain tensor write per layer, as the JAX package's "auto" does.
    # Either route takes an int cursor or a per-row [B] tensor cursor.
    commit_impl: str = "auto"
    # Store bf16 / int8 K and V rows zero-padded to a head width the
    # attention kernel K3 takes (64, or the next multiple of 128), so that a
    # model with another head_dim (100) runs K3; q is pre-scaled so the
    # softmax scale stays 1/sqrt(head_dim). No effect on an int4 cache.
    pad_head_dim: bool = False
    # The loaders fold the act-order down projection's input permutation
    # into the gate/up output columns (a pure weight transform); False keeps
    # down's x_map, gathered in K1's prologue.
    fold_act_order: bool = True
    # Quantize the lm_head to 4 bits at load (the checkpoint's groupsize,
    # else 128): logits through q4_matmul (K1 / K2), argmax after them.
    quantize_lm_head: bool = False

    def __setattr__(self, name, value):
        if name == "scale_dtype" and value not in SCALE_DTYPES:
            raise ValueError(f"scale_dtype {value!r} not in {SCALE_DTYPES}")
        if name == "commit_impl" and value not in COMMIT_IMPLS:
            raise ValueError(f"commit_impl {value!r} not in {COMMIT_IMPLS}")
        if name == "matmul_impl":
            check_matmul_impl(value)
        if name == "attn_impl" and value not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {value!r} not in {ATTN_IMPLS}")
        if name == "kv_cache_dtype" and value not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype {value!r} not in "
                             f"{tuple(KV_CACHE_DTYPES)}")
        if name == "prefill_w8" and value not in PREFILL_W8:
            raise ValueError(f"prefill_w8 {value!r} not in {PREFILL_W8}")
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
        self.tp_size = 1                 # tensor-parallel degree (--tp)
        self.dp_size = 1                 # data/batch-parallel degree (--dp)

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
