"""Parameter construction (port of exllama_tpu/formats/loader.py).

  * ``load_model_params``: a GPTQ safetensors checkpoint, read by a small
    reader of the port's own (no ``safetensors`` package needed);
  * ``make_synthetic_params``: a random quantized model of any shape, either
    quantized from random float matrices (same draws as the JAX package for
    one seed) or, with ``fast=True``, random packed words and scales made
    directly on the device;
  * ``params_from_jax``: the port's params from a JAX ``ModelParams`` whose
    leaves the caller turned into numpy arrays.

All three fuse qkv / gate-up when ``tuning.fuse_projections`` (skipped for
act-order layers); the first two fold the act-order down-proj permutation
into the gate/up columns, as the JAX loaders do by default.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from exllama_tpu_torch.config import ExLlamaConfig
from exllama_tpu_torch.formats.gptq import (
    QuantTensor,
    load_quant_tensor,
    npair_padded_n,
    pack_gptq_qweight,
    permute_out_columns,
    quantize_matrix,
    unpack_npair,
)
from exllama_tpu_torch.models.llama import (
    LayerParams,
    ModelParams,
    _require_device,
    fuse_layer_projections,
)
from exllama_tpu_torch.ops.rope import rope_tables

# ---------------------------------------------------------------------------
# safetensors reading
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F16": np.float16, "F32": np.float32, "I32": np.int32, "I64": np.int64,
    "BF16": np.int16,   # raw bits, viewed as bf16 by load_model_params
    "I16": np.int16, "U8": np.uint8, "I8": np.int8,
}


class SafetensorsFile:
    """Minimal reader: 8-byte little-endian header length, a JSON header of
    {name: {dtype, shape, data_offsets}}, then the raw data."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.header = header
        self._data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)

    def keys(self):
        return self.header.keys()

    def get(self, key: str) -> np.ndarray:
        info = self.header[key]
        lo, hi = info["data_offsets"]
        arr = np.frombuffer(self._data[lo:hi], dtype=_ST_DTYPES[info["dtype"]])
        return arr.reshape(info["shape"])

    def dtype_of(self, key: str) -> str:
        return self.header[key]["dtype"]


def _fold_down_act_order(lp: LayerParams) -> LayerParams:
    """Fold the act-order down-proj input permutation into the gate/up
    output columns (numerics unchanged)."""
    if lp.down.x_map is None or lp.gate is None or lp.up is None:
        return lp
    fold = lp.down.x_map.cpu().numpy()
    return dataclasses.replace(
        lp,
        gate=permute_out_columns(lp.gate, fold),
        up=permute_out_columns(lp.up, fold),
        down=dataclasses.replace(lp.down, x_map=None),
    )


def _finish_layer(lp: LayerParams, config: ExLlamaConfig) -> LayerParams:
    lp = _fold_down_act_order(lp)
    if config.tuning.fuse_projections:
        lp = fuse_layer_projections(lp)
    return lp


def _tables(config: ExLlamaConfig, device):
    return rope_tables(
        config.max_seq_len, config.head_dim,
        base=config.rotary_embedding_base,
        compress_pos_emb=config.compress_pos_emb, device=device,
    )


def load_model_params(config: ExLlamaConfig, device="cuda") -> ModelParams:
    """Load a GPTQ safetensors checkpoint (config.model_path)."""
    device = _require_device(device)
    files = [SafetensorsFile(fn) for fn in config.model_files()]
    where = {k: f for f in files for k in f.keys()}

    def get(key: str) -> np.ndarray:
        return where[key].get(key)

    def dense(key: str) -> torch.Tensor:
        f = where[key]
        arr = f.get(key)
        if f.dtype_of(key) == "BF16":
            t = torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.asarray(arr, np.float32))
        return t.to(device=device, dtype=torch.bfloat16)

    def quant(prefix: str) -> QuantTensor:
        g_idx = get(f"{prefix}.g_idx") if f"{prefix}.g_idx" in where else None
        if g_idx is not None and np.all(g_idx == 0):
            g_idx = None    # an all-zero g_idx carries no ordering
        return load_quant_tensor(
            get(f"{prefix}.qweight").astype(np.int32),
            get(f"{prefix}.qzeros").astype(np.int32),
            get(f"{prefix}.scales"),
            g_idx,
            device=device,
        )

    layers = []
    t0 = time.time()
    act = False
    for i in range(config.num_hidden_layers):
        if i % 8 == 0:
            print(f" -- loading layer {i}/{config.num_hidden_layers}"
                  f" ({time.time() - t0:.0f}s)", flush=True)
        p = f"model.layers.{i}"
        lp = LayerParams(
            input_norm=dense(f"{p}.input_layernorm.weight"),
            post_norm=dense(f"{p}.post_attention_layernorm.weight"),
            q=quant(f"{p}.self_attn.q_proj"),
            k=quant(f"{p}.self_attn.k_proj"),
            v=quant(f"{p}.self_attn.v_proj"),
            o=quant(f"{p}.self_attn.o_proj"),
            gate=quant(f"{p}.mlp.gate_proj"),
            up=quant(f"{p}.mlp.up_proj"),
            down=quant(f"{p}.mlp.down_proj"),
        )
        config.groupsize = lp.q.groupsize
        act = act or lp.q.act_order
        layers.append(_finish_layer(lp, config))
    config.act_order = act

    sin, cos = _tables(config, device)
    return ModelParams(
        embed=dense("model.embed_tokens.weight"),
        layers=layers,
        norm=dense("model.norm.weight"),
        lm_head=dense("lm_head.weight").t().contiguous(),   # [hidden, vocab]
        rope_sin=sin,
        rope_cos=cos,
    )


# ---------------------------------------------------------------------------
# Synthetic checkpoints (tests / benchmarks)
# ---------------------------------------------------------------------------


def make_synthetic_params(
    config: ExLlamaConfig,
    groupsize: int = 128,
    act_order: bool = False,
    seed: int = 0,
    device="cuda",
    fast: bool = False,
) -> ModelParams:
    """A random quantized model with ``config``'s shapes.

    Weight scales follow standard transformer init so activations stay
    numerically sane. The default mode quantizes random float matrices with
    the same numpy draws as the JAX package's ``make_synthetic_params``.
    ``fast=True`` draws packed words and per-group scales directly on
    ``device`` from a ``torch.Generator`` seeded with ``seed`` (the same
    compute and memory profile, ready in seconds at 7B); its weights are
    not the JAX package's.
    """
    device = _require_device(device)
    h = config.hidden_size
    inter = config.intermediate_size
    kvdim = config.num_key_value_heads * config.head_dim
    qdim = config.num_attention_heads * config.head_dim
    bf16 = torch.bfloat16

    if fast:
        gen = torch.Generator(device=device).manual_seed(seed)

        def qt(k, n):
            words = torch.randint(
                -(2 ** 31), 2 ** 31 - 1, (k // 8, n), generator=gen,
                device=device, dtype=torch.int64,
            ).to(torch.int32)
            # uniform nibbles (mean 7.5, std ~4.6): dequantized std
            # 0.02/sqrt(k/4096) with the zero-point at 8
            sigma = 0.02 / np.sqrt(k / 4096)
            s = torch.full((k // groupsize, n), sigma / 4.6, device=device)
            s *= 1.0 + 0.05 * torch.randn(s.shape, generator=gen, device=device)
            xm = None
            if act_order:
                xm = torch.randperm(k, generator=gen, device=device).to(
                    torch.int32)
            return QuantTensor(words, s.to(bf16), (8.0 * s).to(bf16), xm,
                               groupsize)

        def dense(shape, std):
            return (torch.randn(shape, generator=gen, device=device)
                    * std).to(bf16)
    else:
        rng = np.random.default_rng(seed)

        def qt(k, n):
            w = (rng.standard_normal((k, n), dtype=np.float32)
                 * (0.02 / np.sqrt(k / 4096)))
            t = quantize_matrix(w, groupsize, act_order, rng)
            return load_quant_tensor(
                t["qweight"], t["qzeros"], t["scales"], t.get("g_idx"),
                device=device,
            )

        def dense(shape, std):
            a = rng.standard_normal(shape, dtype=np.float32) * std
            return torch.from_numpy(a).to(device=device, dtype=bf16)

    layers = []
    for _ in range(config.num_hidden_layers):
        lp = LayerParams(
            input_norm=torch.ones(h, dtype=bf16, device=device),
            post_norm=torch.ones(h, dtype=bf16, device=device),
            q=qt(h, qdim), k=qt(h, kvdim), v=qt(h, kvdim), o=qt(qdim, h),
            gate=qt(h, inter), up=qt(h, inter), down=qt(inter, h),
        )
        layers.append(_finish_layer(lp, config))
    lm_head = dense((h, config.vocab_size), 0.02)
    embed = dense((config.vocab_size, h), 0.02)
    sin, cos = _tables(config, device)
    return ModelParams(
        embed=embed, layers=layers,
        norm=torch.ones(h, dtype=bf16, device=device),
        lm_head=lm_head, rope_sin=sin, rope_cos=cos,
    )


# ---------------------------------------------------------------------------
# Conversion from the JAX package's parameters
# ---------------------------------------------------------------------------


def _bf16_from_np(a) -> torch.Tensor:
    # bf16 numpy arrays (ml_dtypes) convert exactly through float32
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _qt_from_jax(jqt, col_slices=None) -> QuantTensor:
    """One JAX npair QuantTensor -> the port's layout. ``col_slices`` picks
    the true columns of a fused tensor whose parts are each padded."""
    n_pad = np.asarray(jqt.qweight).shape[1] * 2
    q = unpack_npair(np.asarray(jqt.qweight))            # [K, N_pad]
    s = np.asarray(jqt.scales, np.float32)
    z = np.asarray(jqt.zscale, np.float32)
    if col_slices is None:
        col_slices = [slice(0, jqt.out_features)]
    cols = np.concatenate([np.arange(n_pad)[sl] for sl in col_slices])
    xm = None if jqt.x_map is None else np.array(jqt.x_map, np.int32)
    return QuantTensor(
        qweight=torch.from_numpy(pack_gptq_qweight(q[:, cols])),
        scales=_bf16_from_np(s[:, cols]),
        zscale=_bf16_from_np(z[:, cols]),
        x_map=None if xm is None else torch.from_numpy(xm),
        groupsize=jqt.groupsize,
    )


def _fused_slices(widths: "list[int]") -> "list[slice]":
    """True-column slices of a JAX fused tensor: part i starts at the sum of
    the padded widths of the parts before it (exllama_tpu llama.py:238-243)."""
    out, off = [], 0
    for n in widths:
        out.append(slice(off, off + n))
        off += npair_padded_n(n)
    return out


def params_from_jax(
    jax_params, config: ExLlamaConfig, device="cuda"
) -> ModelParams:
    """Convert a JAX ``ModelParams`` (leaves already numpy arrays, e.g. via
    ``jax.tree.map(np.asarray, params)``) into the port's params. Reads by
    attribute only; imports nothing of JAX."""
    device = _require_device(device)
    nq = config.num_attention_heads * config.head_dim
    nkv = config.num_key_value_heads * config.head_dim
    inter = config.intermediate_size
    layers = []
    for jl in jax_params.layers:
        fields = dict(
            input_norm=_bf16_from_np(jl.input_norm),
            post_norm=_bf16_from_np(jl.post_norm),
            o=_qt_from_jax(jl.o),
            down=_qt_from_jax(jl.down),
            q=None, k=None, v=None, gate=None, up=None,
        )
        if jl.qkv is not None:
            fields["qkv"] = _qt_from_jax(jl.qkv, _fused_slices([nq, nkv, nkv]))
        else:
            for name in ("q", "k", "v"):
                fields[name] = _qt_from_jax(getattr(jl, name))
        if jl.gateup is not None:
            fields["gateup"] = _qt_from_jax(
                jl.gateup, _fused_slices([inter, inter])
            )
        else:
            fields["gate"] = _qt_from_jax(jl.gate)
            fields["up"] = _qt_from_jax(jl.up)
        layers.append(LayerParams(**fields))
    params = ModelParams(
        embed=_bf16_from_np(jax_params.embed),
        layers=layers,
        norm=_bf16_from_np(jax_params.norm),
        lm_head=_bf16_from_np(jax_params.lm_head),
        rope_sin=torch.from_numpy(np.array(jax_params.rope_sin, np.float32)),
        rope_cos=torch.from_numpy(np.array(jax_params.rope_cos, np.float32)),
    )
    return params.to(device)
