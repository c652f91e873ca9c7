"""Parameter construction (port of exllama_tpu/formats/loader.py).

  * ``load_model_params``: a GPTQ safetensors checkpoint, read by a small
    reader of the port's own (no ``safetensors`` package needed; its
    writer, ``save_safetensors``, serves ``utils/fabricate`` and
    ``utils/shard``);
  * ``make_synthetic_params``: a random quantized model of any shape, either
    quantized from random float matrices (same draws as the JAX package for
    one seed) or, with ``fast=True``, random packed words and scales made
    directly on the device;
  * ``params_from_jax``: the port's params from a JAX ``ModelParams`` whose
    leaves the caller turned into numpy arrays.

All three fuse qkv / gate-up when ``tuning.fuse_projections`` (skipped for
act-order layers); the first two fold the act-order down-proj permutation
into the gate/up columns where ``tuning.fold_act_order`` (the default, as
in the JAX loaders), store the scales as ``tuning.scale_dtype`` says and,
with ``tuning.quantize_lm_head``, quantize the lm_head to 4 bits. Each
keeps the folded permutations in ``ModelParams.down_folds`` (one entry a
layer, None where nothing was folded), which a LoRA adapter of gate, up or
down needs (``lora.ExLlamaLora``).
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from exllama_tpu_torch.config import ExLlamaConfig
from exllama_tpu_torch.formats.gptq import (
    SCALE_TORCH_DTYPES,
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
    {name: {dtype, shape, data_offsets}}, then the raw data
    (``save_safetensors`` writes the same format)."""

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


# dtypes in the order safetensors lays tensors out (larger first), as it
# names them
_ST_ORDER = ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32",
             "F32", "F64", "I64", "U64")
_ST_NAMES = {np.dtype(np.bool_): "BOOL", np.dtype(np.uint8): "U8",
             np.dtype(np.int8): "I8", np.dtype(np.int16): "I16",
             np.dtype(np.uint16): "U16", np.dtype(np.float16): "F16",
             np.dtype(np.int32): "I32", np.dtype(np.uint32): "U32",
             np.dtype(np.float32): "F32", np.dtype(np.float64): "F64",
             np.dtype(np.int64): "I64", np.dtype(np.uint64): "U64"}


def save_safetensors(tensors: "dict[str, np.ndarray]", path: str,
                     metadata: "dict[str, str] | None" = None) -> int:
    """Write numpy arrays as a safetensors file, byte for byte as the
    ``safetensors`` package writes them: an 8-byte little-endian header
    length, a compact JSON header (``__metadata__`` first), padded with
    spaces to a multiple of 8 bytes, then the raw little-endian data,
    tensors ordered by dtype (wider first), then by name. Returns the bytes
    of tensor data."""
    def dtype_name(a):
        return _ST_NAMES[a.dtype.newbyteorder("=")]

    items = sorted(tensors.items(),
                   key=lambda kv: (-_ST_ORDER.index(dtype_name(kv[1])),
                                   kv[0]))
    header: dict = {}
    if metadata:
        header["__metadata__"] = metadata
    off = 0
    for name, a in items:
        header[name] = {"dtype": dtype_name(a), "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for _, a in items:
            a = np.ascontiguousarray(a, a.dtype.newbyteorder("<"))
            f.write(memoryview(a.reshape(-1)).cast("B"))
    return off


def _fold_down_act_order(lp: LayerParams):
    """Fold the act-order down-proj input permutation into the gate/up
    output columns (numerics unchanged). Returns (the layer, the applied
    permutation as int64 numpy), or (lp, None) where there is nothing to
    fold."""
    if lp.down.x_map is None or lp.gate is None or lp.up is None:
        return lp, None
    fold = lp.down.x_map.cpu().numpy().astype(np.int64)
    return dataclasses.replace(
        lp,
        gate=permute_out_columns(lp.gate, fold),
        up=permute_out_columns(lp.up, fold),
        down=dataclasses.replace(lp.down, x_map=None),
    ), fold


def _finish_layer(lp: LayerParams, config: ExLlamaConfig, folds: list):
    """Fold and fuse one loaded layer; its fold (or None) goes to
    ``folds``."""
    fold = None
    if config.tuning.fold_act_order:
        lp, fold = _fold_down_act_order(lp)
    folds.append(fold)
    if config.tuning.fuse_projections:
        lp = fuse_layer_projections(lp)
    return lp


def _tables(config: ExLlamaConfig, device):
    return rope_tables(
        config.max_seq_len, config.head_dim,
        base=config.rotary_embedding_base,
        compress_pos_emb=config.compress_pos_emb, device=device,
    )


def quantize_head(w: np.ndarray, groupsize: int, act_order: bool = False,
                  rng=None, device="cpu", scale_dtype: str = "bf16"):
    """A 4-bit lm_head from f32 [hidden, vocab] (``quantize_lm_head``):
    ``quantize_matrix`` as the JAX loaders call it. The wire format packs
    zero-points 8 columns a word, so an odd vocab is quantized padded with
    zero columns and the padding sliced off again (the port's layout has no
    column packing); the JAX package refuses such a vocab."""
    n = w.shape[1]
    pad = -n % 8
    t = quantize_matrix(np.pad(w, ((0, 0), (0, pad))) if pad else w,
                        groupsize, act_order, rng)
    qt = load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                           t.get("g_idx"), device=device,
                           scale_dtype=scale_dtype)
    if not pad:
        return qt
    return dataclasses.replace(
        qt, qweight=qt.qweight[:, :n].contiguous(),
        scales=qt.scales[:, :n].contiguous(),
        zscale=qt.zscale[:, :n].contiguous())


def load_model_params(config: ExLlamaConfig, device="cuda") -> ModelParams:
    """Load a GPTQ safetensors checkpoint (config.model_path)."""
    device = _require_device(device)
    scale_dtype = config.tuning.scale_dtype
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
            scale_dtype=scale_dtype,
        )

    layers, folds = [], []
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
        layers.append(_finish_layer(lp, config, folds))
    config.act_order = act

    sin, cos = _tables(config, device)
    if config.tuning.quantize_lm_head:
        # loader.py:236-243, at the detected groupsize, else 128
        head = np.asarray(get("lm_head.weight"), np.float32).T
        lm_head = quantize_head(np.ascontiguousarray(head),
                                config.groupsize or 128, device=device,
                                scale_dtype=scale_dtype)
    else:
        lm_head = dense("lm_head.weight").t().contiguous()   # [hidden, vocab]
    return ModelParams(
        embed=dense("model.embed_tokens.weight"),
        layers=layers,
        norm=dense("model.norm.weight"),
        lm_head=lm_head,
        rope_sin=sin,
        rope_cos=cos,
        down_folds=folds,
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
    not the JAX package's. With ``tuning.quantize_lm_head`` the lm_head is
    drawn as the layers' weights are (act-order too), before the embedding,
    in the JAX package's order.
    """
    device = _require_device(device)
    sdt = SCALE_TORCH_DTYPES[config.tuning.scale_dtype]
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
            return QuantTensor(words, s.to(sdt), (8.0 * s).to(sdt), xm,
                               groupsize)

        def dense(shape, std):
            return (torch.randn(shape, generator=gen, device=device)
                    * std).to(bf16)
    else:
        rng = np.random.default_rng(seed)

        def qt(k, n):
            w = (rng.standard_normal((k, n), dtype=np.float32)
                 * (0.02 / np.sqrt(k / 4096)))
            return quantize_head(w, groupsize, act_order, rng, device,
                                 config.tuning.scale_dtype)

        def dense(shape, std):
            a = rng.standard_normal(shape, dtype=np.float32) * std
            return torch.from_numpy(a).to(device=device, dtype=bf16)

    layers, folds = [], []
    for _ in range(config.num_hidden_layers):
        lp = LayerParams(
            input_norm=torch.ones(h, dtype=bf16, device=device),
            post_norm=torch.ones(h, dtype=bf16, device=device),
            q=qt(h, qdim), k=qt(h, kvdim), v=qt(h, kvdim), o=qt(qdim, h),
            gate=qt(h, inter), up=qt(h, inter), down=qt(inter, h),
        )
        layers.append(_finish_layer(lp, config, folds))
    if config.tuning.quantize_lm_head:
        lm_head = qt(h, config.vocab_size)
    else:
        lm_head = dense((h, config.vocab_size), 0.02)
    embed = dense((config.vocab_size, h), 0.02)
    sin, cos = _tables(config, device)
    return ModelParams(
        embed=embed, layers=layers,
        norm=torch.ones(h, dtype=bf16, device=device),
        lm_head=lm_head, rope_sin=sin, rope_cos=cos, down_folds=folds,
    )


# ---------------------------------------------------------------------------
# Conversion from the JAX package's parameters
# ---------------------------------------------------------------------------


def _bf16_from_np(a) -> torch.Tensor:
    # bf16 numpy arrays (ml_dtypes) convert exactly through float32
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _scales_from_np(a) -> torch.Tensor:
    """JAX scales in their own storage type: f32 stays f32, else bf16."""
    if np.asarray(a).dtype == np.float32:
        return torch.from_numpy(np.array(a, np.float32))
    return _bf16_from_np(a)


def _qt_from_jax(jqt, col_slices=None) -> QuantTensor:
    """One JAX npair QuantTensor -> the port's layout. ``col_slices`` picks
    the true columns of a fused tensor whose parts are each padded."""
    n_pad = np.asarray(jqt.qweight).shape[1] * 2
    q = unpack_npair(np.asarray(jqt.qweight))            # [K, N_pad]
    s = np.asarray(jqt.scales)
    z = np.asarray(jqt.zscale)
    if col_slices is None:
        col_slices = [slice(0, jqt.out_features)]
    cols = np.concatenate([np.arange(n_pad)[sl] for sl in col_slices])
    xm = None if jqt.x_map is None else np.array(jqt.x_map, np.int32)
    return QuantTensor(
        qweight=torch.from_numpy(pack_gptq_qweight(q[:, cols])),
        scales=_scales_from_np(s[:, cols]),
        zscale=_scales_from_np(z[:, cols]),
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
    jax_params, config: ExLlamaConfig, device="cuda", down_folds=None,
) -> ModelParams:
    """Convert a JAX ``ModelParams`` (leaves already numpy arrays, e.g. via
    ``jax.tree.map(np.asarray, params)``) into the port's params. Reads by
    attribute only; imports nothing of JAX. ``down_folds``: the JAX
    params' ``_down_folds`` (a plain attribute, which the tree map drops),
    the folded permutations a LoRA adapter needs; None: nothing folded."""
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
        lm_head=(_qt_from_jax(jax_params.lm_head)
                 if hasattr(jax_params.lm_head, "qweight")
                 else _bf16_from_np(jax_params.lm_head)),
        rope_sin=torch.from_numpy(np.array(jax_params.rope_sin, np.float32)),
        rope_cos=torch.from_numpy(np.array(jax_params.rope_cos, np.float32)),
        down_folds=[None if f is None else np.asarray(f, np.int64)
                    for f in (down_folds or [None] * len(layers))],
    )
    return params.to(device)
