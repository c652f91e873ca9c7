"""Fabricate a GPTQ safetensors checkpoint on disk (port of
exllama_tpu/utils/fabricate.py).

Writes a sharded checkpoint in exact GPTQ wire format (int32-packed qweight
/ qzeros, fp16 scales, optional g_idx) with random nibbles, so that the
disk path -- shard scan, wire-format unpack, act-order repack, kernels --
runs at a realistic scale with no model zoo:

    python -m exllama_tpu_torch.utils.fabricate --out DIR --model 7b \\
        --groupsize 128 [--act_order] [--shard_gb 2] [--layers N]

Same shapes, draws (``np.random.default_rng(seed)``, in the same order) and
file layout as the JAX package's tool, so for one seed both write the same
bytes; the files are written by the port's own safetensors writer
(``formats.loader.save_safetensors``), so no ``safetensors`` package is
needed. ``--layers`` cuts the depth (the default is the model's). Absolute
perplexity on random weights means nothing; ``benchmark -d DIR -v`` holds
the kernels against the plain path on it. ``fabricate_lora`` writes a LoRA
adapter in the PEFT layout for a model's shapes (``lora.ExLlamaLora``
loads it).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

from exllama_tpu_torch.formats.loader import save_safetensors

# (hidden, intermediate, layers, heads, kv_heads); 70b uses GQA as
# Llama-2-70B does
MODEL_SHAPES = {
    "tiny": (256, 512, 2, 4, 2),
    "7b": (4096, 11008, 32, 32, 32),
    "13b": (5120, 13824, 40, 40, 40),
    "33b": (6656, 17920, 60, 52, 52),
    "70b": (8192, 28672, 80, 64, 8),
}
VOCAB = 32000


def _wire_quant(rng, k: int, n: int, groupsize: int, act_order: bool):
    """Random tensors in GPTQ wire format: qweight [K/8, N] int32 (8
    nibbles a word), qzeros [K/gs, N/8] int32, scales [K/gs, N] fp16, and
    for act-order g_idx [K] int32 (the group of each input row, shuffled)."""
    qweight = rng.integers(0, 2**32, size=(k // 8, n), dtype=np.uint32)
    qzeros = rng.integers(0, 2**32, size=(k // groupsize, n // 8),
                          dtype=np.uint32)
    scales = (
        rng.random((k // groupsize, n), dtype=np.float32) * 0.004 + 0.002
    ).astype(np.float16)
    out = {
        "qweight": qweight.view(np.int32),
        "qzeros": qzeros.view(np.int32),
        "scales": scales,
    }
    if act_order:
        g_idx = np.repeat(
            np.arange(k // groupsize, dtype=np.int32), groupsize
        )
        rng.shuffle(g_idx)
        out["g_idx"] = g_idx
    return out


def fabricate(out_dir: str, model: str = "7b", groupsize: int = 128,
              act_order: bool = False, shard_gb: float = 2.0,
              seed: int = 0, verbose: bool = True,
              layers: Optional[int] = None):
    """Write the checkpoint; returns (out_dir, total_bytes)."""
    os.makedirs(out_dir, exist_ok=True)
    h, inter, depth, heads, kv_heads = MODEL_SHAPES[model]
    layers = depth if layers is None else layers
    head_dim = h // heads
    kvdim = kv_heads * head_dim
    rng = np.random.default_rng(seed)

    cfg = {
        "hidden_size": h,
        "intermediate_size": inter,
        "num_attention_heads": heads,
        "num_key_value_heads": kv_heads,
        "num_hidden_layers": layers,
        "vocab_size": VOCAB,
        "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0,
        "bos_token_id": 1,
        "eos_token_id": 2,
        "pad_token_id": 0,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)

    cap = int(shard_gb * (1 << 30))
    shard: dict = {}
    shards: list[dict] = []
    shard_bytes = 0
    total = 0

    def put(name, arr):
        nonlocal shard, shard_bytes, total
        if shard_bytes + arr.nbytes > cap and shard:
            shards.append(shard)
            shard = {}
            shard_bytes = 0
        shard[name] = arr
        shard_bytes += arr.nbytes
        total += arr.nbytes

    def put_quant(prefix, k, n):
        for kk, vv in _wire_quant(rng, k, n, groupsize, act_order).items():
            put(f"{prefix}.{kk}", vv)

    emb_scale = 1.0 / np.sqrt(h)
    put(
        "model.embed_tokens.weight",
        (rng.standard_normal((VOCAB, h), dtype=np.float32)
         * emb_scale).astype(np.float16),
    )
    for i in range(layers):
        p = f"model.layers.{i}"
        put(f"{p}.input_layernorm.weight", np.ones(h, np.float16))
        put(f"{p}.post_attention_layernorm.weight", np.ones(h, np.float16))
        put_quant(f"{p}.self_attn.q_proj", h, h)
        put_quant(f"{p}.self_attn.k_proj", h, kvdim)
        put_quant(f"{p}.self_attn.v_proj", h, kvdim)
        put_quant(f"{p}.self_attn.o_proj", h, h)
        put_quant(f"{p}.mlp.gate_proj", h, inter)
        put_quant(f"{p}.mlp.up_proj", h, inter)
        put_quant(f"{p}.mlp.down_proj", inter, h)
        if verbose and (i + 1) % 8 == 0:
            print(f" -- fabricated layer {i + 1}/{layers}", flush=True)
    put("model.norm.weight", np.ones(h, np.float16))
    put(
        "lm_head.weight",
        (rng.standard_normal((VOCAB, h), dtype=np.float32)
         * emb_scale).astype(np.float16),
    )
    shards.append(shard)

    n = len(shards)
    weight_map = {}
    for i, sh in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        save_safetensors(sh, os.path.join(out_dir, name))
        for kk in sh:
            weight_map[kk] = name
        if verbose:
            print(f" -- wrote {name} "
                  f"({sum(a.nbytes for a in sh.values()) / 2**30:.2f} GB)",
                  flush=True)
    with open(
        os.path.join(out_dir, "model.safetensors.index.json"), "w"
    ) as f:
        json.dump(
            {"metadata": {"total_size": total}, "weight_map": weight_map}, f
        )
    return out_dir, total


# PEFT's module of each projection a LoRA adapter may target
LORA_MODULES = {"q": "self_attn", "k": "self_attn", "v": "self_attn",
                "o": "self_attn", "gate": "mlp", "up": "mlp", "down": "mlp"}


def fabricate_lora(out_dir: str, config, targets, r: int = 8,
                   alpha: float = 16.0, scale: float = 1.0,
                   seed: int = 0) -> "tuple[str, str]":
    """Write a LoRA adapter in the PEFT layout for a model of ``config``'s
    shapes: ``adapter_config.json`` (r, lora_alpha, target_modules) and
    ``adapter_model.safetensors`` with ``base_model.model.model.layers.N.
    {self_attn,mlp}.P_proj.lora_A.weight`` [r, in] and ``lora_B.weight``
    [out, r]. ``targets``: the projections ("q", ..., "down") of every
    layer, or {layer: projections}. A is drawn with std scale / sqrt(in)
    and B with std scale / sqrt(r) from ``np.random.default_rng(seed)``, so
    the low-rank term of a unit-RMS input has std ~ scale**2 * alpha / r
    (scale 0 writes zeros). Returns (config path, adapter path)."""
    os.makedirs(out_dir, exist_ok=True)
    c = config
    qdim = c.num_attention_heads * c.head_dim
    kvdim = c.num_key_value_heads * c.head_dim
    shapes = {"q": (c.hidden_size, qdim), "k": (c.hidden_size, kvdim),
              "v": (c.hidden_size, kvdim), "o": (qdim, c.hidden_size),
              "gate": (c.hidden_size, c.intermediate_size),
              "up": (c.hidden_size, c.intermediate_size),
              "down": (c.intermediate_size, c.hidden_size)}
    if not isinstance(targets, dict):
        targets = {li: targets for li in range(c.num_hidden_layers)}
    rng = np.random.default_rng(seed)
    tensors = {}
    for li in sorted(targets):
        for p in targets[li]:
            k, n = shapes[p]
            base = (f"base_model.model.model.layers.{li}."
                    f"{LORA_MODULES[p]}.{p}_proj")
            a = rng.standard_normal((r, k), dtype=np.float32) * np.float32(
                scale / np.sqrt(k))
            b = rng.standard_normal((n, r), dtype=np.float32) * np.float32(
                scale / np.sqrt(r))
            tensors[f"{base}.lora_A.weight"] = a
            tensors[f"{base}.lora_B.weight"] = b
    names = sorted({p for ps in targets.values() for p in ps},
                   key=list(LORA_MODULES).index)
    cfg_path = os.path.join(out_dir, "adapter_config.json")
    with open(cfg_path, "w") as f:
        json.dump({"r": r, "lora_alpha": alpha, "fan_in_fan_out": False,
                   "bias": "none", "peft_type": "LORA",
                   "target_modules": [f"{p}_proj" for p in names]}, f)
    path = os.path.join(out_dir, "adapter_model.safetensors")
    save_safetensors(tensors, path)
    return cfg_path, path


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="fabricate a GPTQ safetensors checkpoint"
    )
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--model", type=str, default="7b",
                    choices=list(MODEL_SHAPES))
    ap.add_argument("--groupsize", type=int, default=128)
    ap.add_argument("--act_order", action="store_true")
    ap.add_argument("--shard_gb", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    t0 = time.time()
    out, total = fabricate(
        args.out, args.model, args.groupsize, args.act_order,
        args.shard_gb, args.seed, layers=args.layers,
    )
    print(
        f" -- {args.model} {args.groupsize}g"
        f"{' act-order' if args.act_order else ''}: "
        f"{total / 2**30:.2f} GB in {time.time() - t0:.1f} s → {out}"
    )


if __name__ == "__main__":
    main()
