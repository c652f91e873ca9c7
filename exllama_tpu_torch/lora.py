"""LoRA adapters on the quantized base weights (port of exllama_tpu/lora.py).

``ExLlamaLora`` loads a PEFT adapter (``.safetensors``, read by the port's
own reader, so no ``safetensors`` package is needed; or a torch ``.bin``),
parses ``model.layers.N.{self_attn,mlp}.{q,k,v,o,gate,up,down}_proj.
lora_{A,B}`` keys, checks their shapes against the config's projection
shapes, transposes them to [in, r] / [r, out] and scales B by alpha / r
once, in f32. The runtime is an unmerged low-rank add after each adapted
projection (``ops.quant.lora_delta``, ``q4_matmul(lora=)``); the model keeps
the fused kernels that would skip it off (``models.llama._decoder_layer``).

Layout: one :class:`LayerLora` a layer (``stacked``), each pair bf16 on the
model's device. A layer without an adapter on a projection that another
layer adapts gets a zero pair of the same rank (a zero low-rank add is
exact); a projection adapted nowhere is None. Act-order layers whose down
permutation was folded into the gate / up columns at load
(``ModelParams.down_folds``) get their gate / up B columns and down A rows
permuted the same way.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from exllama_tpu_torch.formats.loader import SafetensorsFile

_PROJ_NAMES = ("q", "k", "v", "o", "gate", "up", "down")


@dataclasses.dataclass
class LayerLora:
    """One layer's adapter pairs ([in, r] / [r, out] bf16 each); None = the
    projection is adapted nowhere in the model."""

    q: Optional[tuple[torch.Tensor, torch.Tensor]]
    k: Optional[tuple[torch.Tensor, torch.Tensor]]
    v: Optional[tuple[torch.Tensor, torch.Tensor]]
    o: Optional[tuple[torch.Tensor, torch.Tensor]]
    gate: Optional[tuple[torch.Tensor, torch.Tensor]]
    up: Optional[tuple[torch.Tensor, torch.Tensor]]
    down: Optional[tuple[torch.Tensor, torch.Tensor]]


def _read_safetensors(path: str) -> "dict[str, np.ndarray]":
    """Every tensor of a safetensors file as f32 numpy (bf16 from its raw
    bits)."""
    f = SafetensorsFile(path)
    out = {}
    for key in f.keys():
        a = f.get(key)
        if f.dtype_of(key) == "BF16":
            a = (a.astype(np.uint16).astype(np.uint32) << 16).view(np.float32)
        out[key] = np.asarray(a, np.float32)
    return out


class ExLlamaLora:
    """An adapter for ``model``; pass it to ``ExLlama.forward(lora=)``,
    ``ExLlamaGenerator.lora`` or ``ExLlamaAltGenerator.Settings.lora``."""

    def __init__(self, model, lora_config_path: str, lora_path: str):
        self.lora_config_path = lora_config_path
        self.lora_path = lora_path
        self.model = model
        self.bias_ignored = False

        with open(lora_config_path) as f:
            read_config = json.load(f)
        self.lora_r = read_config["r"]
        self.lora_alpha = float(read_config["lora_alpha"])
        self.lora_scaling = self.lora_alpha / self.lora_r
        if read_config.get("fan_in_fan_out"):
            raise ValueError("fan_in_fan_out mode not supported")

        if lora_path.endswith(".safetensors"):
            raw = _read_safetensors(lora_path)
        else:
            raw = {k: v.to(torch.float32).numpy() for k, v in torch.load(
                lora_path, map_location="cpu", weights_only=True).items()}

        cfg = model.config
        qdim = cfg.num_attention_heads * cfg.head_dim
        kvdim = cfg.num_key_value_heads * cfg.head_dim
        # the projections' (in, out) from the config: the loaded tensors may
        # be fused into qkv / gateup
        proj_shapes = {
            "q": (cfg.hidden_size, qdim),
            "k": (cfg.hidden_size, kvdim),
            "v": (cfg.hidden_size, kvdim),
            "o": (qdim, cfg.hidden_size),
            "gate": (cfg.hidden_size, cfg.intermediate_size),
            "up": (cfg.hidden_size, cfg.intermediate_size),
            "down": (cfg.intermediate_size, cfg.hidden_size),
        }
        # projection -> {layer: {"A": [in, r], "B": [r, out]}}
        found: dict = {p: {} for p in _PROJ_NAMES}
        for key, tensor in raw.items():
            i = key.find("model.layers.")
            if i == -1:
                raise ValueError(f"unsupported key in {lora_path}: {key}")
            ks = key[i:].split(".")
            layer_idx = int(ks[2])
            proj = ks[4].replace("_proj", "")
            half = ks[5]
            if half == "bias":
                if np.max(np.abs(tensor)) > 1e-6:
                    raise ValueError(f"unsupported nonzero bias: {key}")
                self.bias_ignored = True
                continue
            if proj not in _PROJ_NAMES or half not in ("lora_A", "lora_B"):
                raise ValueError(f"unsupported key in {lora_path}: {key}")
            t_in, t_out = proj_shapes[proj]
            # PEFT stores A as [r, in] and B as [out, r]
            if half == "lora_A" and tensor.shape[1] != t_in:
                raise ValueError(f"incompatible shape: {key}")
            if half == "lora_B" and tensor.shape[0] != t_out:
                raise ValueError(f"incompatible shape: {key}")
            t = tensor.T.copy()
            if half == "lora_B" and self.lora_scaling != 1.0:
                t *= self.lora_scaling
            found[proj].setdefault(layer_idx, {})[half[-1]] = t

        down_folds = model.params.down_folds

        def proj_for_layer(proj: str, li: int):
            entries = found[proj]
            if not entries:
                return None
            k_in, n_out = proj_shapes[proj]
            halves = entries.get(li)
            if halves is None:
                a = np.zeros((k_in, self.lora_r), np.float32)
                b = np.zeros((self.lora_r, n_out), np.float32)
            else:
                if "A" not in halves or "B" not in halves:
                    raise ValueError(f"incomplete A/B pair: layer {li} {proj}")
                a, b = halves["A"], halves["B"]
            fold = down_folds[li] if down_folds is not None else None
            if fold is not None:
                if proj in ("gate", "up"):
                    b = b[:, fold]
                elif proj == "down":
                    a = a[fold, :]
            return tuple(
                torch.from_numpy(np.ascontiguousarray(x)).to(
                    device=model.device, dtype=torch.bfloat16)
                for x in (a, b))

        self.stacked = [
            LayerLora(**{p: proj_for_layer(p, li) for p in _PROJ_NAMES})
            for li in range(cfg.num_hidden_layers)
        ]
