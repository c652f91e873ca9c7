"""The Llama-family model (port of exllama_tpu/models/llama.py), in the
slice configuration: separate kernels per decode layer (no MLP or
attention megakernels), fused qkv / gate-up projections, bf16 KV cache,
exact 4-bit matmuls, a bf16 lm_head, and the deferred K/V rows of a decode
step written after the layer loop with one plain tensor write per layer.

Per layer: K1/K2 (q4 matmul) for every projection, K3 (flash attention),
and on the head K4 (dense GEMV); everything between them is plain tensor
code. PyTorch runs eagerly, so there is no jit: the layer loop is a Python
loop and the cache is updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from exllama_tpu_torch.cache import ExLlamaCache
from exllama_tpu_torch.config import ExLlamaConfig
from exllama_tpu_torch.formats.gptq import QuantTensor, concat_quant_tensors
from exllama_tpu_torch.ops.attention import attend, update_kv_cache
from exllama_tpu_torch.ops.dense import dense_matmul
from exllama_tpu_torch.ops.norms import rms_norm
from exllama_tpu_torch.ops.quant import q4_matmul
from exllama_tpu_torch.ops.rope import apply_rope_sliced, slice_tables


@dataclasses.dataclass
class LayerParams:
    input_norm: torch.Tensor      # [hidden] bf16
    post_norm: torch.Tensor       # [hidden] bf16
    q: Optional[QuantTensor]
    k: Optional[QuantTensor]
    v: Optional[QuantTensor]
    o: QuantTensor
    gate: Optional[QuantTensor]
    up: Optional[QuantTensor]
    down: QuantTensor
    # load-time fused projections; when set, the unfused fields are None
    qkv: Optional[QuantTensor] = None
    gateup: Optional[QuantTensor] = None


@dataclasses.dataclass
class ModelParams:
    embed: torch.Tensor           # [vocab, hidden] bf16
    layers: list                  # list[LayerParams]
    norm: torch.Tensor            # [hidden] bf16
    lm_head: torch.Tensor         # [hidden, vocab] bf16
    rope_sin: torch.Tensor        # [max_seq_len, head_dim] f32
    rope_cos: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def to(self, device) -> "ModelParams":
        def mv(x):
            if x is None:
                return None
            return x.to(device)

        layers = [
            LayerParams(**{
                f.name: mv(getattr(lp, f.name))
                for f in dataclasses.fields(LayerParams)
            })
            for lp in self.layers
        ]
        return ModelParams(
            embed=mv(self.embed), layers=layers, norm=mv(self.norm),
            lm_head=mv(self.lm_head), rope_sin=mv(self.rope_sin),
            rope_cos=mv(self.rope_cos),
        )


def fuse_layer_projections(lp: LayerParams) -> LayerParams:
    """q/k/v -> qkv and gate/up -> gateup; no-op for act-order layers."""
    if lp.qkv is not None or any(
        t.x_map is not None for t in (lp.q, lp.k, lp.v, lp.gate, lp.up)
    ):
        return lp
    return dataclasses.replace(
        lp,
        q=None, k=None, v=None, gate=None, up=None,
        qkv=concat_quant_tensors([lp.q, lp.k, lp.v]),
        gateup=concat_quant_tensors([lp.gate, lp.up]),
    )


def _decoder_layer(
    h: torch.Tensor,                 # [B, T, hidden] bf16
    lp: LayerParams,
    kc: torch.Tensor,                # [B, Hkv, S, D], updated in place
    vc: torch.Tensor,
    *,
    heads: int,
    kv_heads: int,
    head_dim: int,
    eps: float,
    rope_sin: torch.Tensor,          # [1|B, T, 1, D] (slice_tables)
    rope_cos: torch.Tensor,
    past_len,                        # int or [B] tensor
    attend_len: int,
    input_mask: Optional[torch.Tensor],
    defer_kv: bool,
):
    """One decoder layer. Returns (h, k_row, v_row); the rows are the new
    K/V of a deferred (T=1) step, which the caller commits."""
    b, t, _ = h.shape
    nq = heads * head_dim
    nkv = kv_heads * head_dim
    if lp.qkv is not None:
        # the input norm rides in the GEMV prologue at decode M
        fused = q4_matmul(h, lp.qkv, norm_w=lp.input_norm, norm_eps=eps)
        q = fused[..., :nq]
        k = fused[..., nq : nq + nkv]
        v = fused[..., nq + nkv :]
    else:
        a = rms_norm(h, lp.input_norm, eps)
        q = q4_matmul(a, lp.q)
        k = q4_matmul(a, lp.k)
        v = q4_matmul(a, lp.v)
    q = apply_rope_sliced(q.reshape(b, t, heads, head_dim), rope_sin, rope_cos)
    k = apply_rope_sliced(k.reshape(b, t, kv_heads, head_dim), rope_sin, rope_cos)
    v = v.reshape(b, t, kv_heads, head_dim)

    k_row = v_row = None
    if defer_kv:
        k_row, v_row = k, v
        attn = attend(q, kc, vc, past_len, attend_len, input_mask,
                      new_kv=(k, v))
    else:
        update_kv_cache(kc, vc, k, v, past_len)
        attn = attend(q, kc, vc, past_len, attend_len, input_mask)
    h = h + q4_matmul(attn.reshape(b, t, nq), lp.o)

    a = rms_norm(h, lp.post_norm, eps)
    if lp.gateup is not None:
        ni = lp.down.in_features
        fused = q4_matmul(a, lp.gateup)
        g, u = fused[..., :ni], fused[..., ni:]
    else:
        g = q4_matmul(a, lp.gate)
        u = q4_matmul(a, lp.up)
    h = h + q4_matmul(F.silu(g.to(torch.float32)).to(u.dtype) * u, lp.down)
    return h, k_row, v_row


def _forward_impl(
    params: ModelParams,
    cache: ExLlamaCache,
    tokens: torch.Tensor,            # [B, T] int
    past_len,                        # int or [B] tensor
    input_mask: Optional[torch.Tensor],
    *,
    attend_len: int,
    last_token_only: bool,
    preprocess_only: bool,
    heads: int,
    kv_heads: int,
    head_dim: int,
    eps: float,
):
    """One forward chunk over all layers: embedding -> layers -> final norm
    -> lm_head (f32 logits), or None with ``preprocess_only``. Writes the
    chunk's K/V into ``cache`` in place (the cursor is the caller's)."""
    b, t = tokens.shape
    h = params.embed[tokens.to(torch.long)]
    sin_t, cos_t = slice_tables(params.rope_sin, params.rope_cos, past_len, t)
    # deferred commit for decode steps: each layer attends over the cache
    # plus its in-flight row, and the rows are written after the loop
    defer = t == 1
    if defer and not isinstance(past_len, int):
        past_len = past_len.to(device=h.device, dtype=torch.int32)
    rows = []
    for li, lp in enumerate(params.layers):
        h, k_row, v_row = _decoder_layer(
            h, lp, cache.k[li], cache.v[li],
            heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
            rope_sin=sin_t, rope_cos=cos_t, past_len=past_len,
            attend_len=attend_len, input_mask=input_mask, defer_kv=defer,
        )
        rows.append((k_row, v_row))
    if defer:
        for li, (k_row, v_row) in enumerate(rows):
            update_kv_cache(cache.k[li], cache.v[li], k_row, v_row, past_len)

    if preprocess_only:
        return None
    if last_token_only:
        h = h[:, -1:, :]
    h = rms_norm(h, params.norm, eps)
    return dense_matmul(h, params.lm_head)


def _require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch paths"
        )
    return device


class ExLlama:
    """Model wrapper: owns params + config, exposes ``forward``.

    ``device`` defaults to the card; with no card present construction
    fails rather than falling back to the CPU.
    """

    def __init__(
        self,
        config: ExLlamaConfig,
        params: Optional[ModelParams] = None,
        device="cuda",
    ):
        self.config = config
        self.device = _require_device(device)
        if params is None:
            from exllama_tpu_torch.formats.loader import load_model_params

            params = load_model_params(config, device=self.device)
        elif params.device != self.device:
            params = params.to(self.device)
        self.params = params

    def _attend_len(self, upto: int) -> int:
        bucket = self.config.tuning.attn_len_bucket
        if bucket <= 0:
            return self.config.max_seq_len
        return min(self.config.max_seq_len, -(-upto // bucket) * bucket)

    def num_params_bytes(self) -> int:
        total = 0
        p = self.params
        for x in (p.embed, p.norm, p.lm_head, p.rope_sin, p.rope_cos):
            total += x.numel() * x.element_size()
        for lp in p.layers:
            for f in dataclasses.fields(LayerParams):
                x = getattr(lp, f.name)
                if isinstance(x, QuantTensor):
                    for t in (x.qweight, x.scales, x.zscale, x.x_map):
                        if t is not None:
                            total += t.numel() * t.element_size()
                elif x is not None:
                    total += x.numel() * x.element_size()
        return total

    @torch.inference_mode()
    def forward(
        self,
        input_ids,                    # [B, T] int (numpy or torch)
        cache: ExLlamaCache,
        last_id_only: bool = True,
        preprocess_only: bool = False,
        input_mask=None,              # [B, S_max] bool, True = valid
    ):
        """Chunked forward. Advances ``cache.current_seq_len`` and writes the
        cache in place. Returns f32 logits [B, 1, vocab] / [B, T, vocab], or
        None with ``preprocess_only``."""
        cfg = self.config
        tokens = torch.as_tensor(input_ids, dtype=torch.int32).to(self.device)
        if input_mask is not None:
            input_mask = torch.as_tensor(input_mask, dtype=torch.bool).to(
                self.device
            )
        b, q_len = tokens.shape

        remaining = q_len
        start = 0
        result = None
        while remaining > 0:
            chunk = min(remaining, cfg.max_input_len // max(b, 1), q_len)
            # bound (past+cs)*cs <= max_attention_size
            past = cache.current_seq_len
            if (past + chunk) * chunk > cfg.max_attention_size:
                cs = int(
                    (-past + math.sqrt(past * past + 4.0 * cfg.max_attention_size))
                    / 2.0
                )
                chunk = max(min(chunk, cs), 1)
            is_last = start + chunk >= q_len
            logits = _forward_impl(
                self.params, cache, tokens[:, start : start + chunk], past,
                input_mask,
                attend_len=self._attend_len(past + chunk),
                last_token_only=last_id_only,
                preprocess_only=preprocess_only and is_last or not is_last,
                heads=cfg.num_attention_heads,
                kv_heads=cfg.num_key_value_heads,
                head_dim=cfg.head_dim,
                eps=cfg.rms_norm_eps,
            )
            cache.current_seq_len += chunk
            if is_last:
                result = logits
            start += chunk
            remaining -= chunk
        return result
