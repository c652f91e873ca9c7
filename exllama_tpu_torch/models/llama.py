"""The Llama-family model (port of exllama_tpu/models/llama.py): fused
qkv / gate-up projections, a bf16, int8 or int4 KV
cache (``kv_cache_dtype``; optionally padded to a head width K3 takes,
``pad_head_dim``), 4-bit matmuls in the arithmetic ``matmul_impl`` names
(exact by default, the W4A8 turbo modes opt-in, ``"xla"`` the plain path
as an oracle) and a bf16 or 4-bit (``quantize_lm_head``) lm_head, with
the JAX package's decode
knobs (``TuningParams.fuse_mlp / fuse_attn / fuse_qkv / commit_impl``, its
defaults too).

In the default configuration a decode step (T=1, deferred K/V commit) runs
per layer K1 (qkv GEMV with the input norm) and K7 (attention -> o-proj ->
MLP in one launch), then commits every layer's K/V rows, and ends in K4
(logits) or K5 (greedy ids). With ``fuse_qkv`` K7 also runs the qkv GEMV;
with ``commit_impl="pallas"`` the commit is one K8 launch. Short prefill
chunks (B*T <= 32) run their MLP as one K6 launch; long ones run K2 and
K3. With the fuse flags off every decode layer runs the separate kernels
K1 and K3. Under ``matmul_impl="pallas_a8"`` / ``"pallas_a8x2"`` every
GEMV of those kernels (K1, K6, K7) runs K9's int8-activation arithmetic;
under ``"pallas_a8t"`` long prefill chunks also run their matmuls on the
int8 tensor cores: K11 against a tensor's resident int8 image
(``_attach_prefill_w8``), K10 where it has none. ``EXL_GLU_FUSE=1`` in the
environment makes the long-prefill down projection form silu(gate)*up in
its kernel (K12). A quantized cache is read by the same K3 / K7 and written
by the same K8, each dispatching on the cache format; a prefill chunk is
quantized as it is written and attended from the cache, a decode step
attends to its own row in bf16 and quantizes it at the commit. A LoRA
adapter (``lora.ExLlamaLora``; ``forward(..., lora=)``) adds its low-rank
term to each adapted projection's output and keeps the fused kernels that
would skip it off, as the JAX gates do: any adapter refuses K7's whole-layer
launch, an adapted o K7 altogether (K3 then attends and K1 projects), an
adapted gate / up / down K6 and K7's MLP phases, and an adapted q / k / v
takes the input norm out of K1's prologue (the adapter reads the same normed
x). Everything between kernels is plain tensor code. PyTorch
runs eagerly, so there is no jit: the layer loop is a Python loop and the
cache is updated in place. On a mesh (``parallel.mesh``) each rank runs the
same forward on its shard: local heads, the separate kernels (K1 and K3 a
step, K2 and K3 a prefill; K6 / K7 off), one all-reduce after o and one
after down, and the batch split over dp (``forward_chunk``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from exllama_tpu_torch.cache import ExLlamaCache
from exllama_tpu_torch.config import KV_CACHE_DTYPES, ExLlamaConfig
from exllama_tpu_torch.formats.gptq import (
    QuantTensor,
    concat_quant_tensors,
    with_w8,
    with_w8_scale,
)
from exllama_tpu_torch.ops.attention import (
    attend,
    attend_xla,
    commit_kv_cache,
    resolve_attn_impl,
    update_kv_cache,
)
from exllama_tpu_torch.ops.attn_block import (
    attn_block_o,
    attn_o_applicable,
    layer_step,
    layer_step_applicable,
    layer_tail,
    same_groupsize,
)
from exllama_tpu_torch.ops.dense import dense_matmul, head_argmax
from exllama_tpu_torch.ops.mlp import fused_mlp_applicable, q4_mlp, silu_mul
from exllama_tpu_torch.ops.norms import rms_norm
from exllama_tpu_torch.ops.quant import lora_delta, q4_matmul
from exllama_tpu_torch.ops.rope import apply_rope_sliced, slice_tables
from exllama_tpu_torch.parallel.mesh import all_gather_dim, all_reduce_sum


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
    lm_head: "torch.Tensor | QuantTensor"   # [hidden, vocab] bf16, or 4-bit
    rope_sin: torch.Tensor        # [max_seq_len, head_dim] f32
    rope_cos: torch.Tensor
    # the act-order permutation folded into each layer's gate/up columns
    # (int64 numpy [intermediate], None where nothing was folded), which
    # lora.ExLlamaLora applies to the adapters of those projections
    down_folds: Optional[list] = None
    # the rank's mesh (parallel.mesh.Mesh) when these are one rank's shard
    # (parallel.mesh.shard_params); forward_chunk reads it
    mesh: object = None

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
            rope_cos=mv(self.rope_cos), down_folds=self.down_folds,
            mesh=self.mesh,
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
    ksc: Optional[torch.Tensor],     # [B, Hkv, S] f32 (int8 / int4 cache)
    vsc: Optional[torch.Tensor],
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
    mlp_fuse: bool = True,
    attn_fuse: bool = True,
    qkv_fuse: bool = False,
    matmul_impl: str = "auto",
    attn_impl: str = "auto",
    rows_out=None,
    lora=None,
    tp_group=None,
):
    """One decoder layer (exllama_tpu/models/llama.py:_decoder_layer).
    ``lora``: the layer's ``lora.LayerLora`` or None. ``tp_group``: the
    tensor-parallel group of a rank's shard (``heads`` / ``kv_heads`` are
    then the rank's): o and down give partial sums, each all-reduced once
    and added to the residual (``parallel.mesh.all_reduce_sum``). Returns (h,
    k_row, v_row); the rows are the new K/V of a deferred (T=1) step, which
    the caller commits. ``rows_out`` (the layer's views of
    ``ExLlamaCache.rows``): where the whole layer is one K7 launch, the
    kernel writes the rows there and they are returned; the other paths
    return rows of their own (their V row is a slice of the qkv output,
    which a copy into the buffer would cost a launch a layer to stage).
    ``attn_impl`` routes
    the attention of the width the cache stores (``resolve_attn_impl``):
    K3, or the einsum route, which also keeps the fused K7 off, as the JAX
    package keeps its megakernels to "flash"."""
    impl = matmul_impl
    b, t, hidden = h.shape
    nq = heads * head_dim
    nkv = kv_heads * head_dim
    # the width attended: the padded cache's, else head_dim (an int4 cache
    # stores D/2 bytes)
    d_pad = max(kc.shape[-1] - head_dim, 0)
    flash = resolve_attn_impl(attn_impl, head_dim + d_pad) == "flash"
    attend_fn = attend if flash else attend_xla

    def lora_ab(name):
        return None if lora is None else getattr(lora, name)

    def proj(x, qt, name):
        return q4_matmul(x, qt, impl, lora=lora_ab(name))

    def lora_add(out, x, name):
        # the low-rank term of one slice of a fused projection
        ab = lora_ab(name)
        return out if ab is None else out + lora_delta(x, ab)

    qkv_lora = any(lora_ab(n) is not None for n in ("q", "k", "v"))
    mlp_lora = any(lora_ab(n) is not None for n in ("gate", "up", "down"))
    o_lora = lora_ab("o") is not None
    mlp_ok = mlp_fuse and fused_mlp_applicable(
        lp.gateup, lp.down, hidden, b * t, impl, has_lora=mlp_lora)
    attn_ok = (flash and defer_kv and attn_fuse
               and attn_o_applicable(lp.o, hidden, heads, head_dim, t, True,
                                     batch=b, kv_heads=kv_heads, impl=impl,
                                     has_lora=o_lora))

    # the whole layer in one K7 launch (llama.py:188-232)
    if (qkv_fuse and attn_ok and mlp_ok
            and layer_step_applicable(lp.qkv, lp.o, hidden, heads, head_dim,
                                      has_lora=qkv_lora or mlp_lora or o_lora)
            and same_groupsize(lp.qkv, lp.o, lp.gateup, lp.down)):
        return layer_step(
            h, lp.qkv, lp.input_norm, rope_sin, rope_cos, kc, vc, past_len,
            attend_len, lp.o, lp.post_norm, lp.gateup, lp.down, eps, heads,
            kv_heads, head_dim, input_mask=input_mask, impl=impl,
            k_scale=ksc, v_scale=vsc, rows_out=rows_out,
        )

    if lp.qkv is not None and not qkv_lora:
        # the input norm rides in the GEMV prologue at decode M
        fused = q4_matmul(h, lp.qkv, impl, norm_w=lp.input_norm,
                          norm_eps=eps)
        q = fused[..., :nq]
        k = fused[..., nq : nq + nkv]
        v = fused[..., nq + nkv :]
    elif lp.qkv is not None:
        # the adapters read the same normed x as the kernel (llama.py:245)
        a = rms_norm(h, lp.input_norm, eps)
        fused = q4_matmul(a, lp.qkv, impl)
        q = lora_add(fused[..., :nq], a, "q")
        k = lora_add(fused[..., nq : nq + nkv], a, "k")
        v = lora_add(fused[..., nq + nkv :], a, "v")
    else:
        a = rms_norm(h, lp.input_norm, eps)
        q = proj(a, lp.q, "q")
        k = proj(a, lp.k, "k")
        v = proj(a, lp.v, "v")
    q = apply_rope_sliced(q.reshape(b, t, heads, head_dim), rope_sin, rope_cos)
    k = apply_rope_sliced(k.reshape(b, t, kv_heads, head_dim), rope_sin, rope_cos)
    v = v.reshape(b, t, kv_heads, head_dim)
    # padded-head-dim cache (llama.py:262-275): q, k, v are zero-padded to
    # the cache's width -- pad columns add exactly 0 to the scores and give
    # 0 output columns, sliced off below -- and q is pre-scaled so that the
    # kernel's 1/sqrt(padded width) leaves 1/sqrt(head_dim)
    if d_pad > 0:
        f = (kc.shape[-1] / head_dim) ** 0.5
        q = F.pad((q.to(torch.float32) * f).to(q.dtype), (0, d_pad))
        k = F.pad(k, (0, d_pad))
        v = F.pad(v, (0, d_pad))

    k_row = v_row = None
    attn = None
    if defer_kv:
        k_row, v_row = k, v
        if attn_ok:
            if mlp_ok and same_groupsize(lp.o, lp.gateup, lp.down):
                # the layer tail in one K7 launch (llama.py:286-315)
                h = layer_tail(h, q, kc, vc, past_len, attend_len, lp.o,
                               lp.post_norm, lp.gateup, lp.down, eps, (k, v),
                               input_mask=input_mask, impl=impl,
                               k_scale=ksc, v_scale=vsc)
                return h, k_row, v_row
            # attention + o-projection + residual in one K7 launch
            h = attn_block_o(h, q, kc, vc, past_len, attend_len, lp.o,
                             (k, v), input_mask=input_mask, impl=impl,
                             k_scale=ksc, v_scale=vsc)
        else:
            attn = attend_fn(q, kc, vc, past_len, attend_len, input_mask,
                             new_kv=(k, v), k_scale=ksc, v_scale=vsc)
    else:
        # the chunk is quantized as it is written and attended from the
        # cache: its queries see their own keys quantized (llama.py:328)
        update_kv_cache(kc, vc, k, v, past_len, ksc, vsc)
        attn = attend_fn(q, kc, vc, past_len, attend_len, input_mask,
                         k_scale=ksc, v_scale=vsc)
    if attn is not None:
        if d_pad > 0:
            attn = attn[..., :head_dim]
        attn2 = attn.reshape(b, t, nq)
        if tp_group is not None and lp.o.x_map is not None:
            # act-order o under tp (llama.py:335-346): its K permutation
            # crosses the head split, so gather the whole attention output
            # and take this rank's rows by its slice of x_map
            full = all_gather_dim(attn2, tp_group, -1)
            x_o = full[..., lp.o.x_map.to(torch.long)]
            h = h + all_reduce_sum(
                q4_matmul(x_o, dataclasses.replace(lp.o, x_map=None), impl),
                tp_group)
        else:
            h = h + all_reduce_sum(proj(attn2, lp.o, "o"), tp_group)

    if mlp_ok:
        # the MLP block in one K6 launch (llama.py:353-362)
        return (q4_mlp(h, lp.post_norm, lp.gateup, lp.down, eps, impl),
                k_row, v_row)
    a = rms_norm(h, lp.post_norm, eps)
    ni = lp.down.in_features
    if (lp.gateup is not None and not mlp_lora
            and os.environ.get("EXL_GLU_FUSE", "0") == "1"):
        # opt-in (llama.py:367-378): the down projection forms
        # silu(gate)*up from the raw gate|up output in its kernel (K12); up
        # starts at column ni of the port's unpadded fused tensor
        fused = q4_matmul(a, lp.gateup, impl)
        h = h + all_reduce_sum(q4_matmul(fused, lp.down, impl, glu=(ni, ni)),
                               tp_group)
        return h, k_row, v_row
    if lp.gateup is not None:
        fused = q4_matmul(a, lp.gateup, impl)
        g = lora_add(fused[..., :ni], a, "gate")
        u = lora_add(fused[..., ni:], a, "up")
    else:
        g = proj(a, lp.gate, "gate")
        u = proj(a, lp.up, "up")
    mid = silu_mul(g, u)
    h = h + all_reduce_sum(proj(mid, lp.down, "down"), tp_group)
    return h, k_row, v_row


def _split_rows(x, sl, b):
    """Rows ``sl`` of a batch-major operand of batch ``b`` (ints, None and
    per-call operands pass through)."""
    if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == b:
        return x[sl]
    return x


def _split_lora(lora, sl, b):
    """The rows ``sl`` of a per-row stacked adapter ([B, in, r] pairs); a
    whole-batch adapter passes through."""
    if lora is None:
        return None
    out = []
    for ll in lora:
        out.append(dataclasses.replace(ll, **{
            f.name: None if getattr(ll, f.name) is None else tuple(
                _split_rows(t, sl, b) if t.dim() == 3 else t
                for t in getattr(ll, f.name))
            for f in dataclasses.fields(ll)}))
    return out


@torch.inference_mode()
def forward_chunk(params: ModelParams, cache: ExLlamaCache,
                  tokens: torch.Tensor, past_len, input_mask, **kw):
    """One forward chunk over all layers (exllama_tpu/models/llama.py:
    forward_chunk): :func:`_forward_rank` on this rank's part of the
    batch. On a mesh (``params.mesh``, one rank's shard from
    ``parallel.mesh.shard_params``) the heads are the rank's under tp, the
    fused K6 / K7 launches stay off (their in-kernel residual adds cannot
    straddle the all-reduce, as the JAX package keeps its megakernels off
    under tp: llama.py:458-470) and o / down all-reduce their partials;
    under dp a batch that is ``dp`` times the cache's rows is split, this
    replica computes its rows and the outputs are gathered over dp (every
    rank returns the whole batch's); any other batch is computed whole on
    every replica (the engine's B = 1 admission scratch). A LoRA adapter
    under tp raises, as in the JAX package (llama.py:707-710)."""
    mesh = params.mesh
    if mesh is None or mesh.tp * mesh.dp == 1:
        return _forward_rank(params, cache, tokens, past_len, input_mask,
                             **kw)
    if mesh.tp > 1:
        if kw.get("lora") is not None:
            raise NotImplementedError(
                "LoRA is not supported over tensor parallelism (as in the "
                "JAX package)")
        kw.update(heads=kw["heads"] // mesh.tp,
                  kv_heads=kw["kv_heads"] // mesh.tp,
                  mlp_fuse=False, attn_fuse=False, qkv_fuse=False,
                  tp_group=mesh.group("tp"))
    b = tokens.shape[0]
    if mesh.dp == 1 or cache.batch_size * mesh.dp != b:
        return _forward_rank(params, cache, tokens, past_len, input_mask,
                             **kw)
    from exllama_tpu_torch.parallel.multihost import local_batch_slice

    sl = local_batch_slice(b, mesh)
    if kw.get("lora") is not None:
        kw["lora"] = _split_lora(kw["lora"], sl, b)
    out = _forward_rank(params, cache, tokens[sl],
                        _split_rows(past_len, sl, b),
                        _split_rows(input_mask, sl, b), **kw)
    return None if out is None else all_gather_dim(out, mesh.dp_group, 0)


def _forward_rank(
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
    head_mode: str = "logits",
    mlp_fuse: bool = True,
    attn_fuse: bool = True,
    qkv_fuse: bool = False,
    commit_impl: str = "auto",
    matmul_impl: str = "auto",
    attn_impl: str = "auto",
    lora=None,
    tp_group=None,
):
    """One forward chunk over all layers on one rank (exllama_tpu/models/
    llama.py:_forward_impl): embedding -> layers -> final
    norm -> lm_head. Returns f32 logits [B, T|1, vocab], int32 greedy token
    ids [B, T|1] with ``head_mode="argmax"`` (kernel K5 over a bf16 head, no
    logits materialized; a 4-bit head's logits through ``q4_matmul``, then
    argmax, as the JAX package does), or None with ``preprocess_only``.
    Writes the chunk's K/V into ``cache`` in place; the cursor
    ``cache.current_seq_len`` is the caller's. ``past_len`` is an int
    (checked on the host; on the card a T = 1 step fills ``cache.cursor``
    with it) or a tensor read on the device only: ``cache.cursor`` itself
    for the captured decode step (``generator.DecodeLoop``), whose rope
    rows, kernels and commit then all read the device cursor and whose
    host checks the position it knows. The fuse flags, ``commit_impl``, ``matmul_impl`` and
    ``attn_impl`` are the JAX package's knobs; ``matmul_impl`` defaults to
    the exact kernels, ``attn_impl`` to K3 where it takes the head dim.
    ``lora``: an adapter's per-layer ``LayerLora`` list
    (``ExLlamaLora.stacked``) or None."""
    if head_mode not in ("logits", "argmax"):
        raise ValueError(f"head_mode {head_mode!r}")
    b, t = tokens.shape
    h = params.embed[tokens.to(torch.long)]
    sin_t, cos_t = slice_tables(params.rope_sin, params.rope_cos, past_len, t)
    # deferred commit for decode steps: each layer attends over the cache
    # plus its in-flight row, and the rows are written after the loop
    defer = t == 1
    if not isinstance(past_len, int):
        past_len = past_len.to(device=h.device, dtype=torch.int32)
    cursor = past_len       # what the layers' kernels and K8 read
    if defer and isinstance(past_len, int):
        # the kernels skip a row whose cursor is outside the cache, so an
        # int is checked here
        if not 0 <= past_len < cache.k[0].shape[2]:
            raise ValueError(f"forward_chunk: cursor {past_len} outside the "
                             f"cache")
        if h.device.type == "cuda":
            # from device memory: one fill of the cache's buffer a step, not
            # one tensor a layer (the plain per-layer commit keeps the int:
            # a slice copy a tensor)
            cursor = cache.cursor.fill_(past_len)
    k_rows, v_rows = [], []
    # only K7's whole-layer launch (qkv_fuse) writes into the cache's rows
    staged = defer and qkv_fuse
    quantized = cache.k_scale is not None
    for li, lp in enumerate(params.layers):
        rows = (cache.rows[0, li], cache.rows[1, li]) if staged else None
        h, k_row, v_row = _decoder_layer(
            h, lp, cache.k[li], cache.v[li],
            cache.k_scale[li] if quantized else None,
            cache.v_scale[li] if quantized else None,
            heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
            rope_sin=sin_t, rope_cos=cos_t, past_len=cursor,
            attend_len=attend_len, input_mask=input_mask, defer_kv=defer,
            mlp_fuse=mlp_fuse, attn_fuse=attn_fuse, qkv_fuse=qkv_fuse,
            matmul_impl=matmul_impl, attn_impl=attn_impl, rows_out=rows,
            lora=None if lora is None else lora[li], tp_group=tp_group,
        )
        k_rows.append(k_row)
        v_rows.append(v_row)
        staged = staged and k_row is rows[0] and v_row is rows[1]
    if defer:
        # the step's rows were attended in bf16; they are quantized here,
        # so the next step sees them quantized (llama.py:546-556); where
        # every layer wrote its rows into the cache's buffer, the commit
        # reads the buffer as it is (else it stacks the rows)
        if staged:
            k_rows, v_rows = cache.rows[0], cache.rows[1]
        commit_kv_cache(cache.k, cache.v, k_rows, v_rows,
                        cursor if commit_impl == "pallas" else past_len,
                        cache.k_scale, cache.v_scale, impl=commit_impl,
                        ptrs=cache.kv_ptrs)

    if preprocess_only:
        return None
    if last_token_only:
        h = h[:, -1:, :]
    if isinstance(params.lm_head, QuantTensor):
        # llama.py:581-588: K1 at <= 32 rows, K2 above ("xla": plain)
        logits = q4_matmul(rms_norm(h, params.norm, eps), params.lm_head,
                           matmul_impl)
        if head_mode == "argmax":
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return logits.to(torch.float32)
    if head_mode == "argmax":
        return head_argmax(h, params.norm, params.lm_head, eps,
                           impl=matmul_impl)
    h = rms_norm(h, params.norm, eps)
    return dense_matmul(h, params.lm_head, impl=matmul_impl)


def _require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch paths"
        )
    return device


_W8_FIELDS = ("q", "k", "v", "o", "gate", "up", "down", "qkv", "gateup")
# Which tensors get an int8 image first when only some fit: down, then the
# MLP columns, then qkv; o never gets one. The order is the JAX package's,
# measured on a TPU (exllama_tpu/models/llama.py:797-803), kept so that the
# two packages attach the same images.
_W8_PRIORITY = {"down": 0, "gateup": 1, "gate": 1, "up": 1,
                "qkv": 2, "q": 2, "k": 2, "v": 2, "o": 9}
W8_HEADROOM_GB = 2.5      # left for activations and workspace under "auto"


def _quant_bytes(qt: QuantTensor, image_only: bool = False) -> int:
    fields = ("w8", "w8_scale") if image_only else (
        "qweight", "scales", "zscale", "x_map", "w8", "w8_scale")
    return sum(t.numel() * t.element_size()
               for t in (getattr(qt, f) for f in fields) if t is not None)


def _attach_prefill_w8(params: ModelParams, config,
                       tp: int = 1) -> ModelParams:
    """Attach the resident int8 weight images of turbo prefill
    (formats.gptq.with_w8; exllama_tpu/models/llama.py:_attach_prefill_w8).
    ``prefill_w8="on"`` (or "off", when called directly) attaches every
    image but o's; "auto" attaches, in priority order, the images that fit
    ``prefill_w8_budget_gb`` next to the packed weights and a batch-1 KV
    cache at ``max_seq_len``. An image costs K*N + 4*N bytes, twice the
    packed weight. Every tensor without an image gets the column scales
    alone (4 bytes a column), which K10 reads."""
    tune = config.tuning
    tensors = [(li, f, getattr(lp, f)) for li, lp in enumerate(params.layers)
               for f in _W8_FIELDS if getattr(lp, f) is not None]
    w8_budget = None          # None: attach everything
    if tune.prefill_w8 == "auto":
        budget_gb = tune.prefill_w8_budget_gb
        if budget_gb is None:
            if params.device.type != "cuda":
                raise ValueError("prefill_w8='auto' off the card needs "
                                 "prefill_w8_budget_gb")
            total = torch.cuda.get_device_properties(params.device).total_memory
            budget_gb = total / 2 ** 30 - W8_HEADROOM_GB
        packed = sum(_quant_bytes(qt) for _, _, qt in tensors)
        kv_bytes = int(2 * config.num_hidden_layers * config.max_seq_len
                       * config.num_key_value_heads * config.head_dim
                       * KV_CACHE_DTYPES[tune.kv_cache_dtype]) // tp
        w8_budget = max(budget_gb * 2 ** 30 - packed - kv_bytes, 0)

    spent = 0
    images = set()
    # stable: by priority, then layer, then the order of _W8_FIELDS
    for li, f, qt in sorted(tensors,
                            key=lambda t: (_W8_PRIORITY[t[1]], t[0])):
        cost = qt.in_features * qt.out_features + 4 * qt.out_features
        if _W8_PRIORITY[f] >= 9 or (w8_budget is not None
                                    and spent + cost > w8_budget):
            continue
        spent += cost
        images.add((li, f))

    layers = [
        dataclasses.replace(lp, **{
            f: with_w8(qt) if (li, f) in images else with_w8_scale(qt)
            for lj, f, qt in tensors if lj == li})
        for li, lp in enumerate(params.layers)
    ]
    return dataclasses.replace(params, layers=layers)


class ExLlama:
    """Model wrapper: owns params + config, exposes ``forward``.

    ``device`` defaults to the card; with no card present construction
    fails rather than falling back to the CPU. ``mesh``
    (``parallel.mesh.make_mesh``): this rank loads (or, given whole
    ``params``, keeps) its shard, ``parallel.mesh.shard_params``; params
    that are already a rank's shard carry their mesh.
    """

    def __init__(
        self,
        config: ExLlamaConfig,
        params: Optional[ModelParams] = None,
        device="cuda",
        mesh=None,
    ):
        self.config = config
        self.device = _require_device(device)
        if params is None:
            from exllama_tpu_torch.formats.loader import load_model_params

            params = load_model_params(config, device=self.device, mesh=mesh)
        elif params.device != self.device:
            params = params.to(self.device)
        if mesh is not None and params.mesh is not mesh:
            # whole params: this rank's shard of them (the loader checks
            # the split of what it loads)
            from exllama_tpu_torch.parallel.mesh import (shard_params,
                                                         validate_tp)

            validate_tp(config, mesh.tp)
            params = shard_params(params, mesh,
                                  fuse=config.tuning.fuse_projections)
        self.mesh = params.mesh
        # turbo prefill keeps int8 images of the weights on the card
        if (config.tuning.matmul_impl == "pallas_a8t"
                and config.tuning.prefill_w8 != "off"
                and self.device.type == "cuda"):
            params = _attach_prefill_w8(
                params, config, 1 if self.mesh is None else self.mesh.tp)
        self.params = params

    def _attend_len(self, upto: int) -> int:
        bucket = self.config.tuning.attn_len_bucket
        if bucket <= 0:
            return self.config.max_seq_len
        return min(self.config.max_seq_len, -(-upto // bucket) * bucket)

    def num_params_bytes(self) -> int:
        """Bytes of the parameters, a 4-bit lm_head's packed words and
        scales included."""
        p = self.params
        tensors = [p.embed, p.norm, p.lm_head, p.rope_sin, p.rope_cos]
        tensors += [getattr(lp, f.name) for lp in p.layers
                    for f in dataclasses.fields(LayerParams)]
        return sum(_quant_bytes(x) if isinstance(x, QuantTensor)
                   else x.numel() * x.element_size()
                   for x in tensors if x is not None)

    def w8_image_bytes(self) -> int:
        """Bytes of the int8 images and column scales of turbo prefill."""
        return sum(_quant_bytes(x, image_only=True)
                   for lp in self.params.layers
                   for x in (getattr(lp, f) for f in _W8_FIELDS)
                   if x is not None)

    @torch.inference_mode()
    def forward(
        self,
        input_ids,                    # [B, T] int (numpy or torch)
        cache: ExLlamaCache,
        last_id_only: bool = True,
        preprocess_only: bool = False,
        input_mask=None,              # [B, S_max] bool, True = valid
        lora=None,                    # lora.ExLlamaLora or None
    ):
        """Chunked forward. Advances ``cache.current_seq_len`` and writes the
        cache in place. Returns f32 logits [B, 1, vocab] / [B, T, vocab], or
        None with ``preprocess_only``."""
        cfg = self.config
        tune = cfg.tuning
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
            logits = forward_chunk(
                self.params, cache, tokens[:, start : start + chunk], past,
                input_mask,
                attend_len=self._attend_len(past + chunk),
                last_token_only=last_id_only,
                preprocess_only=preprocess_only and is_last or not is_last,
                heads=cfg.num_attention_heads,
                kv_heads=cfg.num_key_value_heads,
                head_dim=cfg.head_dim,
                eps=cfg.rms_norm_eps,
                mlp_fuse=tune.fuse_mlp,
                attn_fuse=tune.fuse_attn,
                qkv_fuse=tune.fuse_qkv,
                commit_impl=tune.commit_impl,
                matmul_impl=tune.matmul_impl,
                attn_impl=tune.attn_impl,
                lora=None if lora is None else lora.stacked,
            )
            cache.current_seq_len += chunk
            if is_last:
                result = logits
            start += chunk
            remaining -= chunk
        return result
