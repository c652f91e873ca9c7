"""Sequence parallelism: a KV cache split over the sequence, and ring
attention for prefill (port of exllama_tpu/parallel/sequence.py).

A rank of the ``sp`` axis holds S / sp positions of every layer's cache
(``shard_cache_sp``: rank r the positions [r S/sp, (r+1) S/sp)), so a
context can outgrow one card's memory:

  * decode (``sp_attend``, distributed flash decoding): each rank attends
    over its own positions without normalising, giving (o, l, m); the
    ranks combine them with one all-reduce MAX of m and two all-reduce
    SUMs (l and o rescaled to the global m);
  * cache writes (``sp_update_kv_cache``): position p lives on rank
    p // (S/sp); the other ranks rewrite their own rows (an owner-masked
    write, the same program on every rank), bf16, int8 and int4 alike;
  * prefill (``ring_attend_prefill``): each rank keeps its block of
    queries while the K / V blocks travel around the ring of ranks
    (``torch.distributed.batch_isend_irecv``); causality comes from the
    blocks' global positions;
  * ``make_sp_decode_fn``: the whole-model decode step over such a cache,
    the weights whole on every rank; its projections go through
    ``q4_matmul`` (K1 at decode).

The attention of ``sp_attend`` / ``ring_attend_prefill`` and the head are
plain tensor code, as the JAX package computes them in plain XLA outside
its kernels (sequence.py:94, :399). The functions take the ``Mesh`` whose
``"sp"`` axis they run over (``make_sp_mesh``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from exllama_tpu_torch.ops import full_f32_matmul
from exllama_tpu_torch.ops.attention import (
    MASK_VALUE,
    _past_tensor,
    kv_ptr_array,
    quantize_kv_rows,
    quantize_kv_rows4,
    unpack_kv4,
)
from exllama_tpu_torch.parallel.mesh import Mesh


def make_sp_mesh(sp: int, tp: int = 1, dp: int = 1) -> Mesh:
    """The ``("dp", "tp", "sp")`` mesh, sp innermost."""
    return Mesh(("dp", "tp", "sp"), (dp, tp, sp))


def _local_stats(q, k, v, valid):
    """Attention over one block of keys, not normalised: (o, l, m) with
    o = sum_s exp(s - m) v. q [B, T, H, D]; k / v [B, Hkv, S, D]; valid
    [B, T, S] bool (causal and mask). f32 scores of q.k times 1/sqrt(D),
    p rounded to v's dtype before PV, f32 accumulation."""
    b, t, h, d = q.shape
    hkv = k.shape[1]
    qf = q.reshape(b, t, hkv, h // hkv, d)
    with full_f32_matmul():
        s = torch.einsum("bthgd,bhsd->bhgts", qf.to(torch.float32),
                         k.to(torch.float32))
    s = s * (1.0 / (d ** 0.5))
    vmask = valid[:, None, None]                         # [B, 1, 1, T, S]
    s = torch.where(vmask, s, MASK_VALUE)
    m = s.amax(dim=-1).clamp_min(-1e30)                  # all-masked guard
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    with full_f32_matmul():
        o = torch.einsum("bhgts,bhsd->bhgtd",
                         p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return o, l, m


def _finish(o, l, m, q_shape, dtype):
    b, t, h, d = q_shape
    l = torch.where(l == 0.0, 1.0, l)
    out = o / l[..., None]                               # [B, Hkv, G, T, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(dtype)


def _dequantized(k, d, k_scale, dtype):
    """A cache block as ``dtype`` values: int4 bytes unpacked, int8 / int4
    values times their per-row scale (none: as stored)."""
    if k.shape[-1] != d:
        k = unpack_kv4(k, torch.float32)
    if k_scale is None:
        return k
    return (k.to(torch.float32) * k_scale[..., None]).to(dtype)


def sp_attend(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
              past_len, mesh: Mesh, k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode / short-T attention over a cache split over the sequence.
    q [B, T, H, D] (whole on every rank); k / v_shard [B, Hkv, S/sp, D(/2)]
    this rank's positions; ``past_len`` an int or a [B] tensor; int8 / int4
    caches pass their [B, Hkv, S/sp] scales. One all-reduce MAX and two
    SUMs over the sp group."""
    b, t, h, d = q.shape
    s_loc = k_shard.shape[2]
    k = _dequantized(k_shard, d, k_scale, q.dtype)
    v = _dequantized(v_shard, d, v_scale, q.dtype)
    dev = q.device
    pos = mesh.sp_rank * s_loc + torch.arange(s_loc, device=dev)
    t_pos = (_past_tensor(past_len, b, dev).to(torch.long)[:, None]
             + torch.arange(t, device=dev)[None, :])             # [B, T]
    valid = pos[None, None, :] <= t_pos[:, :, None]              # [B, T, S]
    o, l, m = _local_stats(q, k, v, valid)
    group = mesh.group("sp")
    if group is not None:
        m_g = m.clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m - m_g)
        l = l * corr
        o = o * corr[..., None]
        dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(o, op=dist.ReduceOp.SUM, group=group)
        m = m_g
    return _finish(o, l, m, q.shape, q.dtype)


def sp_update_kv_cache(k_shard, v_shard, new_k, new_v, past_len, mesh: Mesh,
                       k_scale=None, v_scale=None):
    """Owner-masked write of new_k / new_v [B, T, Hkv, D] at the scalar
    cursor ``past_len`` (an int or a one-element tensor, read on the
    device), in place: position past_len + i goes to rank (past_len + i) //
    (S/sp) at row (past_len + i) % (S/sp); the other ranks write their rows
    back as they were. int8 / int4 caches quantize the new rows per (token,
    head) and write the scales the same way. Returns (k, v) or (k, v,
    k_scale, v_scale), the same tensors."""
    b, t, hkv, d = new_k.shape
    s_loc = k_shard.shape[2]
    quantized = k_scale is not None
    if quantized:
        quant = (quantize_kv_rows4 if k_shard.shape[-1] != d
                 else quantize_kv_rows)
        qk, sk = quant(new_k)          # [B, T, Hkv, D(/2)], [B, T, Hkv]
        qv, sv = quant(new_v)
        parts = [(k_shard, qk), (v_shard, qv), (k_scale, sk), (v_scale, sv)]
    else:
        parts = [(k_shard, new_k), (v_shard, new_v)]
    dev = k_shard.device
    past = (torch.tensor(past_len, device=dev) if isinstance(past_len, int)
            else past_len.to(dev).reshape(()))
    p = past.to(torch.long) + torch.arange(t, device=dev)
    own = (p // s_loc) == mesh.sp_rank
    loc = p % s_loc
    for cache, rows in parts:
        rows = rows.transpose(1, 2).to(cache.dtype)      # [B, Hkv, T, ...]
        keep = own.reshape((1, 1, t) + (1,) * (rows.dim() - 3))
        cache[:, :, loc] = torch.where(keep, rows, cache[:, :, loc])
    if quantized:
        return k_shard, v_shard, k_scale, v_scale
    return k_shard, v_shard


def _ring_pass(tensors, nxt: int, prv: int, group):
    """Send each tensor to rank ``nxt`` and take its twin from ``prv``
    (global ranks), all in one batch of point-to-point operations."""
    got = [torch.empty_like(x) for x in tensors]
    ops = []
    for x, y in zip(tensors, got):
        ops.append(dist.P2POp(dist.isend, x, nxt, group))
        ops.append(dist.P2POp(dist.irecv, y, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def ring_attend_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh: Mesh) -> torch.Tensor:
    """Causal ring attention: q [B, T/sp, H, D], k / v [B, T/sp, Hkv, D]
    this rank's block of positions (rank i: [i T/sp, (i+1) T/sp)). The
    query block stays; after sp - 1 passes around the ring every rank has
    combined every K / V block (online softmax), masked by the blocks'
    global positions."""
    b, t_loc, h, d = q.shape
    hkv = k.shape[2]
    n, idx = mesh.sp, mesh.sp_rank
    ranks = mesh.ranks("sp")
    group = mesh.group("sp")
    dev = q.device
    kb = k.transpose(1, 2).contiguous()                  # [B, Hkv, T_loc, D]
    vb = v.transpose(1, 2).contiguous()
    q_pos = idx * t_loc + torch.arange(t_loc, device=dev)
    shape = (b, hkv, h // hkv, t_loc)
    o = torch.zeros(shape + (d,), dtype=torch.float32, device=dev)
    l = torch.zeros(shape, dtype=torch.float32, device=dev)
    m = torch.full(shape, -1e30, dtype=torch.float32, device=dev)
    for r in range(n):
        src = (idx - r) % n                  # whose block this rank holds
        kv_pos = src * t_loc + torch.arange(t_loc, device=dev)
        valid = (kv_pos[None, None, :] <= q_pos[None, :, None]).expand(
            b, t_loc, t_loc)
        o_r, l_r, m_r = _local_stats(q, kb, vb, valid)
        m_new = torch.maximum(m, m_r)
        c_old = torch.exp(m - m_new)
        c_r = torch.exp(m_r - m_new)
        o = o * c_old[..., None] + o_r * c_r[..., None]
        l = l * c_old + l_r * c_r
        m = m_new
        if r < n - 1:
            kb, vb = _ring_pass([kb, vb], ranks[(idx + 1) % n],
                                ranks[(idx - 1) % n], group)
    return _finish(o, l, m, q.shape, q.dtype)


# ---------------------------------------------------------------------------
# The whole-model decode step over a sequence-split cache
# ---------------------------------------------------------------------------

def shard_cache_sp(cache, mesh: Mesh):
    """Keep this rank's S/sp positions of every tensor of ``cache`` (an
    ``ExLlamaCache``; int8 / int4 scales too), in place; the cursor
    ``current_seq_len`` stays global."""
    s = cache.k[0].shape[2]
    if s % mesh.sp:
        raise ValueError(f"{s} positions do not split over sp {mesh.sp}")
    per = s // mesh.sp
    lo = mesh.sp_rank * per
    for ts in cache._tensor_lists():
        ts[:] = [t[:, :, lo:lo + per].contiguous() for t in ts]
    cache.shape = cache.shape[:2] + (per,) + cache.shape[3:]
    cache.kv_ptrs = kv_ptr_array(cache.k, cache.v, cache.k_scale,
                                 cache.v_scale)
    return cache


def make_sp_decode_fn(model, mesh: Mesh):
    """The decode step of ``model`` (weights whole on every rank) over a
    cache split over ``mesh``'s sp axis (``shard_cache_sp``):
    ``fn(params, cache, tokens [B, T], past: int) -> (f32 logits [B, 1, V],
    cache)``, the cache written in place. Per layer: norm, the q / k / v (or
    fused qkv) projection, rope, the owner-masked write, ``sp_attend``, o,
    the MLP; then the final norm and the head on the last position."""
    from exllama_tpu_torch.formats.gptq import QuantTensor
    from exllama_tpu_torch.ops.mlp import silu_mul
    from exllama_tpu_torch.ops.norms import rms_norm
    from exllama_tpu_torch.ops.quant import q4_matmul
    from exllama_tpu_torch.ops.rope import apply_rope_sliced, slice_tables

    cfg = model.config
    heads, kv_heads, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                          cfg.head_dim)
    eps = cfg.rms_norm_eps
    impl = cfg.tuning.matmul_impl
    nq, nkv = heads * d, kv_heads * d

    @torch.inference_mode()
    def fn(params, cache, tokens, past: int):
        tokens = torch.as_tensor(tokens, dtype=torch.int32).to(params.device)
        b, t = tokens.shape
        h = params.embed[tokens.to(torch.long)]
        sin_t, cos_t = slice_tables(params.rope_sin, params.rope_cos, past,
                                    t)
        quantized = cache.k_scale is not None
        for li, lp in enumerate(params.layers):
            a = rms_norm(h, lp.input_norm, eps)
            if lp.qkv is not None:
                fused = q4_matmul(a, lp.qkv, impl)
                q, k, v = (fused[..., :nq], fused[..., nq:nq + nkv],
                           fused[..., nq + nkv:])
            else:
                q, k, v = (q4_matmul(a, lp.q, impl), q4_matmul(a, lp.k, impl),
                           q4_matmul(a, lp.v, impl))
            q = apply_rope_sliced(q.reshape(b, t, heads, d), sin_t, cos_t)
            k = apply_rope_sliced(k.reshape(b, t, kv_heads, d), sin_t, cos_t)
            v = v.reshape(b, t, kv_heads, d)
            ks = cache.k_scale[li] if quantized else None
            vs = cache.v_scale[li] if quantized else None
            sp_update_kv_cache(cache.k[li], cache.v[li], k, v, past, mesh,
                               ks, vs)
            attn = sp_attend(q, cache.k[li], cache.v[li], past, mesh, ks, vs)
            h = h + q4_matmul(attn.reshape(b, t, nq), lp.o, impl)
            a = rms_norm(h, lp.post_norm, eps)
            if lp.gateup is not None:
                ni = lp.down.in_features
                fused = q4_matmul(a, lp.gateup, impl)
                g, u = fused[..., :ni], fused[..., ni:]
            else:
                g, u = q4_matmul(a, lp.gate, impl), q4_matmul(a, lp.up, impl)
            h = h + q4_matmul(silu_mul(g, u), lp.down, impl)
        h2 = rms_norm(h[:, -1:, :], params.norm, eps)
        if isinstance(params.lm_head, QuantTensor):
            logits = q4_matmul(h2, params.lm_head, impl).to(torch.float32)
        else:
            with full_f32_matmul():
                logits = (h2.to(torch.float32)
                          @ params.lm_head.to(torch.float32))
        return logits, cache

    return fn
