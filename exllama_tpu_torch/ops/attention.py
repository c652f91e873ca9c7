"""GQA attention over the preallocated KV cache (port of
exllama_tpu/ops/attention.py, bf16 cache only).

``attend`` launches kernel K3 ``flash_attn`` (csrc/flash_attn.cu) for any
query length on CUDA tensors and counts each launch on ``attend.launches``;
``attend_plain`` is its plain PyTorch version (the port of ``attend_xla``).
Semantics, shared by both:

  * the cache is [B, Hkv, S_max, D]; only ``cache[:, :, :attend_len]`` is read;
  * query t of row b sits at position ``past[b] + t`` and sees key s iff
    ``s <= past + t`` (``past`` an int or a [B] tensor of per-row cursors);
  * ``input_mask`` [B, >= attend_len] bool (True = real token) hides
    left-padding keys; a query row left with no visible key returns 0;
  * ``new_kv`` (T=1 only) is deferred-commit decode: the step's own K/V rows
    are not in the cache yet, so position ``past`` is masked and the rows
    are folded in after the cache; the caller writes them afterwards.

int8/int4 caches belong to a later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from exllama_tpu_torch import kernels

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # attention.py:37


def _past_tensor(past_len, b: int, device) -> torch.Tensor:
    if isinstance(past_len, int):
        return torch.full((b,), past_len, dtype=torch.int32, device=device)
    return past_len.to(device=device, dtype=torch.int32).reshape(-1).expand(b)


def _check_bf16_cache(k_cache: torch.Tensor):
    if k_cache.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"KV cache dtype {k_cache.dtype}: only bf16 is ported"
        )


def update_kv_cache(k_cache, v_cache, new_k, new_v, past_len):
    """Write T new rows [B, T, Hkv, D] at position ``past_len`` (an int or a
    [B] tensor). Updates the caches IN PLACE (the JAX version is functional
    and relies on buffer donation) and returns them."""
    _check_bf16_cache(k_cache)
    t = new_k.shape[1]
    if isinstance(past_len, int):
        k_cache[:, :, past_len : past_len + t] = new_k.transpose(1, 2)
        v_cache[:, :, past_len : past_len + t] = new_v.transpose(1, 2)
    else:
        for i, p in enumerate(past_len.tolist()):
            k_cache[i, :, p : p + t] = new_k[i].transpose(0, 1)
            v_cache[i, :, p : p + t] = new_v[i].transpose(0, 1)
    return k_cache, v_cache


def attend_plain(
    q: torch.Tensor,            # [B, T, H, D]
    k_cache: torch.Tensor,      # [B, Hkv, S_max, D]
    v_cache: torch.Tensor,
    past_len,                   # int or [B]
    attend_len: int,
    input_mask: Optional[torch.Tensor] = None,   # [B, >=attend_len] bool
    new_kv=None,                # ([B,1,Hkv,D], [B,1,Hkv,D]) or None
) -> torch.Tensor:
    """Plain version of K3: full masked softmax in f32, p cast to bf16
    before the PV product, normalized after it."""
    _check_bf16_cache(k_cache)
    b, t, h, d = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    deferred = new_kv is not None
    if deferred and t != 1:
        raise ValueError("deferred-commit attend is a decode-only path")
    past = _past_tensor(past_len, b, q.device).to(torch.long)
    scale = 1.0 / math.sqrt(d)

    k = k_cache[:, :, :attend_len].to(torch.float32)    # [B, Hkv, S, D]
    v = v_cache[:, :, :attend_len]
    qf = q.reshape(b, t, hkv, g, d).to(torch.float32)
    scores = torch.einsum("bthgd,bhsd->bhgts", qf, k) * scale

    s_pos = torch.arange(attend_len, device=q.device)
    t_pos = past[:, None] + torch.arange(t, device=q.device)[None, :]  # [B, T]
    if deferred:
        ok = s_pos[None, None, :] < t_pos[:, :, None]
    else:
        ok = s_pos[None, None, :] <= t_pos[:, :, None]                 # [B, T, S]
    if input_mask is not None:
        ok = ok & input_mask[:, None, :attend_len].to(q.device, torch.bool)
    ok = ok[:, None, None]                                             # [B,1,1,T,S]
    ok = ok.expand(b, hkv, g, t, attend_len)
    if deferred:
        kn = new_kv[0].transpose(1, 2).to(torch.float32)              # [B,Hkv,1,D]
        s_new = torch.einsum("bthgd,bhsd->bhgts", qf, kn) * scale
        scores = torch.cat([scores, s_new], dim=-1)
        ok = torch.cat([ok, torch.ones_like(ok[..., :1])], dim=-1)
        v = torch.cat([v, new_kv[1].transpose(1, 2).to(v.dtype)], dim=2)
    scores = torch.where(ok, scores, MASK_VALUE)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum(
        "bhgts,bhsd->bthgd",
        p.to(torch.bfloat16).to(torch.float32), v.to(torch.float32),
    )
    o = o / l.permute(0, 3, 1, 2, 4)                                   # [B,T,Hkv,G,1]
    return o.reshape(b, t, h, d).to(q.dtype)


def attend(q, k_cache, v_cache, past_len, attend_len: int, input_mask=None,
           new_kv=None):
    """Masked causal GQA attention, [B, T, H, D] in q.dtype: kernel K3 for
    CUDA tensors, :func:`attend_plain` for CPU ones."""
    if q.device.type == "cpu":
        return attend_plain(q, k_cache, v_cache, past_len, attend_len,
                            input_mask, new_kv)
    if q.device.type != "cuda":
        raise RuntimeError(f"attend: unsupported device {q.device}")
    _check_bf16_cache(k_cache)
    b, t, h, d = q.shape
    _, hkv, s_max, dk = k_cache.shape
    if d not in (64, 128) or dk != d:
        raise ValueError(f"flash_attn: head_dim {d} (cache {dk}); takes 64/128")
    if h % hkv or k_cache.shape[0] != b or v_cache.shape != k_cache.shape:
        raise ValueError("flash_attn: q / cache shapes disagree")
    if not 0 < attend_len <= s_max:
        raise ValueError(f"attend_len {attend_len} outside (0, {s_max}]")
    q = q.contiguous()
    if q.data_ptr() % 16:       # the kernel loads rows in 16-byte vectors
        q = q.clone()
    for x in (q, k_cache, v_cache):
        if x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError("flash_attn takes contiguous bf16 q and caches")
        if x.data_ptr() % 16:
            raise ValueError("flash_attn needs 16-byte aligned q and caches")
    past = _past_tensor(past_len, b, q.device).contiguous()
    mask = None
    if input_mask is not None:
        if input_mask.shape[0] != b or input_mask.shape[1] < attend_len:
            raise ValueError("input_mask must be [B, >= attend_len]")
        mask = input_mask.to(device=q.device, dtype=torch.bool).contiguous()
    kn = vn = None
    if new_kv is not None:
        if t != 1:
            raise ValueError("deferred-commit attend is a decode-only path")
        kn = new_kv[0].to(torch.bfloat16).contiguous()
        vn = new_kv[1].to(torch.bfloat16).contiguous()
        if kn.shape != (b, 1, hkv, d) or vn.shape != (b, 1, hkv, d):
            raise ValueError("new_kv rows must be [B, 1, Hkv, D]")
    out = torch.empty_like(q)
    kernels.check(kernels.launcher("flash_attn")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), past.data_ptr(),
        kernels.ptr(mask), kernels.ptr(kn), kernels.ptr(vn), out.data_ptr(),
        b, t, h, hkv, d, s_max, attend_len,
        0 if mask is None else mask.shape[1], 1.0 / math.sqrt(d),
        kernels.stream_of(q),
    ), "flash_attn")
    attend.launches += 1
    return out


attend.launches = 0
