"""GQA attention over the preallocated KV cache (port of
exllama_tpu/ops/attention.py, bf16 cache only).

``attend`` launches kernel K3 ``flash_attn`` (csrc/flash_attn.cu) for any
query length on CUDA tensors and counts each launch on ``attend.launches``;
``attend_plain`` is its plain PyTorch version (the port of ``attend_xla``).
Semantics, shared by both:

  * the cache is [B, Hkv, S_max, D]; only ``cache[:, :, :attend_len]`` is read;
  * query t of row b sits at position ``past[b] + t`` and sees key s iff
    ``s <= past + t`` (``past`` an int or a [B] tensor of per-row cursors);
  * ``input_mask`` [B, >= attend_len] bool (True = real token) adds the
    finite bias ``NEG_INF`` to the scores of left-padding keys after the
    causal mask, as the JAX flash kernel does, so a query row whose visible
    keys are all padding averages V over them;
  * ``new_kv`` (T=1 only) is deferred-commit decode: the step's own K/V rows
    are not in the cache yet, so position ``past`` is masked and the rows
    are folded in after the cache; the caller writes them afterwards.

``commit_kv_cache`` writes the deferred K/V rows of a decode step into
every layer's cache: one launch of kernel K8 ``kv_commit``
(csrc/kv_commit.cu, counted on ``kv_commit.launches``) under
``impl="pallas"``, one plain write per layer otherwise.

int8/int4 caches belong to a later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from exllama_tpu_torch import kernels
from exllama_tpu_torch.config import COMMIT_IMPLS

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # attention.py:37
NEG_INF = -1e9      # additive left-pad bias (attention.py:36)


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
    ok = ok[:, None, None].expand(b, hkv, g, t, attend_len)            # [B,Hkv,G,T,S]
    scores = torch.where(ok, scores, MASK_VALUE)
    if input_mask is not None:
        # the pad bias is added after the causal mask, as the JAX flash
        # kernel does: a row whose visible keys are all padding averages V
        # over them (every score rounds to NEG_INF)
        pad = ~input_mask[:, :attend_len].to(q.device, torch.bool)
        scores = scores + torch.where(pad, NEG_INF, 0.0)[:, None, None, None]
    if deferred:
        kn = new_kv[0].transpose(1, 2).to(torch.float32)              # [B,Hkv,1,D]
        s_new = torch.einsum("bthgd,bhsd->bhgts", qf, kn) * scale
        scores = torch.cat([scores, s_new], dim=-1)
        ok = torch.cat([ok, torch.ones_like(ok[..., :1])], dim=-1)
        v = torch.cat([v, new_kv[1].transpose(1, 2).to(v.dtype)], dim=2)
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


# ------------------------------------------------- deferred batched commit

def kv_ptr_array(k_caches, v_caches) -> torch.Tensor:
    """K8's operand: an int64 array, on the caches' device, of the 2L cache
    base pointers (K layers, then V), after checking that the caches are
    contiguous 16-byte aligned bf16 tensors of one shape. The caches are
    updated in place and never move, so ``ExLlamaCache`` builds this once
    (``kv_ptrs``)."""
    shape, dev = k_caches[0].shape, k_caches[0].device
    if len(k_caches) != len(v_caches):
        raise ValueError("kv_commit: as many K as V caches")
    for t in (*k_caches, *v_caches):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != dev or t.shape != shape or t.data_ptr() % 16):
            raise ValueError("kv_commit: contiguous 16-byte aligned bf16 "
                             "caches of one shape on one device")
    return torch.tensor([t.data_ptr() for t in (*k_caches, *v_caches)],
                        dtype=torch.int64).to(dev)


def kv_commit(k_caches, v_caches, new_k, new_v, past_len: int, ptrs=None):
    """K8: every layer's rows new_k / new_v [L, B, 1, Hkv, D] written into
    k_caches[l] / v_caches[l] [B, Hkv, S, D] at the shared cursor
    ``past_len``, in place, in one launch (the plain per-layer writes for
    CPU caches). ``ptrs`` is :func:`kv_ptr_array` of these caches, built
    here when not given."""
    _check_bf16_cache(k_caches[0])
    if k_caches[0].device.type == "cpu":
        for li in range(len(k_caches)):
            update_kv_cache(k_caches[li], v_caches[li], new_k[li], new_v[li],
                            past_len)
        return
    if k_caches[0].device.type != "cuda":
        raise RuntimeError(f"kv_commit: unsupported device "
                           f"{k_caches[0].device}")
    n_layers = len(k_caches)
    b, hkv, s_max, d = k_caches[0].shape
    new_k = new_k.to(torch.bfloat16).contiguous()
    new_v = new_v.to(torch.bfloat16).contiguous()
    if new_k.shape != (n_layers, b, 1, hkv, d) or new_v.shape != new_k.shape:
        raise ValueError(f"kv_commit: rows {tuple(new_k.shape)} vs caches "
                         f"{n_layers} x {tuple(k_caches[0].shape)}")
    if d % 8 or not 0 <= past_len < s_max:
        raise ValueError(f"kv_commit: head_dim {d}, cursor {past_len}")
    if ptrs is None:
        ptrs = kv_ptr_array(k_caches, v_caches)
    if ptrs.shape != (2 * n_layers,) or ptrs.dtype != torch.int64:
        raise ValueError("kv_commit: ptrs must be kv_ptr_array(caches)")
    for t in (new_k, new_v):
        if t.device != ptrs.device or t.data_ptr() % 16:
            raise ValueError("kv_commit: rows must be 16-byte aligned, on "
                             "the caches' device")
    kernels.check(kernels.launcher("kv_commit")(
        ptrs.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), n_layers, b,
        hkv, s_max, d, past_len, kernels.stream_of(new_k),
    ), "kv_commit")
    kv_commit.launches += 1


kv_commit.launches = 0


def commit_kv_cache(k_caches, v_caches, new_k, new_v, past_len,
                    impl: str = "auto", ptrs=None):
    """Deferred commit of a decode step (port of attention.py:284): the
    rows new_k[l] / new_v[l] ([B, 1, Hkv, D]; a stacked [L, ...] tensor or a
    list) go into every layer's cache at ``past_len``, in place.

    ``impl="pallas"`` with an int cursor takes :func:`kv_commit`, K8 (the
    JAX value name, kept so call sites port unchanged), with the caches'
    pointer array ``ptrs`` (``ExLlamaCache.kv_ptrs``); ``"xla"`` and
    ``"auto"`` -- which resolves to the plain writes, as in the JAX
    package -- write one layer at a time with :func:`update_kv_cache`, as
    does a per-row cursor under any impl (attention.py:309-319)."""
    if impl not in COMMIT_IMPLS:
        raise ValueError(f"commit_impl {impl!r}")
    if impl == "pallas" and isinstance(past_len, int):
        if not torch.is_tensor(new_k):
            new_k, new_v = torch.stack(list(new_k)), torch.stack(list(new_v))
        kv_commit(k_caches, v_caches, new_k, new_v, past_len, ptrs)
        return k_caches, v_caches
    for li in range(len(k_caches)):
        update_kv_cache(k_caches[li], v_caches[li], new_k[li], new_v[li],
                        past_len)
    return k_caches, v_caches
