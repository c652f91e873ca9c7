"""GQA attention over the preallocated KV cache (port of
exllama_tpu/ops/attention.py): a bf16 cache, or a quantized one -- int8, or
int4 packed two values a byte -- with one f32 scale per (token, kv head).

``attend`` launches kernel K3 ``flash_attn`` (csrc/flash_attn.cu) for any
query length on CUDA tensors and counts each launch (``attend.launches``
for a bf16 cache, ``attend.launches_int8`` / ``attend.launches_int4`` for a
quantized one; the launches of its prefill path, csrc/flash_prefill_wg.cuh,
once more on ``attend.launches_prefill`` / ``_prefill_int8`` /
``_prefill_int4``); ``attend_plain`` is its plain PyTorch version. Head dims
K3 does not take (``flash_supported_head_dim``) go, as in the JAX package,
to the einsum attention ``attend_xla`` (plain tensor code on every device,
its own counter); ``resolve_attn_impl`` picks the route for
``TuningParams.attn_impl``. K3 has two
paths, picked by shape (``decode_rows``): split-KV decode, whose key splits
``split_plan`` sizes and whose arithmetic ``attend_split_plain`` writes out
in plain tensor code, and the prefill tiles on Hopper's wgmma, whose blocks
``prefill_plan`` lists and whose arithmetic ``attend_prefill_tiles_plain``
writes out. Semantics, shared by all:

  * the cache is [B, Hkv, S_max, D]; only ``cache[:, :, :attend_len]`` is read;
  * query t of row b sits at position ``past[b] + t`` and sees key s iff
    ``s <= past + t`` (``past`` an int or a [B] tensor of per-row cursors);
  * ``input_mask`` [B, >= attend_len] bool (True = real token) adds the
    finite bias ``NEG_INF`` to the scores of left-padding keys after the
    causal mask, as the JAX flash kernel does, so a query row whose visible
    keys are all padding averages V over them;
  * ``new_kv`` (T=1 only) is deferred-commit decode: the step's own K/V rows
    are not in the cache yet, so position ``past`` is masked and the rows
    are folded in after the cache, in bf16; the caller writes them
    afterwards;
  * with ``k_scale`` / ``v_scale`` [B, Hkv, S_max] f32 the cache holds
    integers (int8 [.., D], or int4 bytes [.., D/2], told apart by the last
    dim): the scores are (q . k_int) * k_scale * 1/sqrt(D), in that order,
    and the V scale multiplies p before p is rounded to bf16 for the PV
    product, while the softmax denominator sums the unscaled p -- the
    arithmetic of the JAX flash kernels (attention.py:544-586), not of
    ``attend_xla``, which dequantizes K and V to bf16 first.

Rows are quantized where they are written: ``update_kv_cache`` (prefill:
the chunk is written, then attended from the cache, so its queries see
their own keys quantized) and ``commit_kv_cache`` (decode: the query
attended to its own row in bf16; the next step sees it quantized).
``commit_kv_cache`` writes the deferred K/V rows of a decode step into
every layer's cache: one launch of kernel K8 ``kv_commit``
(csrc/kv_commit.cu, which quantizes in the kernel and reads its cursor, [1]
or [B], from device memory; counted on ``kv_commit.launches`` /
``launches_int8`` / ``launches_int4``) under ``impl="pallas"``, one plain
write per layer otherwise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from exllama_tpu_torch import kernels
from exllama_tpu_torch.config import ATTN_IMPLS, COMMIT_IMPLS
from exllama_tpu_torch.ops import full_f32_matmul

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # attention.py:37
NEG_INF = -1e9      # additive left-pad bias (attention.py:36)
# a kernel's kv_mode argument, and the suffix of its launch counter
KV_MODES = ("bf16", "int8", "int4")


def _past_tensor(past_len, b: int, device) -> torch.Tensor:
    if isinstance(past_len, int):
        return torch.full((b,), past_len, dtype=torch.int32, device=device)
    return past_len.to(device=device, dtype=torch.int32).reshape(-1).expand(b)


def kv_mode(k_cache: torch.Tensor, d: int, k_scale) -> int:
    """Index into ``KV_MODES`` of a cache that holds rows of head width
    ``d``: bf16 without scales; with scales int8 ([.., d]) or packed int4
    ([.., d / 2])."""
    if k_scale is None:
        if k_cache.dtype != torch.bfloat16 or k_cache.shape[-1] != d:
            raise ValueError(f"a {k_cache.dtype} [.., {k_cache.shape[-1]}] "
                             f"KV cache without scales (head width {d})")
        return 0
    if k_cache.dtype != torch.int8 or k_scale.dtype != torch.float32:
        raise ValueError("a KV cache with scales is int8 with f32 scales")
    if k_scale.shape != k_cache.shape[:3]:
        raise ValueError("KV scales must be [B, Hkv, S_max]")
    if k_cache.shape[-1] == d:
        return 1
    if 2 * k_cache.shape[-1] == d:
        return 2
    raise ValueError(f"int8 KV cache [.., {k_cache.shape[-1]}] for head "
                     f"width {d}")


def count_launch(fn, mode: int, f32: bool = False):
    """One more launch on ``fn``'s counter for this cache format; a build
    over f32 weight scales counts on ``launches_f32`` whatever the format."""
    attr = ("launches_f32" if f32 else
            "launches" if mode == 0 else f"launches_{KV_MODES[mode]}")
    setattr(fn, attr, getattr(fn, attr) + 1)


def init_launch_counters(fn, f32: bool = False):
    fn.launches = fn.launches_int8 = fn.launches_int4 = 0
    if f32:
        fn.launches_f32 = 0


# ------------------------------------------------------- row quantization

def _true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a correctly rounded f32 division on every device: on CUDA
    tensors PyTorch turns division by a Python scalar into a multiplication
    by its reciprocal, which differs in the last bit for c = 127 or 7."""
    return x / torch.full_like(x, c)


def quantize_kv_rows(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of [..., D] rows
    (attention.py:58): (int8 values, f32 scales [...]), scale = max(amax,
    1e-8) / 127, q = clip(round(x / scale), +-127); a true f32 division and
    round half to even, so the bytes and scales are the JAX function's."""
    xf = x.to(torch.float32)
    scale = _true_div(xf.abs().amax(dim=-1).clamp_min(1e-8), 127.0)
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def quantize_kv_rows4(x: torch.Tensor):
    """Per-(token, head) symmetric int4 quantization of [..., D] rows, two
    values a byte along D (attention.py:71): (int8 [..., D/2], f32 scales).
    q in [-7, 7], scale = max(amax, 1e-8) / 7. Byte d pairs dims (d, d +
    D/2): low nibble q_lo + 8, high nibble (q_hi + 8) ^ 8, so the signed
    byte is 16 * q_hi + q_lo + 8."""
    xf = x.to(torch.float32)
    scale = _true_div(xf.abs().amax(dim=-1).clamp_min(1e-8), 7.0)
    q = torch.round(xf / scale[..., None]).clamp_(-7, 7).to(torch.int32) + 8
    d = x.shape[-1]
    byte = q[..., : d // 2] | ((q[..., d // 2:] ^ 8) << 4)       # 0..255
    byte = torch.where(byte >= 128, byte - 256, byte)
    return byte.to(torch.int8), scale


def unpack_kv4(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[..., D/2] int4-packed bytes -> [..., D] raw values in [-8, 7], the
    scale not applied (attention.py:97)."""
    lo = (packed & 0x0F).to(dtype) - 8.0
    hi = (packed & -16).to(dtype) * 0.0625
    return torch.cat([lo, hi], dim=-1)


def _write_at(cache, new, past_len, valid=None):
    """new [B, T, Hkv, ...] into cache [B, Hkv, S, ...] at ``past_len``, in
    place. An int cursor is one slice write, and one outside the cache
    raises. A [1] / [B] tensor cursor is one indexed write that reads it on
    the device (no host sync); a row whose T positions do not lie in
    [0, S) is left as it was, as K8 (``kv_commit``) leaves it. ``valid``
    (a [1] int tensor, read on the device): only the first ``valid`` of
    the T positions are written, the others left as they were (a padded
    chunk's pad rows).

    A stated deviation from the JAX package: its ``update_kv_cache``
    (attention.py:106-122) writes through a vmapped
    ``jax.lax.dynamic_update_slice``, which clamps the start into
    [0, S - T] after counting a negative one from the end, so a row at
    cursor S lands at S - 1 and one at -1 at S - 1 too, over a valid row. The port skips such a row instead; rows inside the
    cache are written identically (tests/test_torch_knobs.py pins both)."""
    b, t, hkv = new.shape[:3]
    new = new.transpose(1, 2)
    dev = cache.device
    if isinstance(past_len, int):
        if valid is None:
            cache[:, :, past_len : past_len + t] = new
            return
        past_len = torch.full((1,), past_len, dtype=torch.long, device=dev)
    p = past_len.to(device=dev, dtype=torch.long).reshape(-1, 1, 1)
    inside = (p >= 0) & (p + t <= cache.shape[2])             # [1|B, 1, 1]
    pos = torch.where(inside, p, 0) + torch.arange(t, device=dev)
    rows = torch.arange(b, device=dev).reshape(b, 1, 1)
    heads = torch.arange(hkv, device=dev).reshape(1, hkv, 1)
    if valid is not None:                                     # [1|B, 1, T]
        inside = inside & (torch.arange(t, device=dev)
                           < valid.to(dev).reshape(-1, 1, 1))
    keep = inside.reshape(*inside.shape, *[1] * (new.dim() - 3))
    cache[rows, heads, pos] = torch.where(keep, new, cache[rows, heads, pos])


def update_kv_cache(k_cache, v_cache, new_k, new_v, past_len, k_scale=None,
                    v_scale=None, valid=None):
    """Write T new rows [B, T, Hkv, D] at position ``past_len`` (an int or a
    [1] / [B] tensor: ``_write_at``), with ``valid`` the first ``valid``
    of them only. For a quantized cache (``k_scale`` / ``v_scale`` given; int4
    where the cache is narrower than the rows) the rows are quantized per
    (token, head) and the scales written alongside. Updates the tensors IN
    PLACE (the JAX version is functional and relies on buffer donation) and
    returns (k_cache, v_cache, k_scale, v_scale)."""
    if k_scale is not None:
        mode = kv_mode(k_cache, new_k.shape[-1], k_scale)
        quant = quantize_kv_rows4 if mode == 2 else quantize_kv_rows
        for cache, scale, new in ((k_cache, k_scale, new_k),
                                  (v_cache, v_scale, new_v)):
            q, s = quant(new)
            _write_at(cache, q, past_len, valid)
            _write_at(scale, s, past_len, valid)
        return k_cache, v_cache, k_scale, v_scale
    kv_mode(k_cache, new_k.shape[-1], None)
    _write_at(k_cache, new_k, past_len, valid)
    _write_at(v_cache, new_v, past_len, valid)
    return k_cache, v_cache, None, None


def _masked_scores(q, k_cache, v_cache, past_len, attend_len, input_mask,
                   deferred, k_scale, v_scale):
    """K3's scores in f32 [B, Hkv, G, T, S] -- the K scale then 1/sqrt(D),
    ``MASK_VALUE`` where causally masked, the pad bias added after that --
    with the mask ``ok``, q [B, T, Hkv, G, D] and the raw V [B, Hkv, S, D]
    in f32, and the V scales [B, Hkv, 1, 1, S] (None over bf16)."""
    b, t, h, d = q.shape
    mode = kv_mode(k_cache, d, k_scale)
    hkv = k_cache.shape[1]
    g = h // hkv
    past = _past_tensor(past_len, b, q.device).to(torch.long)
    k = k_cache[:, :, :attend_len]
    v = v_cache[:, :, :attend_len]
    if mode == 2:
        k, v = unpack_kv4(k, torch.float32), unpack_kv4(v, torch.float32)
    qf = q.reshape(b, t, hkv, g, d).to(torch.float32)
    scores = torch.einsum("bthgd,bhsd->bhgts", qf, k.to(torch.float32))
    if mode:
        scores = scores * k_scale[:, :, None, None, :attend_len]
    scores = scores * (1.0 / math.sqrt(d))

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
    vs = v_scale[:, :, None, None, :attend_len] if mode else None
    return scores, ok, qf, v.to(torch.float32), vs


def _in_flight(qf, new_kv, d):
    """The deferred step's own row: its scores [B, Hkv, G, T, 1] (no pad
    bias, no scale) and its bf16 V row [B, Hkv, 1, D] in f32."""
    kn = new_kv[0].transpose(1, 2).to(torch.float32)                   # [B,Hkv,1,D]
    s_new = torch.einsum("bthgd,bhsd->bhgts", qf, kn) * (1.0 / math.sqrt(d))
    return s_new, new_kv[1].transpose(1, 2).to(torch.float32)


def attend_plain(
    q: torch.Tensor,            # [B, T, H, D]
    k_cache: torch.Tensor,      # [B, Hkv, S_max, D] (int4: D/2)
    v_cache: torch.Tensor,
    past_len,                   # int or [B]
    attend_len: int,
    input_mask: Optional[torch.Tensor] = None,   # [B, >=attend_len] bool
    new_kv=None,                # ([B,1,Hkv,D], [B,1,Hkv,D]) or None
    k_scale: Optional[torch.Tensor] = None,      # [B, Hkv, S_max] f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of K3: full masked softmax in f32, p cast to bf16
    before the PV product, normalized after it; a quantized cache enters as
    its raw integers, the K scale on the scores, the V scale on p."""
    b, t, h, d = q.shape
    deferred = new_kv is not None
    if deferred and t != 1:
        raise ValueError("deferred-commit attend is a decode-only path")
    scores, ok, qf, v, vs = _masked_scores(
        q, k_cache, v_cache, past_len, attend_len, input_mask, deferred,
        k_scale, v_scale)
    if deferred:
        s_new, v_new = _in_flight(qf, new_kv, d)
        scores = torch.cat([scores, s_new], dim=-1)
        ok = torch.cat([ok, torch.ones_like(ok[..., :1])], dim=-1)
        # the in-flight row stays bf16: no scale on its p
        v = torch.cat([v, v_new], dim=2)
        if vs is not None:
            vs = torch.cat([vs, torch.ones_like(vs[..., :1])], dim=-1)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    if vs is not None:
        p = p * vs
    o = torch.einsum("bhgts,bhsd->bthgd", p.to(torch.bfloat16).to(torch.float32),
                     v)
    o = o / l.permute(0, 3, 1, 2, 4)                                   # [B,T,Hkv,G,1]
    return o.reshape(b, t, h, d).to(q.dtype)


def attend_split_plain(q, k_cache, v_cache, past_len, attend_len: int,
                       input_mask=None, new_kv=None, k_scale=None,
                       v_scale=None, *, nsplit: int, chunk: int,
                       p_dtype=torch.bfloat16, out_dtype=None):
    """K3's decode path in plain tensor code: the keys [0, attend_len) in
    ``nsplit`` splits of ``chunk``; per split an (m, l, acc) partial -- m
    the split's max score (``MASK_VALUE`` where it sees no key), l the sum
    of the unscaled p = exp(score - m), acc the sum of p (V scale folded
    in, rounded to ``p_dtype``) times V -- then the combine: the partials
    rescaled to their common max, the in-flight row of a deferred step
    folded in (in f32), l == 0 -> 1. ``p_dtype=torch.float32`` is the exact
    decomposition of the full softmax; the output is in ``out_dtype``
    (default q.dtype)."""
    b, t, h, d = q.shape
    deferred = new_kv is not None
    if nsplit * chunk < attend_len or (nsplit - 1) * chunk >= attend_len:
        raise ValueError(f"{nsplit} splits of {chunk} for {attend_len} keys")
    scores, ok, qf, v, vs = _masked_scores(
        q, k_cache, v_cache, past_len, attend_len, input_mask, deferred,
        k_scale, v_scale)
    ms, ls, accs = [], [], []
    for i in range(nsplit):
        sl = slice(i * chunk, min((i + 1) * chunk, attend_len))
        m = scores[..., sl].amax(dim=-1, keepdim=True)
        p = torch.where(ok[..., sl], torch.exp(scores[..., sl] - m), 0.0)
        ls.append(p.sum(dim=-1, keepdim=True))
        if vs is not None:
            p = p * vs[..., sl]
        accs.append(torch.einsum("bhgts,bhsd->bhgtd",
                                 p.to(p_dtype).to(torch.float32), v[:, :, sl]))
        ms.append(m)
    m = torch.stack(ms).amax(dim=0)
    f = [torch.exp(mi - m) for mi in ms]
    l = sum(fi * li for fi, li in zip(f, ls))
    acc = sum(fi * ai for fi, ai in zip(f, accs))                      # [B,Hkv,G,T,D]
    if deferred:
        s_new, v_new = _in_flight(qf, new_kv, d)
        m_fin = torch.maximum(m, s_new)
        alpha, p_new = torch.exp(m - m_fin), torch.exp(s_new - m_fin)
        l = alpha * l + p_new
        acc = alpha * acc + p_new * v_new[:, :, None]
    l = torch.where(l == 0.0, 1.0, l)
    o = (acc / l).permute(0, 3, 1, 2, 4)                               # [B,T,Hkv,G,D]
    return o.reshape(b, t, h, d).to(out_dtype or q.dtype)


# ----------------------------------------------------- the einsum route

def flash_supported_head_dim(d: int) -> bool:
    """Head widths that take kernel K3: the JAX predicate
    (exllama_tpu/ops/attention.py:flash_supported_head_dim: 64 or a multiple
    of 128) within the widths K3 is built for, 64, 128 and 256."""
    return d in (64, 128, 256)


def resolve_attn_impl(impl: str, d: int) -> str:
    """The attention route, "flash" (K3) or "xla" (:func:`attend_xla`), for
    ``impl`` at head width ``d``: "auto" is "flash" where
    :func:`flash_supported_head_dim` holds; "flash" at another width
    raises."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {impl!r} not in {ATTN_IMPLS}")
    if impl == "auto":
        return "flash" if flash_supported_head_dim(d) else "xla"
    if impl == "flash" and not flash_supported_head_dim(d):
        raise ValueError(f"attn_impl 'flash': kernel K3 does not take head "
                         f"dim {d} (64, 128, 256)")
    return impl


def attend_xla(q, k_cache, v_cache, past_len, attend_len: int,
               input_mask=None, new_kv=None, k_scale=None, v_scale=None):
    """The einsum attention the JAX package runs outside its flash kernel
    (exllama_tpu/ops/attention.py:attend_xla), plain tensor code on every
    device: a quantized cache dequantized to q.dtype first, f32 scores
    times 1/sqrt(D), ``NEG_INF`` where causally masked or padding, the
    in-flight row of a deferred step appended, softmax in f32 rounded to
    q.dtype, then PV. The route ``attn_impl`` takes for a head dim K3 does
    not (``resolve_attn_impl``); its calls on CUDA tensors count on
    ``attend_xla.launches`` (and ``_int8`` / ``_int4``), so a run can show
    which route it took."""
    b, t, h, d = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    deferred = new_kv is not None
    if deferred and t != 1:
        raise ValueError("deferred-commit attend is a decode-only path")
    mode = kv_mode(k_cache, d, k_scale)
    k = k_cache[:, :, :attend_len]
    v = v_cache[:, :, :attend_len]
    if mode == 2:
        k, v = unpack_kv4(k, torch.float32), unpack_kv4(v, torch.float32)
    if mode:
        k = (k.to(torch.float32) * k_scale[:, :, :attend_len, None]).to(q.dtype)
        v = (v.to(torch.float32) * v_scale[:, :, :attend_len, None]).to(q.dtype)
    qf = q.reshape(b, t, hkv, g, d).to(torch.float32)
    scale = 1.0 / (d ** 0.5)
    with full_f32_matmul():
        scores = torch.einsum("bthgd,bhsd->bhgts", qf, k.to(torch.float32))
    scores = scores * scale
    past = _past_tensor(past_len, b, q.device).to(torch.long)
    s_pos = torch.arange(attend_len, device=q.device)
    t_pos = past[:, None] + torch.arange(t, device=q.device)[None, :]
    if deferred:
        ok = s_pos[None, None, :] < t_pos[:, :, None]
    else:
        ok = s_pos[None, None, :] <= t_pos[:, :, None]                 # [B, T, S]
    ok = ok[:, None, None]                                             # [B,1,1,T,S]
    if input_mask is not None:
        valid = input_mask[:, :attend_len].to(q.device, torch.bool)
        ok = ok & valid[:, None, None, None, :]
    scores = torch.where(ok, scores, NEG_INF)
    v = v.to(torch.float32)
    if deferred:
        kn = new_kv[0].transpose(1, 2).to(q.dtype).to(torch.float32)
        vn = new_kv[1].transpose(1, 2).to(q.dtype).to(torch.float32)
        with full_f32_matmul():
            s_new = torch.einsum("bthgd,bhsd->bhgts", qf, kn) * scale
        scores = torch.cat([scores, s_new], dim=-1)
        v = torch.cat([v, vn], dim=2)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).to(torch.float32)
    with full_f32_matmul():
        out = torch.einsum("bhgts,bhsd->bthgd", probs, v)
    if q.device.type == "cuda":
        count_launch(attend_xla, mode)
    return out.reshape(b, t, h, d).to(q.dtype)


init_launch_counters(attend_xla)


# ------------------------------------------------------------- K3's paths

KEY_TILE = 64            # keys per staged tile of K3; a split is a multiple
DECODE_MAX_ROWS = 16     # query rows per kv head that take the decode path


def decode_rows(t: int, g: int) -> Optional[int]:
    """Query rows per work item of K3's split-KV decode path for T query
    positions and g query heads per kv head -- the power of two >= the T*g
    rows of a kv head, at most 16 -- or None where the shape takes the
    prefill path. Every T = 1 step decodes (rows beyond 16 are taken 16 at a
    time); otherwise up to 16 rows do: past that the tensor-core tiles of
    the prefill path, 16 rows a warp, are no longer mostly padding."""
    rows = t * g
    if t != 1 and rows > DECODE_MAX_ROWS:
        return None
    r = 1
    while r < min(rows, DECODE_MAX_ROWS):
        r *= 2
    return r


def split_plan(items: int, attend_len: int, sms: int) -> tuple[int, int]:
    """K3 decode's key splits for ``items`` (batch row, kv head, row group)
    triples over keys [0, attend_len) on a card of ``sms`` SMs: (nsplit,
    chunk), chunk a multiple of ``KEY_TILE``, the splits [i*chunk,
    (i+1)*chunk) covering every key once and each starting below
    attend_len, with about two work items per SM (one SM holds two decode
    blocks) -- or one split per 64 keys where there are fewer keys."""
    want = max(1, -(-2 * sms // items))
    chunk = KEY_TILE * -(-attend_len // (want * KEY_TILE))
    return -(-attend_len // chunk), chunk


# K3's prefill path (csrc/flash_prefill_wg.cuh): keys a tile by head width
# (the kernel's Cfg::BN), and the query rows of a consumer warpgroup
PREFILL_KEY_TILES = {64: 128, 128: 64, 256: 64}
PREFILL_WG_ROWS = 64


def prefill_rows(rows: int) -> int:
    """Query rows of a block of K3's prefill path for ``rows`` query rows a
    kv head: one consumer warpgroup (64) where they fit, so that a 64-row
    admission chunk carries no empty rows, else two (128)."""
    return PREFILL_WG_ROWS if rows <= PREFILL_WG_ROWS else 2 * PREFILL_WG_ROWS


@dataclass(frozen=True)
class PrefillItem:
    """A block of K3's prefill path: batch row ``b``, kv head ``hk``, query
    tile ``qt``; ``rows`` = [r0, r1), its real query rows (row = t*g +
    slot); ``tiles`` key tiles [0, tiles * key_tile) loaded; ``masked``, for
    each consumer warpgroup (64 rows from r0 on), the tiles it masks key by
    key (those crossing its rows' causal diagonal; every key of the others
    is visible to all its rows)."""
    b: int
    hk: int
    qt: int
    rows: tuple
    tiles: int
    masked: tuple


def prefill_plan(rows: int, g: int, past, attend_len: int, d: int,
                 batch: int, hkv: int) -> list:
    """K3's prefill blocks in launch order (``PrefillItem``): query tiles of
    ``prefill_rows(rows)`` rows for each (batch row, kv head), the heaviest
    tiles first; ``past`` the [B] cursors. A block loads the key tiles up
    to its last row's diagonal (none wholly above it) and within
    attend_len."""
    br, bn = prefill_rows(rows), PREFILL_KEY_TILES[d]
    nqt, nbh = -(-rows // br), batch * hkv
    items = []
    for blk in range(nqt * nbh):
        qt, bh = nqt - 1 - blk // nbh, blk % nbh
        b, hk = divmod(bh, hkv)
        r0, r1 = qt * br, min(rows, (qt + 1) * br)
        kv_end = min(attend_len, past[b] + (r1 - 1) // g + 1)
        tiles = -(-kv_end // bn)
        masked = []
        for w in range(br // PREFILL_WG_ROWS):
            full_end = min(attend_len,
                           past[b] + (r0 + w * PREFILL_WG_ROWS) // g + 1)
            masked.append(tuple(j for j in range(tiles)
                                if (j + 1) * bn > full_end))
        items.append(PrefillItem(b, hk, qt, (r0, r1), tiles, tuple(masked)))
    return items


def attend_prefill_tiles_plain(q, k_cache, v_cache, past_len, attend_len: int,
                               input_mask=None, k_scale=None, v_scale=None,
                               *, p_dtype=torch.bfloat16, out_dtype=None,
                               fault=None):
    """K3's prefill path in plain tensor code: the blocks of
    ``prefill_plan``, each consumer warpgroup's 64 rows over its block's key
    tiles in order with the kernel's online softmax in f32 -- the K scale
    then 1/sqrt(D) on the raw integer scores, ``MASK_VALUE`` on the keys of
    a masked tile past a row's diagonal, the pad bias after it, the running
    max m, alpha = exp(m - m_new), l summing the unscaled p, the V scale on
    p, p rounded to ``p_dtype`` before PV -- and O / l (l == 0 -> 1). The
    rows are independent, so key tile j runs for every row at once; a row
    whose block does not load tile j takes no part in it (m, l and O stay
    as they are). ``p_dtype=torch.float32`` is the exact decomposition of
    the full softmax. ``fault`` plants a kernel's fault for the tests:
    "causal" (no tile masked), "v_scale_on_l" (l sums the V-scaled p),
    "halves" (an int4 cache's two nibbles read swapped). Output in
    ``out_dtype`` (default q.dtype)."""
    b, t, h, d = q.shape
    mode = kv_mode(k_cache, d, k_scale)
    hkv = k_cache.shape[1]
    g, rows = h // hkv, t * (h // hkv)
    if decode_rows(t, g) is not None or d not in PREFILL_KEY_TILES:
        raise ValueError(f"T={t}, {rows} rows a kv head, head_dim {d}: not "
                         f"K3's prefill path")
    past = [int(x) for x in _past_tensor(past_len, b, q.device).tolist()]
    bn = PREFILL_KEY_TILES[d]
    plan = prefill_plan(rows, g, past, attend_len, d, b, hkv)
    # each row's loaded tiles and the tiles it masks key by key
    n_tiles = max(it.tiles for it in plan)
    loaded = torch.zeros((b, hkv, rows, n_tiles), dtype=torch.bool)
    masked = torch.zeros_like(loaded)
    for it in plan:
        loaded[it.b, it.hk, it.rows[0]:it.rows[1], :it.tiles] = True
        for w, tiles in enumerate(it.masked):
            r0 = it.rows[0] + w * PREFILL_WG_ROWS
            r1 = min(it.rows[1], r0 + PREFILL_WG_ROWS)
            masked[it.b, it.hk, r0:r1, list(tiles)] = fault != "causal"
    loaded, masked = loaded.to(q.device), masked.to(q.device)
    k = k_cache[:, :, :attend_len]
    v = v_cache[:, :, :attend_len]
    if mode == 2:
        k, v = unpack_kv4(k, torch.float32), unpack_kv4(v, torch.float32)
        if fault == "halves":
            k, v = (torch.cat([x[..., d // 2:], x[..., :d // 2]], -1)
                    for x in (k, v))
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    qr = (q.reshape(b, t, hkv, g, d).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, rows, d).to(torch.float32))
    pad = (None if input_mask is None else
           ~input_mask[:, :attend_len].to(q.device, torch.bool))
    pt = torch.tensor(past, device=q.device)
    lim = torch.clamp(pt[:, None] + torch.arange(rows, device=q.device) // g
                      + 1, max=attend_len)[:, None, :, None]    # [B, 1, R, 1]
    m = torch.full((b, hkv, rows), MASK_VALUE, device=q.device)
    l = torch.zeros((b, hkv, rows), device=q.device)
    o = torch.zeros((b, hkv, rows, d), device=q.device)
    scale = 1.0 / math.sqrt(d)
    for j in range(n_tiles):
        s0, s1 = j * bn, min((j + 1) * bn, attend_len)
        with full_f32_matmul():
            sc = qr @ kf[:, :, s0:s1].transpose(-1, -2)
        if mode:
            sc = sc * k_scale[:, :, None, s0:s1]   # then 1/sqrt(D)
        sc = sc * scale
        keys = torch.arange(s0, s1, device=q.device)
        ok = loaded[..., j, None] & ~(masked[..., j, None] & (keys >= lim))
        sc = torch.where(ok, sc, MASK_VALUE)
        if pad is not None:     # the pad bias after the causal mask
            sc = torch.where(ok & pad[:, None, None, s0:s1], sc + NEG_INF, sc)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
        p_l = p                 # l sums the unscaled p
        if mode:
            p = p * v_scale[:, :, None, s0:s1]
            if fault == "v_scale_on_l":
                p_l = p
        l = alpha * l + p_l.sum(-1)
        with full_f32_matmul():
            o = (alpha[..., None] * o
                 + p.to(p_dtype).to(torch.float32) @ vf[:, :, s0:s1])
        m = m_new
    out = o / torch.where(l == 0.0, 1.0, l)[..., None]
    out = out.reshape(b, hkv, t, g, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, t, h, d).to(out_dtype or q.dtype)


_SCRATCH: dict = {}


def _decode_scratch(dev, n_part: int, n_ticket: int):
    """The decode path's partials (f32) and tickets (int32, zero between
    launches: the last block of each ticket resets it), grown per device
    and kept, so a decode step allocates nothing. A graph holds the
    buffers it captured (``kernels.scratch_in_use``); growing under capture
    raises."""
    part, ticket = _SCRATCH.get(dev, (None, None))
    if part is None or part.numel() < n_part:
        kernels.no_growth_under_capture("K3's decode partials")
        part = torch.empty((n_part,), dtype=torch.float32, device=dev)
    if ticket is None or ticket.numel() < n_ticket:
        kernels.no_growth_under_capture("K3's decode tickets")
        ticket = torch.zeros((n_ticket,), dtype=torch.int32, device=dev)
    _SCRATCH[dev] = (part, ticket)
    return part, ticket


def attend(q, k_cache, v_cache, past_len, attend_len: int, input_mask=None,
           new_kv=None, k_scale=None, v_scale=None):
    """Masked causal GQA attention, [B, T, H, D] in q.dtype: kernel K3 for
    CUDA tensors, :func:`attend_plain` for CPU ones. ``k_scale`` /
    ``v_scale`` [B, Hkv, S_max] f32 go with an int8 or int4 cache. K3 takes
    its split-KV decode path where :func:`decode_rows` says so (splits from
    :func:`split_plan`), its prefill path on wgmma elsewhere (blocks of
    :func:`prefill_rows` query rows, :func:`prefill_plan`)."""
    if q.device.type == "cpu":
        return attend_plain(q, k_cache, v_cache, past_len, attend_len,
                            input_mask, new_kv, k_scale, v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"attend: unsupported device {q.device}")
    b, t, h, d = q.shape
    mode = kv_mode(k_cache, d, k_scale)
    _, hkv, s_max, _ = k_cache.shape
    if not flash_supported_head_dim(d):
        raise ValueError(f"flash_attn: head_dim {d}; takes 64, 128 or 256")
    if h % hkv or k_cache.shape[0] != b or v_cache.shape != k_cache.shape:
        raise ValueError("flash_attn: q / cache shapes disagree")
    if not 0 < attend_len <= s_max:
        raise ValueError(f"attend_len {attend_len} outside (0, {s_max}]")
    q = q.contiguous()
    if q.data_ptr() % 16:       # the kernel loads rows in 16-byte vectors
        q = q.clone()
    if q.dtype != torch.bfloat16:
        raise ValueError("flash_attn takes a bf16 q")
    for x in (k_cache, v_cache):
        if x.dtype != k_cache.dtype or not x.is_contiguous() \
                or x.data_ptr() % 16 or x.device != q.device:
            raise ValueError("flash_attn takes contiguous 16-byte aligned "
                             "caches of one type on q's device")
    if mode:
        for x in (k_scale, v_scale):
            if x is None or x.dtype != torch.float32 \
                    or x.shape != (b, hkv, s_max) or not x.is_contiguous() \
                    or x.device != q.device:
                raise ValueError("flash_attn takes contiguous f32 "
                                 "[B, Hkv, S_max] K and V scales")
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
    rows = decode_rows(t, h // hkv)
    part = ticket = None
    nsplit = chunk = 0
    if rows is None:
        rows = prefill_rows(t * (h // hkv))
    else:
        groups = b * hkv * -(-t * (h // hkv) // rows)
        nsplit, chunk = split_plan(groups, attend_len, kernels.sm_count(q.device))
        part, ticket = _decode_scratch(
            q.device, groups * nsplit * rows * (d + 2), groups)
    out = torch.empty_like(q)
    lib = "flash_attn_d256" if d == 256 else "flash_attn"
    kernels.check(kernels.launcher(lib)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kernels.ptr(k_scale if mode else None),
        kernels.ptr(v_scale if mode else None), past.data_ptr(),
        kernels.ptr(mask), kernels.ptr(kn), kernels.ptr(vn), out.data_ptr(),
        kernels.ptr(part), kernels.ptr(ticket),
        b, t, h, hkv, d, s_max, attend_len,
        0 if mask is None else mask.shape[1], mode, rows, nsplit, chunk,
        1.0 / math.sqrt(d), kernels.stream_of(q),
    ), lib)
    count_launch(attend, mode)
    if part is None:
        attr = "launches_prefill" + ("" if mode == 0 else f"_{KV_MODES[mode]}")
        setattr(attend, attr, getattr(attend, attr) + 1)
    return out


init_launch_counters(attend)
attend.launches_prefill = attend.launches_prefill_int8 = 0
attend.launches_prefill_int4 = 0


# ------------------------------------------------- deferred batched commit

def kv_ptr_array(k_caches, v_caches, k_scales=None,
                 v_scales=None) -> torch.Tensor:
    """K8's operand: an int64 array, on the caches' device, of the cache
    base pointers -- the 2L of K layers then V layers, followed for a
    quantized cache by the 2L of K scales then V scales -- after checking
    that they are contiguous 16-byte aligned tensors of one shape and type.
    The tensors are updated in place and never move, so ``ExLlamaCache``
    builds this once (``kv_ptrs``)."""
    if len(k_caches) != len(v_caches):
        raise ValueError("kv_commit: as many K as V caches")
    groups = [(*k_caches, *v_caches)]
    if k_scales is not None:
        if len(k_scales) != len(k_caches) or len(v_scales) != len(k_caches):
            raise ValueError("kv_commit: one K and one V scale per layer")
        groups.append((*k_scales, *v_scales))
    dev = k_caches[0].device
    for group in groups:
        first = group[0]
        for t in group:
            if (t.dtype != first.dtype or not t.is_contiguous()
                    or t.device != dev or t.shape != first.shape
                    or t.data_ptr() % 16):
                raise ValueError("kv_commit: contiguous 16-byte aligned "
                                 "caches (and scales) of one shape and type "
                                 "on one device")
    return torch.tensor([t.data_ptr() for group in groups for t in group],
                        dtype=torch.int64).to(dev)


def kv_commit(k_caches, v_caches, new_k, new_v, past: torch.Tensor,
              k_scales=None, v_scales=None, ptrs=None):
    """K8: every layer's bf16 rows new_k / new_v [L, B, 1, Hkv, D] written
    into k_caches[l] / v_caches[l] [B, Hkv, S, D] at the cursor ``past``, an
    int32 tensor [1] (shared) or [B] (one a row) on the caches' device that
    the kernel reads (a row whose cursor is outside [0, S) is not written,
    as the plain writes at a tensor cursor leave it: the JAX package's
    clamped write would land it on a row inside, ``_write_at`` says where
    and why the port does not), in place, in one launch; for a quantized
    cache the kernel quantizes
    each row (:func:`quantize_kv_rows` / ``quantize_kv_rows4``) and writes
    its scale into k_scales[l] / v_scales[l] [B, Hkv, S] too. CPU caches
    take the plain per-layer writes. ``ptrs`` is :func:`kv_ptr_array` of
    these tensors, built here when not given."""
    quantized = k_scales is not None
    if k_caches[0].device.type == "cpu":
        for li in range(len(k_caches)):
            update_kv_cache(k_caches[li], v_caches[li], new_k[li], new_v[li],
                            past, k_scales[li] if quantized else None,
                            v_scales[li] if quantized else None)
        return
    if k_caches[0].device.type != "cuda":
        raise RuntimeError(f"kv_commit: unsupported device "
                           f"{k_caches[0].device}")
    n_layers = len(k_caches)
    b, hkv, s_max, _ = k_caches[0].shape
    d = new_k.shape[-1]
    mode = kv_mode(k_caches[0], d, k_scales[0] if quantized else None)
    new_k = new_k.to(torch.bfloat16).contiguous()
    new_v = new_v.to(torch.bfloat16).contiguous()
    if new_k.shape != (n_layers, b, 1, hkv, d) or new_v.shape != new_k.shape:
        raise ValueError(f"kv_commit: rows {tuple(new_k.shape)} vs caches "
                         f"{n_layers} x {tuple(k_caches[0].shape)}")
    if d % 8:
        raise ValueError(f"kv_commit: head_dim {d}")
    if (not torch.is_tensor(past) or past.dtype != torch.int32
            or past.device != new_k.device or not past.is_contiguous()
            or past.numel() not in (1, b)):
        raise ValueError("kv_commit: the cursor is a contiguous int32 [1] or "
                         "[B] tensor on the caches' device")
    if ptrs is None:
        ptrs = kv_ptr_array(k_caches, v_caches, k_scales, v_scales)
    if ptrs.shape != ((4 if quantized else 2) * n_layers,) \
            or ptrs.dtype != torch.int64:
        raise ValueError("kv_commit: ptrs must be kv_ptr_array(caches)")
    for t in (new_k, new_v):
        if t.device != ptrs.device or t.data_ptr() % 16:
            raise ValueError("kv_commit: rows must be 16-byte aligned, on "
                             "the caches' device")
    kernels.check(kernels.launcher("kv_commit")(
        ptrs.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), past.data_ptr(),
        past.numel(), n_layers, b, hkv, s_max, d, mode,
        kernels.stream_of(new_k),
    ), "kv_commit")
    count_launch(kv_commit, mode)


def launch_floor(device):
    """One launch of an empty kernel on ``device`` (csrc/kv_commit.cu:
    kv_launch_floor): the floor below which no launch, K8 included, can
    go; phase 3 of chip_smoke.py times it with the kernels' timer."""
    kernels.check(kernels.launcher("kv_launch_floor")(
        torch.cuda.current_stream(device).cuda_stream), "kv_launch_floor")


init_launch_counters(kv_commit)


def commit_kv_cache(k_caches, v_caches, new_k, new_v, past_len,
                    k_scales=None, v_scales=None, impl: str = "auto",
                    ptrs=None):
    """Deferred commit of a decode step (port of attention.py:284): the
    bf16 rows new_k[l] / new_v[l] ([B, 1, Hkv, D]; a stacked [L, ...] tensor
    -- ``ExLlamaCache.rows`` -- or a list) go into every layer's cache at
    ``past_len`` (an int, or a [1] / [B] tensor of cursors), in place,
    quantized on the way into an int8 / int4 cache (``k_scales`` /
    ``v_scales``: the layers' [B, Hkv, S] f32 scale tensors). Returns
    (k_caches, v_caches, k_scales, v_scales).

    ``impl="pallas"`` takes :func:`kv_commit`, K8 (the JAX value name, kept
    so call sites port unchanged), with the caches' pointer array ``ptrs``
    (``ExLlamaCache.kv_ptrs``) and a device cursor: a tensor ``past_len`` as
    it is, an int (which must lie in [0, S)) as a new [1] tensor. The JAX
    package sends a per-row cursor to its plain writes instead
    (attention.py:309-319); K8 computes the same function. A list of rows
    is stacked first, the plain route for a caller that does not stage
    them. ``"xla"`` and ``"auto"`` -- which resolves to the plain writes,
    as in the JAX package -- write one layer at a time with
    :func:`update_kv_cache`. On either route a row whose tensor cursor lies
    outside [0, S) is left unwritten, where the JAX package's clamped write
    lands it on a valid row: a stated deviation (``_write_at``)."""
    if impl not in COMMIT_IMPLS:
        raise ValueError(f"commit_impl {impl!r}")
    quantized = k_scales is not None
    if impl == "pallas":
        if not torch.is_tensor(new_k):
            new_k, new_v = torch.stack(list(new_k)), torch.stack(list(new_v))
        if (not torch.is_tensor(past_len)
                and not 0 <= past_len < k_caches[0].shape[2]):
            raise ValueError(f"commit_kv_cache: cursor {past_len} outside "
                             f"the cache")
        past = past_len
        if k_caches[0].device.type == "cuda":
            dev = k_caches[0].device
            past = (past_len.to(device=dev, dtype=torch.int32).reshape(-1)
                    .contiguous() if torch.is_tensor(past_len) else
                    torch.full((1,), past_len, dtype=torch.int32, device=dev))
        kv_commit(k_caches, v_caches, new_k, new_v, past, k_scales,
                  v_scales, ptrs)
    elif quantized:
        # every layer's rows quantized in one pass (a row's bytes and scale
        # depend on that row alone), then the per-layer writes
        if not torch.is_tensor(new_k):
            new_k, new_v = torch.stack(list(new_k)), torch.stack(list(new_v))
        mode = kv_mode(k_caches[0], new_k.shape[-1], k_scales[0])
        quant = quantize_kv_rows4 if mode == 2 else quantize_kv_rows
        for caches, scales, new in ((k_caches, k_scales, new_k),
                                    (v_caches, v_scales, new_v)):
            q, s = quant(new)                   # [L, B, 1, Hkv, D*], [L, B, 1, Hkv]
            for li in range(len(caches)):
                _write_at(caches[li], q[li], past_len)
                _write_at(scales[li], s[li], past_len)
    else:
        for li in range(len(k_caches)):
            update_kv_cache(k_caches[li], v_caches[li], new_k[li], new_v[li],
                            past_len)
    return k_caches, v_caches, k_scales, v_scales
