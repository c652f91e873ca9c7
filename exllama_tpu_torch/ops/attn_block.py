"""Fused decode layer tail (port of exllama_tpu/ops/attn_block.py).

Three entry points, one kernel: K7 ``layer_tail`` (csrc/layer_tail.cu), a
single launch per layer on the deferred-commit decode path (T = 1):

  * ``attn_block_o``: h + o_proj(attention(q, cache + in-flight row));
  * ``layer_tail``: the same, then post-norm -> MLP -> residual;
  * ``layer_step``: input norm -> fused qkv GEMV -> rope ahead of
    ``layer_tail``; also returns the step's K/V rows for the commit.

Every launch of any of the three counts on ``layer_tail.launches``, or,
under the W4A8 values of ``impl`` ("pallas_a8", "pallas_a8x2",
"pallas_a8t": every GEMV phase in K9's integer arithmetic, the a8 builds of
the same source), on ``layer_tail_a8.launches``; a launch over an int8 or
int4 KV cache (``k_scale`` / ``v_scale`` given, as ``ops.attention.attend``
takes them) counts on ``launches_int8`` / ``launches_int4`` of the same
function instead. The attention arithmetic is K3's in every case. The
``*_plain`` functions are their plain PyTorch versions, the separate path's
composition (``attend_plain`` and the q4 plain products), which CPU tensors
take. The caller checks ``attn_o_applicable`` (and, for the MLP and qkv
phases, ``ops.mlp.fused_mlp_applicable``, ``layer_step_applicable`` and
``same_groupsize``) first. ``layer_tail_split_plain`` and
``layer_step_split_plain`` write out the kernel's own decomposition: its
GEMV phases as ``ops.quant.fused_gemv_split_plain`` (one row: stream-K
ranges; more rows: K splits) and its key splits merged by the last block of
each (batch row, kv head) pair (``attention_split_plain``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from exllama_tpu_torch import kernels
from exllama_tpu_torch.config import A8_IMPLS, check_matmul_impl
from exllama_tpu_torch.ops.attention import (
    MASK_VALUE,
    _in_flight,
    _masked_scores,
    _past_tensor,
    attend_plain,
    count_launch,
    init_launch_counters,
    kv_mode,
)
from exllama_tpu_torch.ops.mlp import gemv_plain_of, q4_mlp_plain, silu_mul
from exllama_tpu_torch.ops.quant import (
    GEMV_MAX_M,
    check_qt_tensors,
    fused_gemv_scratch,
    fused_gemv_split_plain,
)
from exllama_tpu_torch.ops.rope import apply_rope_sliced

HEAD_DIM = 128         # K7's attention takes head_dim 128
MAX_GROUP = 8          # ... and at most 8 query heads per kv head


def attn_o_applicable(o, hidden: int, heads: int, head_dim: int, t: int,
                      deferred: bool, batch: int = 1,
                      kv_heads: Optional[int] = None) -> bool:
    """The JAX gate's semantic conditions (attn_block.py:438-469): decode
    only (T = 1, deferred commit), B <= 32, an o-proj without act-order
    whose input is the heads and whose output is the residual. K7's own
    limits: head_dim 128, at most 8 query heads per kv head, the groupsizes
    its GEMV takes."""
    if o is None or not deferred or t != 1 or batch > GEMV_MAX_M:
        return False
    if o.x_map is not None or o.groupsize not in (32, 64, 128):
        return False
    if head_dim != HEAD_DIM or o.out_features != hidden:
        return False
    if kv_heads is not None and (heads % kv_heads
                                 or heads // kv_heads > MAX_GROUP):
        return False
    return o.in_features == heads * head_dim


def layer_step_applicable(qkv, o, hidden: int, heads: int,
                          head_dim: int) -> bool:
    """Phase B's extra conditions (attn_block.py:923-950): a fused qkv
    without act-order on the residual, o's groupsize, head_dim 128 (rope
    pairs column j with j + 64 of one head)."""
    if qkv is None or o is None or qkv.x_map is not None:
        return False
    if qkv.in_features != hidden or qkv.groupsize != o.groupsize:
        return False
    return head_dim == HEAD_DIM and heads * head_dim == o.in_features


def same_groupsize(*qts) -> bool:
    """One groupsize across the tensors one K7 launch reads."""
    return len({qt.groupsize for qt in qts if qt is not None}) <= 1


# ------------------------------------------------------------ plain versions

def attn_block_o_plain(h, q, k_cache, v_cache, past_len, attend_len, o,
                       new_kv, input_mask=None, impl="auto", k_scale=None,
                       v_scale=None):
    b, _, hidden = h.shape
    attn = attend_plain(q, k_cache, v_cache, past_len, attend_len, input_mask,
                        new_kv, k_scale, v_scale)
    return h + gemv_plain_of(impl)(attn.reshape(b, -1), o).reshape(
        b, 1, hidden)


def layer_tail_plain(h, q, k_cache, v_cache, past_len, attend_len, o,
                     post_norm, gateup, down, eps, new_kv, input_mask=None,
                     impl="auto", k_scale=None, v_scale=None):
    h = attn_block_o_plain(h, q, k_cache, v_cache, past_len, attend_len, o,
                           new_kv, input_mask, impl, k_scale, v_scale)
    return q4_mlp_plain(h, post_norm, gateup, down, eps, impl)


def _qkv_rows_plain(h, qkv, input_norm, rope_sin, rope_cos, heads, kv_heads,
                    head_dim, eps, impl="auto", gemv=None):
    b = h.shape[0]
    nq, nkv = heads * head_dim, kv_heads * head_dim
    fused = (gemv or gemv_plain_of(impl))(h.reshape(b, -1), qkv, input_norm,
                                          eps)
    q = fused[:, :nq].reshape(b, 1, heads, head_dim)
    k = fused[:, nq:nq + nkv].reshape(b, 1, kv_heads, head_dim)
    v = fused[:, nq + nkv:].reshape(b, 1, kv_heads, head_dim)
    return (apply_rope_sliced(q, rope_sin, rope_cos),
            apply_rope_sliced(k, rope_sin, rope_cos), v)


def layer_step_plain(h, qkv, input_norm, rope_sin, rope_cos, k_cache, v_cache,
                     past_len, attend_len, o, post_norm, gateup, down, eps,
                     heads, kv_heads, head_dim, input_mask=None,
                     impl="auto", k_scale=None, v_scale=None):
    q, k, v = _qkv_rows_plain(h, qkv, input_norm, rope_sin, rope_cos, heads,
                              kv_heads, head_dim, eps, impl)
    h = layer_tail_plain(h, q, k_cache, v_cache, past_len, attend_len, o,
                         post_norm, gateup, down, eps, (k, v), input_mask,
                         impl, k_scale, v_scale)
    return h, k, v


# ------------------------------------ K7's decomposition in plain code

def key_splits(past_b: int, nsplit: int):
    """K7's key ranges for one batch row: [0, past_b) in ``nsplit`` splits
    of a whole number of 32-key chunks (csrc/layer_tail.cu:attention_phase),
    the last ones possibly empty."""
    cs = (-(-past_b // nsplit) + 31) // 32 * 32
    return [(min(past_b, i * cs), min(past_b, (i + 1) * cs))
            for i in range(nsplit)]


def attention_split_plain(q, k_cache, v_cache, past_len, attend_len: int,
                          new_kv, input_mask=None, k_scale=None, v_scale=None,
                          *, nsplit: int, fault=None):
    """K7's attention phase in plain tensor code: per (batch row, kv head)
    the keys [0, min(past_b, attend_len)) in ``key_splits``, per split an
    f32 (m, l, acc) partial (p rounded to bf16 after the V scale, l over
    the unscaled p), the in-flight row folded into split 0's, then the
    merge that the pair's last block does: the splits in order, rescaled
    to their common max, l == 0 -> 1, rounded to bf16. ``fault`` plants
    what the merge must not do: "drop" leaves out, "twice" counts twice,
    each head's heaviest split. Returns [B, 1, H, D] bf16."""
    b, t, h, d = q.shape
    scores, _, qf, v, vs = _masked_scores(q, k_cache, v_cache, past_len,
                                          attend_len, input_mask, True,
                                          k_scale, v_scale)
    s_new, v_new = _in_flight(qf, new_kv, d)          # [B,Hkv,G,1,1], [B,Hkv,1,D]
    past = _past_tensor(past_len, b, q.device).tolist()
    rows = []
    for bi in range(b):
        ms, ls, accs = [], [], []
        for sp, (lo, hi) in enumerate(key_splits(min(past[bi], attend_len),
                                                 nsplit)):
            sc = scores[bi, ..., lo:hi]                # [Hkv, G, 1, n]
            m = (sc.amax(dim=-1, keepdim=True) if hi > lo else
                 torch.full(sc.shape[:-1] + (1,), MASK_VALUE,
                            device=sc.device))
            p = torch.exp(sc - m)
            l = p.sum(dim=-1, keepdim=True)
            if vs is not None:
                p = p * vs[bi, ..., lo:hi]
            acc = torch.einsum("hgts,hsd->hgtd",
                               p.to(torch.bfloat16).to(torch.float32),
                               v[bi, :, lo:hi])
            if sp == 0:                                # the in-flight row
                m_fin = torch.maximum(m, s_new[bi])
                alpha, p_new = torch.exp(m - m_fin), torch.exp(s_new[bi] - m_fin)
                l = alpha * l + p_new
                acc = alpha * acc + p_new * v_new[bi][:, None]
                m = m_fin
            ms.append(m)
            ls.append(l)
            accs.append(acc)
        m_all = torch.stack(ms)                        # [nsplit, Hkv, G, 1, 1]
        f = torch.exp(m_all - m_all.amax(dim=0))
        if fault is not None:
            heavy = torch.nn.functional.one_hot(
                m_all.argmax(dim=0)[..., 0, 0], len(ms)).movedim(-1, 0)
            f = f * (1 - heavy if fault == "drop" else 1 + heavy)[..., None, None]
        l = (f * torch.stack(ls)).sum(dim=0)
        acc = (f * torch.stack(accs)).sum(dim=0)       # [Hkv, G, 1, D]
        l = torch.where(l == 0.0, 1.0, l)
        rows.append((acc / l).reshape(1, h, d))
    return torch.stack(rows).to(torch.bfloat16)


def layer_tail_split_plain(h, q, k_cache, v_cache, past_len, attend_len, o,
                           post_norm, gateup, down, eps, new_kv,
                           input_mask=None, impl="auto", k_scale=None,
                           v_scale=None, *, blocks: int, nsplit: int,
                           fault=None):
    """``layer_tail`` as K7 decomposes it on a grid of ``blocks`` blocks
    with ``nsplit`` key splits (``post_norm=None``: ``attn_block_o``)."""
    b, _, hidden = h.shape
    attn = attention_split_plain(q, k_cache, v_cache, past_len, attend_len,
                                 new_kv, input_mask, k_scale, v_scale,
                                 nsplit=nsplit, fault=fault)
    h2 = h.reshape(b, hidden)
    h1 = h2 + fused_gemv_split_plain(attn.reshape(b, -1), o, blocks, impl=impl)
    if post_norm is not None:
        gu = fused_gemv_split_plain(h1, gateup, blocks, post_norm, eps, impl)
        h1 = h1 + fused_gemv_split_plain(silu_mul(gu, down.in_features), down,
                                         blocks, impl=impl)
    return h1.reshape(b, 1, hidden)


def layer_step_split_plain(h, qkv, input_norm, rope_sin, rope_cos, k_cache,
                           v_cache, past_len, attend_len, o, post_norm,
                           gateup, down, eps, heads, kv_heads, head_dim,
                           input_mask=None, impl="auto", k_scale=None,
                           v_scale=None, *, blocks: int, nsplit: int):
    """``layer_step`` as K7 decomposes it: the qkv phase split as planned,
    then ``layer_tail_split_plain``."""
    def gemv(x, qt, norm_w, e):
        return fused_gemv_split_plain(x, qt, blocks, norm_w, e, impl)

    q, k, v = _qkv_rows_plain(h, qkv, input_norm, rope_sin, rope_cos, heads,
                              kv_heads, head_dim, eps, gemv=gemv)
    out = layer_tail_split_plain(h, q, k_cache, v_cache, past_len, attend_len,
                                 o, post_norm, gateup, down, eps, (k, v),
                                 input_mask, impl, k_scale, v_scale,
                                 blocks=blocks, nsplit=nsplit)
    return out, k, v


# -------------------------------------------------------------------- K7

def _bf16_vec(x, n):
    x = x.to(torch.bfloat16).contiguous()
    if x.shape != (n,):
        raise ValueError(f"norm weight shape {tuple(x.shape)} != ({n},)")
    return x


def _aligned(name, x, dtype):
    if x.dtype != dtype or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"layer_tail: {name} must be contiguous 16-byte "
                         f"aligned {dtype}")
    return x


def _launch(h, k_cache, v_cache, past_len, attend_len, o, input_mask, *,
            q=None, new_kv=None, qkv=None, input_norm=None, rope=None,
            post_norm=None, gateup=None, down=None, eps=1e-6, impl="auto",
            k_scale=None, v_scale=None):
    """One K7 launch; returns (out [B, 1, hidden], k_row, v_row)."""
    a8 = impl in A8_IMPLS
    lib = "layer_tail" if not a8 else (
        "layer_tail_a8x2" if impl == "pallas_a8x2" else "layer_tail_a8")
    b, t, hidden = h.shape
    dev = h.device
    if t != 1 or b > GEMV_MAX_M:
        raise ValueError("layer_tail is a decode path: T = 1, B <= 32")
    d = HEAD_DIM
    mode = kv_mode(k_cache, d, k_scale)      # bf16 / int8 / int4 (D/2 bytes)
    if mode:
        lib += "_kvq"       # the build for quantized caches
    _, hkv, s_max, _ = k_cache.shape
    heads = o.in_features // d
    g = heads // hkv
    if (k_cache.shape[0] != b or v_cache.shape != k_cache.shape
            or heads % hkv or g > MAX_GROUP or o.out_features != hidden):
        raise ValueError("layer_tail: shapes outside attn_o_applicable")
    if not 0 < attend_len <= s_max:
        raise ValueError(f"attend_len {attend_len} outside (0, {s_max}]")
    _aligned("k_cache", k_cache, k_cache.dtype)
    _aligned("v_cache", v_cache, k_cache.dtype)
    if mode:
        _aligned("k_scale", k_scale, torch.float32)
        _aligned("v_scale", v_scale, torch.float32)
        if v_scale.shape != k_scale.shape:
            raise ValueError("layer_tail: K and V scales of one shape")
    if any(x.device != dev for x in (k_cache, v_cache, k_scale, v_scale)
           if x is not None):
        raise ValueError("layer_tail: caches and scales on h's device")
    h2 = h.reshape(b, hidden).contiguous()
    if h2.dtype != torch.bfloat16:
        raise TypeError("layer_tail takes a bf16 residual")
    qts = [o, qkv, gateup, down]
    for qt in qts:
        if qt is not None:
            check_qt_tensors(qt, dev)
    if not same_groupsize(*qts) or any(
            qt is not None and qt.x_map is not None for qt in qts):
        raise ValueError("layer_tail: one groupsize and no act-order")
    past = _past_tensor(past_len, b, dev).contiguous()
    mask = None
    if input_mask is not None:
        if input_mask.shape[0] != b or input_mask.shape[1] < attend_len:
            raise ValueError("input_mask must be [B, >= attend_len]")
        mask = input_mask.to(device=dev, dtype=torch.bool).contiguous()

    k_row = v_row = sin = cos = None
    if qkv is not None:
        if qkv.out_features != (heads + 2 * hkv) * d or qkv.in_features != hidden:
            raise ValueError("layer_step: qkv shape")
        input_norm = _bf16_vec(input_norm, hidden)
        sin, cos = (r.to(torch.float32).reshape(-1, d).contiguous() for r in rope)
        if sin.shape[0] not in (1, b) or cos.shape != sin.shape:
            raise ValueError("layer_step: rope rows must be [1 | B, ..., D]")
        k_row = torch.empty((b, 1, hkv, d), dtype=torch.bfloat16, device=dev)
        v_row = torch.empty_like(k_row)
    else:
        q = _aligned("q", q.to(torch.bfloat16).contiguous(), torch.bfloat16)
        kn, vn = (x.to(torch.bfloat16).contiguous() for x in new_kv)
        if q.shape != (b, 1, heads, d) or kn.shape != (b, 1, hkv, d) \
                or vn.shape != kn.shape:
            raise ValueError("layer_tail: q [B,1,H,D] and new_kv [B,1,Hkv,D]")
        new_kv = (kn, vn)
    inter = 0
    if post_norm is not None:
        inter = down.in_features
        post_norm = _bf16_vec(post_norm, hidden)
        if (gateup.in_features != hidden or gateup.out_features != 2 * inter
                or down.out_features != hidden):
            raise ValueError("layer_tail: gate|up / down shapes")

    # scratch regions, 256-byte aligned: qkv rows, split partials, the
    # attention row, h', gate|up, the barrier counter
    nsplit_cap = max(1, attend_len // 128)
    sizes = [
        b * (heads + 2 * hkv) * d * 2 if qkv is not None else 0,
        b * hkv * nsplit_cap * g * (d + 2) * 4,
        b * heads * d * 2,
        b * hidden * 2 if inter else 0,
        b * 2 * inter * 2,
        4,
    ]
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 256) * 256
    scratch = torch.empty((total,), dtype=torch.uint8, device=dev)
    ptrs = [scratch.data_ptr() + off for off in offs]
    widest = max(hidden, 2 * inter, qkv.out_features if qkv is not None else 0)
    gpart, gticket = fused_gemv_scratch(dev, b, widest, tickets=b * hkv)
    out = torch.empty_like(h2)
    P = kernels.ptr

    def qw(qt):
        return ((None, None, None) if qt is None else
                (qt.qweight.data_ptr(), qt.scales.data_ptr(),
                 qt.zscale.data_ptr()))

    kernels.check(kernels.launcher(lib)(
        P(q), *(P(x) for x in (new_kv or (None, None))),
        k_cache.data_ptr(), v_cache.data_ptr(), P(k_scale if mode else None),
        P(v_scale if mode else None), past.data_ptr(), P(mask),
        h2.data_ptr(), *qw(o), P(input_norm), *qw(qkv), P(sin), P(cos),
        P(k_row), P(v_row), P(post_norm), *qw(gateup), *qw(down), *ptrs,
        P(gpart), P(gticket), out.data_ptr(),
        b, heads, hkv, s_max, hidden, inter, o.groupsize,
        0 if mask is None else mask.shape[1],
        0 if sin is None or sin.shape[0] == 1 else d,
        nsplit_cap, attend_len, mode, float(eps), 1.0 / math.sqrt(d),
        kernels.stream_of(h2),
    ), lib)
    count_launch(layer_tail_a8 if a8 else layer_tail, mode)
    return out.reshape(b, 1, hidden), k_row, v_row


# ----------------------------------------------------------- entry points

def attn_block_o(h, q, k_cache, v_cache, past_len, attend_len: int, o,
                 new_kv, input_mask=None, impl: str = "auto", k_scale=None,
                 v_scale=None):
    """h + o_proj(flash_attend(q, cache + new_kv)) in one K7 launch.
    h [B, 1, hidden], q [B, 1, H, D] post-rope, new_kv ([B, 1, Hkv, D],)*2."""
    check_matmul_impl(impl)
    if h.device.type == "cpu":
        return attn_block_o_plain(h, q, k_cache, v_cache, past_len,
                                  attend_len, o, new_kv, input_mask, impl,
                                  k_scale, v_scale)
    if h.device.type != "cuda":
        raise RuntimeError(f"attn_block_o: unsupported device {h.device}")
    return _launch(h, k_cache, v_cache, past_len, attend_len, o, input_mask,
                   q=q, new_kv=new_kv, impl=impl, k_scale=k_scale,
                   v_scale=v_scale)[0]


def layer_tail(h, q, k_cache, v_cache, past_len, attend_len: int, o,
               post_norm, gateup, down, eps: float, new_kv, input_mask=None,
               impl: str = "auto", k_scale=None, v_scale=None):
    """The decode layer after rope -- attention, o-proj, residual,
    post-norm, MLP, residual -- in one K7 launch."""
    check_matmul_impl(impl)
    if h.device.type == "cpu":
        return layer_tail_plain(h, q, k_cache, v_cache, past_len, attend_len,
                                o, post_norm, gateup, down, eps, new_kv,
                                input_mask, impl, k_scale, v_scale)
    if h.device.type != "cuda":
        raise RuntimeError(f"layer_tail: unsupported device {h.device}")
    return _launch(h, k_cache, v_cache, past_len, attend_len, o, input_mask,
                   q=q, new_kv=new_kv, post_norm=post_norm, gateup=gateup,
                   down=down, eps=eps, impl=impl, k_scale=k_scale,
                   v_scale=v_scale)[0]


def layer_tail_a8(*args, two_pass: bool = False, **kwargs):
    """``layer_tail`` with K9's arithmetic in every GEMV phase (``two_pass``:
    a8x2). Its ``launches`` counts the a8 launches of all three entry
    points."""
    return layer_tail(*args, impl="pallas_a8x2" if two_pass else "pallas_a8",
                      **kwargs)


def layer_step(h, qkv, input_norm, rope_sin, rope_cos, k_cache, v_cache,
               past_len, attend_len: int, o, post_norm, gateup, down,
               eps: float, heads: int, kv_heads: int, head_dim: int,
               input_mask=None, impl: str = "auto", k_scale=None,
               v_scale=None):
    """The whole decode layer in one K7 launch: input norm, fused qkv GEMV
    and rope (rope_sin / rope_cos [1 | B, 1, 1, D], pre-sliced), then
    ``layer_tail``. Returns (h [B, 1, hidden], k_row, v_row [B, 1, Hkv, D])
    -- the rows feed the caller's deferred commit."""
    check_matmul_impl(impl)
    if h.device.type == "cpu":
        return layer_step_plain(h, qkv, input_norm, rope_sin, rope_cos,
                                k_cache, v_cache, past_len, attend_len, o,
                                post_norm, gateup, down, eps, heads, kv_heads,
                                head_dim, input_mask, impl, k_scale, v_scale)
    if h.device.type != "cuda":
        raise RuntimeError(f"layer_step: unsupported device {h.device}")
    if (head_dim != HEAD_DIM or heads * head_dim != o.in_features
            or k_cache.shape[1] != kv_heads):
        raise ValueError("layer_step: heads / kv_heads disagree with o, cache")
    return _launch(h, k_cache, v_cache, past_len, attend_len, o, input_mask,
                   qkv=qkv, input_norm=input_norm, rope=(rope_sin, rope_cos),
                   post_norm=post_norm, gateup=gateup, down=down, eps=eps,
                   impl=impl, k_scale=k_scale, v_scale=v_scale)


init_launch_counters(layer_tail)
init_launch_counters(layer_tail_a8)
