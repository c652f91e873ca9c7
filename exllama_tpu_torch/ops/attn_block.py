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
function instead, and one over f32 weight scales (the ``_f32`` builds) on
``launches_f32``. The attention arithmetic is K3's in every case. The
``*_plain`` functions are their plain PyTorch versions, the separate path's
composition (``attend_plain`` and the q4 plain products), which CPU tensors
take. The caller checks ``attn_o_applicable`` (and, for the MLP and qkv
phases, ``ops.mlp.fused_mlp_applicable``, ``layer_step_applicable`` and
``same_groupsize``) first. In the exact mode the kernel is the Hopper
design of csrc/fused_wg.cuh (one persistent block an SM, the GEMV phases on
K1's wgmma mainloop, the weights streamed by TMA across the grid barriers);
the a8 modes keep the parent, the streaming GEMV. ``layer_tail_split_plain``
and ``layer_step_split_plain`` write out the kernel's own decomposition:
with ``plan=`` (``layer_tail_plan``) the Hopper kernel's GEMV phases as
``ops.mlp.fused_wg_gemv_split_plain``, with ``blocks=`` the parent's as
``ops.quant.fused_gemv_split_plain`` (stream-K ranges at every row count,
silu(gate)*up formed as the down phase stages x); either way the key
splits merged by the last block of each (batch row, kv head) pair
(``attention_split_plain``). ``layer_step(..., rows_out=)`` writes the
step's K/V rows into the caller's tensors (``ExLlamaCache.rows``, which
the batched commit K8 reads) instead of new ones.
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
from exllama_tpu_torch.ops.mlp import (
    FusedPlan,
    fused_plan,
    fused_wg_gemv_split_plain,
    fused_wg_scratch,
    gemv_plain_of,
    q4_mlp_plain,
)
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
                      kv_heads: Optional[int] = None,
                      impl: str = "auto", has_lora: bool = False) -> bool:
    """The JAX gate's semantic conditions (attn_block.py:438-469): a
    kernel ``impl`` (not the plain "xla"), no LoRA adapter on o, decode only
    (T = 1, deferred commit), B <= 32, an o-proj without act-order whose
    input is the heads and whose output is the residual. K7's own limits:
    head_dim 128, at most 8 query heads per kv head, the groupsizes its
    GEMV takes and, in the exact mode, a width that is a multiple of 8 (the
    rows its Hopper kernel loads by TMA; the a8 modes take any width)."""
    if check_matmul_impl(impl) == "xla" or has_lora:
        return False
    if o is None or not deferred or t != 1 or batch > GEMV_MAX_M:
        return False
    if o.x_map is not None or o.groupsize not in (32, 64, 128):
        return False
    if hidden % 8 and check_matmul_impl(impl) not in A8_IMPLS:
        return False
    if head_dim != HEAD_DIM or o.out_features != hidden:
        return False
    if kv_heads is not None and (heads % kv_heads
                                 or heads // kv_heads > MAX_GROUP):
        return False
    return o.in_features == heads * head_dim


def layer_step_applicable(qkv, o, hidden: int, heads: int,
                          head_dim: int, has_lora: bool = False) -> bool:
    """Phase B's extra conditions (attn_block.py:923-950): no LoRA adapter
    on any projection of the layer, a fused qkv without act-order on the
    residual, o's groupsize, head_dim 128 (rope pairs column j with j + 64
    of one head)."""
    if qkv is None or o is None or has_lora or qkv.x_map is not None:
        return False
    if qkv.in_features != hidden or qkv.groupsize != o.groupsize:
        return False
    return head_dim == HEAD_DIM and heads * head_dim == o.in_features


def same_groupsize(*qts) -> bool:
    """One groupsize (and one scale dtype) across the tensors one K7
    launch reads."""
    qts = [qt for qt in qts if qt is not None]
    return (len({qt.groupsize for qt in qts}) <= 1
            and len({qt.scales.dtype for qt in qts}) <= 1)


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


ATT_CHUNK = 16         # keys of a warp's chunk in the Hopper K7's attention
ATT_WARPS = 8          # ... the consumer warps that read the chunks


def ring_shape(slots: int):
    """The slots that the Hopper K7's attention ring uses of ``slots`` that
    fit, and the warps that read them (csrc/layer_tail.cu: wg::Ring): at
    most 8 warps, the slots a multiple of them."""
    warps = min(ATT_WARPS, slots)
    return slots - slots % warps, warps


def attention_ring_plan(past, attend_len: int, b: int, kv_heads: int,
                        nsplit: int, blocks: int, slots: int):
    """The Hopper K7's attention ring (csrc/layer_tail.cu: wg::produce,
    wg::consume) in plain code, for a ring of ``slots`` chunk slots: for
    each of ``blocks`` blocks, the chunks that its x warp brings into the
    ring, in order -- tuples (item, batch row, kv head, first key, keys,
    warp): the block's items (item = blockIdx + k * blocks of B x Hkv x
    nsplit, (b, kv head) = item // nsplit, split = item % nsplit) cut into
    ``ATT_CHUNK``-key chunks of their ``key_splits`` range, the item's
    chunk c read by warp c % warps (``ring_shape``): which warp sums which
    keys depends on the item alone, not on the block's other items."""
    past = [past] * b if isinstance(past, int) else list(past)
    _, warps = ring_shape(slots)
    out = []
    for blk in range(blocks):
        seq = []
        for item in range(blk, b * kv_heads * nsplit, blocks):
            split, bh = item % nsplit, item // nsplit
            bb, hk = bh // kv_heads, bh % kv_heads
            lo, hi = key_splits(min(past[bb], attend_len), nsplit)[split]
            for c, k0 in enumerate(range(lo, hi, ATT_CHUNK)):
                seq.append((item, bb, hk, k0, min(ATT_CHUNK, hi - k0),
                            c % warps))
        out.append(seq)
    return out


def ring_chunks_read(seq, slots: int) -> int:
    """How many of one block's ring chunks (``attention_ring_plan``) are
    read before the ring stalls: the producer fills chunk a once chunk a -
    ``slots`` has been read; each warp reads its chunks in order, each once
    filled, and an item's chunks only once every chunk of the block's
    lower items has been read (the block's barrier between items). All of
    them where no chunk waits on a later one."""
    filled = read = 0
    done = [False] * len(seq)
    pos = {w: [a for a, c in enumerate(seq) if c[5] == w]
           for w in range(ATT_WARPS)}

    def items_before_read(item):
        return all(done[a] for a, c in enumerate(seq) if c[0] < item)

    progress = True
    while progress:
        progress = False
        while filled < len(seq) and (filled < slots or done[filled - slots]):
            filled += 1
            progress = True
        for todo in pos.values():
            while (todo and todo[0] < filled
                   and items_before_read(seq[todo[0]][0])):
                done[todo.pop(0)] = True
                read += 1
                progress = True
    return read


def ring_waits_unsafe(seq, slots: int):
    """The chunks of one block's ring sequence whose warp may wait on their
    slot before the slot's previous fill (chunk a - ``slots``) has landed:
    those read by another warp of the same item. An mbarrier's parity tells
    only two phases apart, so such a wait can pass on the old phase (the
    ring's loads land out of order). None where each slot's chunks of an
    item stay with one warp."""
    return [a for a in range(slots, len(seq))
            if seq[a - slots][0] == seq[a][0]
            and seq[a - slots][5] != seq[a][5]]


def layer_tail_plan(b: int, hidden: int, heads: int, kv_heads: int,
                    inter: int, attend_len: int, sms: int,
                    qkv: bool = False):
    """The Hopper K7's plan on ``sms`` SMs (csrc/layer_tail.cu:
    launch_hopper): its GEMV phases -- qkv (``qkv``: ``layer_step``), o,
    and with ``inter`` > 0 gate|up and down -- with attention before o
    (``fused_plan``), and the key splits per (batch row, kv head): enough
    work items to cover the grid, at most one a 128 keys of ``attend_len``.
    Returns (plan, nsplit)."""
    d = HEAD_DIM
    shapes = ([("qkv", hidden, (heads + 2 * kv_heads) * d)] if qkv else [])
    shapes.append(("o", heads * d, hidden))
    if inter:
        shapes += [("gateup", hidden, 2 * inter), ("down", inter, hidden)]
    nsplit = max(1, min(sms // (b * kv_heads), max(1, attend_len // 128)))
    return fused_plan(b, sms, shapes, attn_at=1 if qkv else 0), nsplit


def layer_tail_split_plain(h, q, k_cache, v_cache, past_len, attend_len, o,
                           post_norm, gateup, down, eps, new_kv,
                           input_mask=None, impl="auto", k_scale=None,
                           v_scale=None, *, blocks: int = None, nsplit: int,
                           fault=None, plan: FusedPlan = None):
    """``layer_tail`` as K7 decomposes it with ``nsplit`` key splits
    (``post_norm=None``: ``attn_block_o``): with ``plan`` (``layer_tail_
    plan``) the Hopper kernel's GEMV phases, with ``blocks`` the parent's
    on a grid of that many blocks. ``fault``: "drop" / "twice" plant a
    merge fault (``attention_split_plain``); with ``plan`` also
    "residual_twice" (h added twice after o) and "silu_up" (silu applied
    to up, not to gate)."""
    b, _, hidden = h.shape
    attn = attention_split_plain(
        q, k_cache, v_cache, past_len, attend_len, new_kv, input_mask,
        k_scale, v_scale, nsplit=nsplit,
        fault=fault if fault in ("drop", "twice") else None)
    h2 = h.reshape(b, hidden)
    if plan is None:
        h1 = h2 + fused_gemv_split_plain(attn.reshape(b, -1), o, blocks,
                                         impl=impl)
        if post_norm is not None:
            gu = fused_gemv_split_plain(h1, gateup, blocks, post_norm, eps,
                                        impl)
            h1 = h1 + fused_gemv_split_plain(gu, down, blocks, impl=impl,
                                             glu=down.in_features)
        return h1.reshape(b, 1, hidden)
    nb = plan.blocks
    h1 = h2 + fused_wg_gemv_split_plain(attn.reshape(b, -1), o,
                                        plan.phase("o"), nb)
    if fault == "residual_twice":
        h1 = h1 + h2
    if post_norm is not None:
        ni = down.in_features
        gu = fused_wg_gemv_split_plain(h1, gateup, plan.phase("gateup"), nb,
                                       post_norm, eps)
        if fault == "silu_up":
            gu = torch.cat([gu[:, ni:2 * ni], gu[:, :ni]], dim=1)
        h1 = h1 + fused_wg_gemv_split_plain(gu, down, plan.phase("down"), nb,
                                            glu=ni)
    return h1.reshape(b, 1, hidden)


def layer_step_split_plain(h, qkv, input_norm, rope_sin, rope_cos, k_cache,
                           v_cache, past_len, attend_len, o, post_norm,
                           gateup, down, eps, heads, kv_heads, head_dim,
                           input_mask=None, impl="auto", k_scale=None,
                           v_scale=None, *, blocks: int = None, nsplit: int,
                           fault=None, plan: FusedPlan = None):
    """``layer_step`` as K7 decomposes it: the qkv phase split as planned
    (with ``plan``: the normed row rounded to bf16 before the products),
    then ``layer_tail_split_plain``."""
    def gemv(x, qt, norm_w, e):
        if plan is not None:
            return fused_wg_gemv_split_plain(x, qt, plan.phase("qkv"),
                                             plan.blocks, norm_w, e)
        return fused_gemv_split_plain(x, qt, blocks, norm_w, e, impl)

    q, k, v = _qkv_rows_plain(h, qkv, input_norm, rope_sin, rope_cos, heads,
                              kv_heads, head_dim, eps, gemv=gemv)
    out = layer_tail_split_plain(h, q, k_cache, v_cache, past_len, attend_len,
                                 o, post_norm, gateup, down, eps, (k, v),
                                 input_mask, impl, k_scale, v_scale,
                                 blocks=blocks, nsplit=nsplit, fault=fault,
                                 plan=plan)
    return out, k, v


# -------------------------------------------------------------------- K7

def _bf16_vec(x, n, tma):
    x = x.to(torch.bfloat16).contiguous()
    if x.shape != (n,):
        raise ValueError(f"norm weight shape {tuple(x.shape)} != ({n},)")
    return x.clone() if tma and x.data_ptr() % 16 else x    # rows TMA loads


def _aligned(name, x, dtype):
    if x.dtype != dtype or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"layer_tail: {name} must be contiguous 16-byte "
                         f"aligned {dtype}")
    return x


def _launch(h, k_cache, v_cache, past_len, attend_len, o, input_mask, *,
            q=None, new_kv=None, qkv=None, input_norm=None, rope=None,
            post_norm=None, gateup=None, down=None, eps=1e-6, impl="auto",
            k_scale=None, v_scale=None, rows_out=None):
    """One K7 launch; returns (out [B, 1, hidden], k_row, v_row)."""
    a8 = impl in A8_IMPLS
    lib = "layer_tail" if not a8 else (
        "layer_tail_a8x2" if impl == "pallas_a8x2" else "layer_tail_a8")
    if impl == "xla":
        raise ValueError("layer_tail is a kernel: impl 'xla' runs the plain "
                         "layer")
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
    if not a8 and h2.data_ptr() % 16:
        h2 = h2.clone()                         # rows TMA loads
    qts = [o, qkv, gateup, down]
    for qt in qts:
        if qt is not None:
            check_qt_tensors(qt, dev)
    if not same_groupsize(*qts) or any(
            qt is not None and qt.x_map is not None for qt in qts):
        raise ValueError("layer_tail: one groupsize and scale dtype, no "
                         "act-order")
    lib = kernels.scaled(lib, o.scales)
    past = _past_tensor(past_len, b, dev).contiguous()
    mask = None
    if input_mask is not None:
        if input_mask.shape[0] != b or input_mask.shape[1] < attend_len:
            raise ValueError("input_mask must be [B, >= attend_len]")
        mask = input_mask.to(device=dev, dtype=torch.bool).contiguous()
        if not a8 and mask.data_ptr() % 16:
            mask = mask.clone()                 # chunks bulk-copied whole

    k_row = v_row = sin = cos = None
    if qkv is not None:
        if qkv.out_features != (heads + 2 * hkv) * d or qkv.in_features != hidden:
            raise ValueError("layer_step: qkv shape")
        input_norm = _bf16_vec(input_norm, hidden, not a8)
        sin, cos = (r.to(torch.float32).reshape(-1, d).contiguous() for r in rope)
        if sin.shape[0] not in (1, b) or cos.shape != sin.shape:
            raise ValueError("layer_step: rope rows must be [1 | B, ..., D]")
        if rows_out is None:
            k_row = torch.empty((b, 1, hkv, d), dtype=torch.bfloat16,
                                device=dev)
            v_row = torch.empty_like(k_row)
        else:
            k_row, v_row = rows_out
            for r in rows_out:
                if (r.shape != (b, 1, hkv, d) or r.dtype != torch.bfloat16
                        or not r.is_contiguous() or r.device != dev):
                    raise ValueError("layer_step: rows_out must be contiguous "
                                     "bf16 [B, 1, Hkv, D] on h's device")
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
        post_norm = _bf16_vec(post_norm, hidden, not a8)
        if (gateup.in_features != hidden or gateup.out_features != 2 * inter
                or down.out_features != hidden):
            raise ValueError("layer_tail: gate|up / down shapes")

    # scratch regions, 256-byte aligned: qkv rows, split partials, the
    # attention row, h', gate|up, (a8) the barrier counter
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
    if a8:
        gpart, gticket = fused_gemv_scratch(dev, b, widest, tickets=b * hkv)
    else:   # the barrier's counters: zeros kept in the ticket array
        gpart, gticket, ptrs[5] = fused_wg_scratch(dev, b, widest,
                                                   tickets=b * hkv)
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
    count_launch(layer_tail_a8 if a8 else layer_tail, mode,
                 f32=o.scales.dtype == torch.float32)
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
               v_scale=None, rows_out=None):
    """The whole decode layer in one K7 launch: input norm, fused qkv GEMV
    and rope (rope_sin / rope_cos [1 | B, 1, 1, D], pre-sliced), then
    ``layer_tail``. Returns (h [B, 1, hidden], k_row, v_row [B, 1, Hkv, D])
    -- the rows feed the caller's deferred commit; with ``rows_out`` (two
    contiguous bf16 [B, 1, Hkv, D] tensors) they are written there and
    returned."""
    check_matmul_impl(impl)
    if h.device.type == "cpu":
        out = layer_step_plain(h, qkv, input_norm, rope_sin, rope_cos,
                               k_cache, v_cache, past_len, attend_len, o,
                               post_norm, gateup, down, eps, heads, kv_heads,
                               head_dim, input_mask, impl, k_scale, v_scale)
        if rows_out is None:
            return out
        rows_out[0].copy_(out[1])
        rows_out[1].copy_(out[2])
        return out[0], rows_out[0], rows_out[1]
    if h.device.type != "cuda":
        raise RuntimeError(f"layer_step: unsupported device {h.device}")
    if (head_dim != HEAD_DIM or heads * head_dim != o.in_features
            or k_cache.shape[1] != kv_heads):
        raise ValueError("layer_step: heads / kv_heads disagree with o, cache")
    return _launch(h, k_cache, v_cache, past_len, attend_len, o, input_mask,
                   qkv=qkv, input_norm=input_norm, rope=(rope_sin, rope_cos),
                   post_norm=post_norm, gateup=gateup, down=down, eps=eps,
                   impl=impl, k_scale=k_scale, v_scale=v_scale,
                   rows_out=rows_out)


init_launch_counters(layer_tail, f32=True)
init_launch_counters(layer_tail_a8, f32=True)
