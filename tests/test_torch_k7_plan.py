"""K7 (the decode layer tail) and K6 (the fused MLP) on Hopper, on the CPU:
their plans and decompositions written out in plain code
(ops/mlp.py: fused_plan, q4_mlp_plan, fused_wg_gemv_split_plain;
ops/attn_block.py: layer_tail_plan, layer_tail_split_plain /
layer_step_split_plain with ``plan=``). Each plan covers every (phase, tile,
slab) unit once, every block's units in phase order (no unit waits on a
later phase), every key once; each GEMV phase's range-by-range f32 sums with
the kernel's combine order agree with the plain f32 product of the same
staged rows to 1e-5; the whole decomposition agrees with the port's plain
versions and with the JAX package (its Pallas kernels in interpret mode)
within 2e-2; the planted faults move the output by more than 3x that.
Tolerances are stated per test."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.ops import attention as jattn
from exllama_tpu.ops import attn_block as jab
from exllama_tpu.ops import mlp as jmlp
from exllama_tpu.ops import rope as jrope

from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.formats.gptq import unpack_qweight
from exllama_tpu_torch.ops import attn_block, mlp, rope

HIDDEN, HEADS, D, INTER = 1024, 8, 128, 1152
SMS = 132            # an H100 SXM
# Llama-7B's widths: hidden, heads, intermediate
SEVEN_B = (4096, 32, 11008)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the shapes are tiny and the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _qt_pair(k, n, gs, seed, scale=0.08):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * scale
    t = jgptq.quantize_matrix(w, gs, act_order=False, rng=rng)
    args = (t["qweight"], t["qzeros"], t["scales"], t.get("g_idx"))
    return jgptq.load_quant_tensor(*args), gptq.load_quant_tensor(*args)


def _fused_pair(parts, seed, gs):
    pairs = [_qt_pair(k, n, gs, seed + i) for i, (k, n) in enumerate(parts)]
    return (jgptq.concat_quant_tensors([p[0] for p in pairs]),
            gptq.concat_quant_tensors([p[1] for p in pairs]))


def _within(got, ref, tol, what):
    """max |got - ref| <= tol * max(1, max |ref|)."""
    got, ref = _np(got), _np(ref)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, float(np.abs(ref).max())), (what, err)


# ------------------------------------------------------------------ plans

def _k7_plan(b, hkv, attend_len, sms, qkv, mlp_on, widths=SEVEN_B):
    hidden, heads, inter = widths
    return attn_block.layer_tail_plan(b, hidden, heads, hkv,
                                      inter if mlp_on else 0, attend_len,
                                      sms, qkv=qkv)


PLANS = {
    "k6 7b M=1": lambda: mlp.q4_mlp_plan(1, 4096, 11008, SMS),
    "k6 7b M=18": lambda: mlp.q4_mlp_plan(18, 4096, 11008, SMS),
    "k6 7b M=32": lambda: mlp.q4_mlp_plan(32, 4096, 11008, SMS),
    "k6 tiny 5 SMs": lambda: mlp.q4_mlp_plan(2, HIDDEN, INTER, 5),
    "k6 fewer units than SMs": lambda: mlp.q4_mlp_plan(8, 256, 64, SMS),
    "k7 layer_step 7b B=1": lambda: _k7_plan(1, 32, 2048, SMS, True, True)[0],
    "k7 layer_tail 7b B=8 gqa8": lambda: _k7_plan(8, 8, 2048, SMS, False,
                                                  True)[0],
    "k7 attn_block_o 7b B=2": lambda: _k7_plan(2, 8, 2048, SMS, False,
                                               False)[0],
    "k7 layer_step tiny 7 SMs": lambda: _k7_plan(
        2, 2, 128, 7, True, True, (HIDDEN, HEADS, INTER))[0],
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_covers_each_unit_once_in_phase_order(name):
    """Every (phase, tile, slab) unit once; each phase's units on its
    first min(SMs, units) blocks in contiguous stream-K ranges of at most
    one unit more than another block's; each block's units in the
    producer's order run phase after phase (so no unit waits on a later
    phase's barrier); each phase's x follows one more grid barrier than the
    phase before it (and the attention barrier of K7)."""
    plan = PLANS[name]()
    units = plan.units()
    assert len(units) == plan.blocks
    for i, ph in enumerate(plan.phases):
        cover = np.zeros((ph.tiles, ph.ktiles), np.int64)
        counts = []
        for b, rs in enumerate(ph.ranges(plan.blocks)):
            if b >= ph.grid:
                assert rs == []
            n = 0
            for t, kb, ke, slot in rs:
                assert 0 <= kb < ke <= ph.ktiles
                cover[t, kb:ke] += 1
                n += ke - kb
                assert (slot is None) == (kb == 0 and ke == ph.ktiles)
            if b < ph.grid:
                counts.append(n)
        assert (cover == 1).all(), (ph.name, cover.min(), cover.max())
        assert max(counts) - min(counts) <= 1 and min(counts) >= 1
        assert ph.grid == min(plan.blocks, ph.tiles * ph.ktiles)
        assert ph.dep == i + (0 <= plan.attn_at <= i)
    assert plan.barriers() == plan.phases[-1].dep
    for b, us in enumerate(units):
        order = [i for i, _, _ in us]
        assert order == sorted(order), b
        seen = {(i, t, kt) for i, t, kt in us}
        assert len(seen) == len(us)
    total = sum(len(us) for us in units)
    assert total == sum(p.tiles * p.ktiles for p in plan.phases)


@pytest.mark.parametrize("b,hkv,past,attend_len,sms", [
    (1, 32, 2000, 2048, SMS), (8, 8, 2000, 2048, SMS), (2, 8, 17, 2048, SMS),
    (1, 2, 100, 128, 7), (32, 32, 2000, 2048, SMS), (3, 2, 0, 512, 5)])
def test_key_splits_of_the_plan_cover_each_key_once(b, hkv, past, attend_len,
                                                     sms):
    """The Hopper K7's key splits (``layer_tail_plan``'s nsplit, at most
    one a 128 keys of attend_len, items = B x Hkv x nsplit covering the
    grid where the pairs allow it): [0, min(past, attend_len)) once over,
    whole 32-key chunks but the last, in order."""
    _, nsplit = _k7_plan(b, hkv, attend_len, sms, False, True)
    assert 1 <= nsplit <= max(1, attend_len // 128)
    if b * hkv <= sms:
        assert b * hkv * nsplit <= sms or nsplit == 1
    pb = min(past, attend_len)
    splits = attn_block.key_splits(pb, nsplit)
    assert len(splits) == nsplit
    assert [s for lo, hi in splits for s in range(lo, hi)] == list(range(pb))
    assert all(lo % 32 == 0 for lo, hi in splits if hi > lo)


@pytest.mark.parametrize("fit", [4, 6, 10, 20, 32])
@pytest.mark.parametrize("b,hkv,past,attend_len,sms", [
    (1, 32, 2000, 2048, SMS), (8, 8, 2000, 2048, SMS),
    (2, 8, [17, 1500], 2048, SMS), (1, 2, 100, 128, 7),
    (3, 2, [0, 40, 512], 512, 5)])
def test_attention_ring_plan_reads_each_key_once_in_order(b, hkv, past,
                                                          attend_len, sms,
                                                          fit):
    """The Hopper K7's attention ring, with room for ``fit`` slots: the
    chunks of every block cover each (batch row, kv head)'s keys [0,
    min(past, attend_len)) once, in 16-key chunks (the last of a split
    shorter), each item's chunk c on warp c % warps (so a row's sums do
    not depend on the other rows' keys); the ring uses a multiple of its
    warps' count of slots; every
    block's chunks are all read (no chunk waits on a later one) and no warp
    waits on a slot whose previous fill another warp reads (a wait that
    could pass on the old phase)."""
    _, nsplit = _k7_plan(b, hkv, attend_len, sms, False, True)
    slots, warps = attn_block.ring_shape(fit)
    assert slots % warps == 0 and 0 < slots <= fit and warps <= 8
    blocks = attn_block.attention_ring_plan(past, attend_len, b, hkv, nsplit,
                                            sms, fit)
    pasts = [past] * b if isinstance(past, int) else past
    cover = {(bb, hk): np.zeros(attend_len, np.int64)
             for bb in range(b) for hk in range(hkv)}
    for seq in blocks:
        chunk_of_item = {}
        for item, bb, hk, k0, n, warp in seq:
            c = chunk_of_item.get(item, 0)
            chunk_of_item[item] = c + 1
            assert warp == c % warps     # the item's own chunk index alone
            assert 0 < n <= attn_block.ATT_CHUNK
            cover[bb, hk][k0:k0 + n] += 1
        assert attn_block.ring_chunks_read(seq, slots) == len(seq)
        assert attn_block.ring_waits_unsafe(seq, slots) == []
    for (bb, hk), cv in cover.items():
        pb = min(pasts[bb], attend_len)
        assert (cv[:pb] == 1).all() and (cv[pb:] == 0).all(), (bb, hk)


def test_ring_checks_see_a_stall_and_an_unsafe_wait():
    """The checks above can fail. With one slot, a producer that brings an
    item's chunk before a lower item's stalls the ring (the chunk waits for
    the block's barrier after the lower item, whose chunk waits for the
    slot); with two slots it runs. Ten slots read by eight warps in turn
    within each item (an earlier layout, which raced on the card) leave
    warp 2's chunk 10 waiting on the slot of warp 0's chunk 0."""
    seq = [(1, 0, 0, 16, 16, 0), (0, 0, 0, 0, 16, 1)]
    assert attn_block.ring_chunks_read(seq, 1) == 0
    assert attn_block.ring_chunks_read(seq, 2) == 2
    item = [(0, 0, 0, 16 * c, 16, c % 8) for c in range(32)]
    assert attn_block.ring_waits_unsafe(item, 10)[:1] == [10]
    assert attn_block.ring_waits_unsafe(item, 8) == []


# -------------------------------------------------- a GEMV phase in f32

def _dequant_f32(qt):
    """W = s * q - zs per group, f32 [K, N]."""
    k, n = qt.in_features, qt.out_features
    q = unpack_qweight(qt.qweight).to(torch.float32)
    g = torch.arange(k) // qt.groupsize
    return q * qt.scales.float()[g] - qt.zscale.float()[g]


@pytest.mark.parametrize("gs", [32, 128])
@pytest.mark.parametrize("staging", ["x", "norm", "glu"])
@pytest.mark.parametrize("m,blocks", [(1, 5), (2, SMS), (8, 7), (18, 5),
                                      (32, SMS)])
def test_phase_split_plain_matches_the_plain_product_in_f32(gs, staging, m,
                                                            blocks):
    """A GEMV phase of the Hopper K6 / K7 (the half-slab fold with the
    nibbles as 128 + q, the ranges of its plan, the cut tiles added in
    block order), unrounded, against the f32 product of the same staged
    rows with the dequantized weight: 1e-5 of the output scale (the f32
    order of the sums and the fold's cancelling 128 s term)."""
    rng = np.random.default_rng(m * 31 + blocks + gs)
    k = INTER if staging == "glu" else HIDDEN
    n = 640
    _, qt = _qt_pair(k, n, gs, 7 + gs)
    x = _bf16(rng.normal(size=(m, 2 * k if staging == "glu" else k)))
    nw = _bf16(rng.random(k) + 0.5) if staging == "norm" else None
    plan = mlp.fused_plan(m, blocks, (("p", k, n),))
    got = mlp.fused_wg_gemv_split_plain(
        x, qt, plan.phases[0], blocks, nw, 1e-6,
        glu=k if staging == "glu" else 0, out_dtype=torch.float32)
    if staging == "glu":
        xs = mlp.silu_mul(x[:, :k], x[:, k:])
    elif staging == "norm":
        xs = mlp.rms_norm(x, nw, 1e-6)
    else:
        xs = x
    ref = xs.double() @ _dequant_f32(qt).double()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    scale = ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= 1e-5 * scale


# ---------------------------------------------- the whole layer vs JAX

def _caches(kind, b, hkv, s_max, filled, rng):
    """bf16 caches, or int8 / int4 ones filled through the JAX update (the
    port's writes are bit-equal to it: tests/test_torch_kvcache.py)."""
    mag = 2.0 ** rng.integers(-2, 2, size=(b, filled, hkv, 1))
    nk = (rng.normal(size=(b, filled, hkv, D)) * mag).astype(np.float32)
    nv = (rng.normal(size=(b, filled, hkv, D)) * mag).astype(np.float32)
    if kind == "bf16":
        kc = np.zeros((b, hkv, s_max, D), np.float32)
        vc = np.zeros_like(kc)
        kc[:, :, :filled] = nk.transpose(0, 2, 1, 3)
        vc[:, :, :filled] = nv.transpose(0, 2, 1, 3)
        return (_jnp_bf16(kc), _jnp_bf16(vc), None, None), \
            (_bf16(kc), _bf16(vc), None, None)
    width = D if kind == "int8" else D // 2
    z = np.zeros((b, hkv, s_max, width), np.int8)
    s = np.zeros((b, hkv, s_max), np.float32)
    jc = jattn.update_kv_cache(jnp.asarray(z), jnp.asarray(z), _jnp_bf16(nk),
                               _jnp_bf16(nv), jnp.int32(0), jnp.asarray(s),
                               jnp.asarray(s))
    return jc, tuple(torch.from_numpy(np.array(a)) for a in jc)


K7_CASES = [
    # entry, B, Hkv (8 query heads: GQA 1 or 4), cache, groupsize, mask
    ("layer_step", 1, 8, "bf16", 128, False),
    ("layer_step", 2, 2, "int8", 128, True),
    ("layer_tail", 8, 2, "int4", 32, False),
    ("layer_tail", 1, 2, "int8", 32, False),
    ("layer_step", 8, 8, "int4", 128, True),
    ("attn_block_o", 2, 2, "bf16", 32, True),
    ("layer_tail", 2, 8, "bf16", 128, True),
    ("layer_step", 2, 2, "int4", 32, False),
]


def _k7_inputs(entry, b, hkv, kind, gs, masked):
    s_max = 128
    rng = np.random.default_rng(b * 100 + hkv * 10 + gs + len(kind + entry))
    past = np.asarray([100 - 13 * i for i in range(b)], np.int32)
    jc, pc = _caches(kind, b, hkv, s_max, 110, rng)
    t = dict(
        q=(rng.normal(size=(b, 1, HEADS, D)) * 0.5).astype(np.float32),
        kn=rng.normal(size=(b, 1, hkv, D)).astype(np.float32),
        vn=rng.normal(size=(b, 1, hkv, D)).astype(np.float32),
        h=(rng.normal(size=(b, 1, HIDDEN)) * 0.5).astype(np.float32),
        iw=(rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32),
        nw=(rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32))
    mask = None
    if masked:
        mask = np.ones((b, s_max), bool)
        mask[0, :9] = False
    w = dict(o=_qt_pair(HIDDEN, HIDDEN, gs, 2),
             gu=_fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 31, gs),
             dn=_qt_pair(INTER, HIDDEN, gs, 33),
             qkv=_fused_pair([(HIDDEN, HEADS * D), (HIDDEN, hkv * D),
                              (HIDDEN, hkv * D)], 21, gs))
    return s_max, past, jc, pc, t, mask, w


def _k7_split(entry, b, hkv, s_max, past, pc, t, mask, w, plan, nsplit,
              fault=None):
    """The port's split decomposition (``plan``) or, with plan None, its
    plain version, of ``entry``."""
    pt = torch.from_numpy(past)
    pm = None if mask is None else torch.from_numpy(mask)
    kw = dict(k_scale=pc[2], v_scale=pc[3])
    if plan is not None:
        kw.update(plan=plan, nsplit=nsplit, fault=fault)
    h, q = _bf16(t["h"]), _bf16(t["q"])
    new_kv = (_bf16(t["kn"]), _bf16(t["vn"]))
    o, gu, dn, qkv = (w[n][1] for n in ("o", "gu", "dn", "qkv"))
    if entry == "layer_step":
        st, ct = rope.slice_tables(*rope.rope_tables(s_max, D), pt, 1)
        fn = (attn_block.layer_step_split_plain if plan is not None
              else attn_block.layer_step_plain)
        return fn(h, qkv, _bf16(t["iw"]), st, ct, pc[0], pc[1], pt, s_max, o,
                  _bf16(t["nw"]), gu, dn, 1e-6, HEADS, hkv, D, pm, **kw)
    mlp_on = entry == "layer_tail"
    args = (h, q, pc[0], pc[1], pt, s_max, o,
            _bf16(t["nw"]) if mlp_on else None, gu if mlp_on else None,
            dn if mlp_on else None, 1e-6, new_kv, pm)
    if plan is not None:
        return attn_block.layer_tail_split_plain(*args, **kw)
    if mlp_on:
        return attn_block.layer_tail_plain(*args, **kw)
    return attn_block.attn_block_o_plain(h, q, pc[0], pc[1], pt, s_max, o,
                                         new_kv, pm, **kw)


def _k7_jax(entry, b, hkv, s_max, past, jc, t, mask, w):
    pj = jnp.asarray(past)
    jm = None if mask is None else jnp.asarray(mask)
    kw = dict(k_scale=jc[2], v_scale=jc[3], impl="pallas_interpret")
    o, gu, dn, qkv = (w[n][0] for n in ("o", "gu", "dn", "qkv"))
    new_kv = (_jnp_bf16(t["kn"]), _jnp_bf16(t["vn"]))
    if entry == "layer_step":
        sj, cj = jrope.slice_tables(*jrope.rope_tables(s_max, D), pj, 1)
        return jab.layer_step(
            _jnp_bf16(t["h"]), qkv, _jnp_bf16(t["iw"]), sj, cj, jc[0], jc[1],
            pj, s_max, o, _jnp_bf16(t["nw"]), gu, dn, 1e-6, HEADS, hkv, D,
            input_mask=jm, **kw)
    if entry == "layer_tail":
        return jab.layer_tail(_jnp_bf16(t["h"]), _jnp_bf16(t["q"]), jc[0],
                              jc[1], pj, s_max, o, _jnp_bf16(t["nw"]), gu, dn,
                              1e-6, new_kv, input_mask=jm, **kw)
    return jab.attn_block_o(_jnp_bf16(t["h"]), _jnp_bf16(t["q"]), jc[0], jc[1],
                            pj, s_max, o, new_kv, input_mask=jm, **kw)


@pytest.mark.parametrize("entry,b,hkv,kind,gs,masked", K7_CASES)
def test_k7_split_plain_matches_plain_and_jax(entry, b, hkv, kind, gs,
                                              masked):
    """The Hopper K7's decomposition (its plan on 7 SMs: tiles cut between
    blocks; the plan's key splits) against the port's plain version and the
    JAX layer_tail / layer_step / attn_block_o kernels in interpret mode:
    2e-2 of max(1, |ref|) each (K7's limit on the card: the bf16 rounding
    of p at a split's own max, the sum orders), the K/V rows of layer_step
    likewise."""
    s_max, past, jc, pc, t, mask, w = _k7_inputs(entry, b, hkv, kind, gs,
                                                 masked)
    mlp_on = entry != "attn_block_o"
    plan, nsplit = attn_block.layer_tail_plan(
        b, HIDDEN, HEADS, hkv, INTER if mlp_on else 0, s_max, 7,
        qkv=entry == "layer_step")
    got = _k7_split(entry, b, hkv, s_max, past, pc, t, mask, w, plan, nsplit)
    ref = _k7_split(entry, b, hkv, s_max, past, pc, t, mask, w, None, None)
    jref = _k7_jax(entry, b, hkv, s_max, past, jc, t, mask, w)
    if entry == "layer_step":
        for i in (1, 2):
            _within(got[i], ref[i], 2e-2, "k/v rows vs plain")
            _within(got[i], jref[i], 2e-2, "k/v rows vs jax")
        got, ref, jref = got[0], ref[0], jref[0]
    assert got.shape == (b, 1, HIDDEN) and got.dtype == torch.bfloat16
    _within(got, ref, 2e-2, "vs plain")
    _within(got, jref, 2e-2, "vs jax")


@pytest.mark.parametrize("gs", [32, 128])
@pytest.mark.parametrize("m", [1, 2, 8, 18, 32])
def test_k6_split_plain_matches_plain_and_jax(m, gs):
    """The Hopper K6's decomposition (its plan on 5 SMs and on an H100's
    132) against the port's plain q4_mlp and the JAX q4_mlp kernel in
    interpret mode: 2e-2 of max(1, |ref|) (K6's limit on the card)."""
    rng = np.random.default_rng(m + gs)
    h = (rng.normal(size=(m, HIDDEN)) * 0.5).astype(np.float32)
    nw = (rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32)
    jgu, pgu = _fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 3, gs)
    jdn, pdn = _qt_pair(INTER, HIDDEN, gs, 5)
    jref = jmlp.q4_mlp(_jnp_bf16(h), _jnp_bf16(nw), jgu, jdn, 1e-6,
                       impl="pallas_interpret")
    ref = mlp.q4_mlp_plain(_bf16(h), _bf16(nw), pgu, pdn, 1e-6)
    for sms in (5, SMS):
        plan = mlp.q4_mlp_plan(m, HIDDEN, INTER, sms)
        got = mlp.q4_mlp_split_plain(_bf16(h), _bf16(nw), pgu, pdn, 1e-6,
                                     plan=plan)
        assert got.shape == (m, HIDDEN) and got.dtype == torch.bfloat16
        _within(got, ref, 2e-2, "vs plain")
        _within(got, jref, 2e-2, "vs jax")


# ---------------------------------------------------------- planted faults

def _moves(clean, bad, tol):
    scale = max(1.0, float(np.abs(_np(clean)).max()))
    return float(np.abs(_np(bad) - _np(clean)).max()) > 3 * tol * scale


@pytest.mark.parametrize("fault", ["silu_up", "residual_twice"])
@pytest.mark.parametrize("kernel", ["k6", "k7"])
def test_planted_faults_move_the_split_output(kernel, fault):
    """silu applied to up instead of gate, and the residual added twice,
    each move the Hopper decomposition's output by more than 3x the 2e-2
    limit (of max(1, |out|)), so a kernel with either could not pass the
    card's checks. The residual (std 4) is on the MLP's scale here, as in
    a model, where it dominates."""
    if kernel == "k6":
        rng = np.random.default_rng(11)
        h = _bf16(rng.normal(size=(2, HIDDEN)) * 4.0)
        nw = _bf16(rng.normal(size=(HIDDEN,)) * 0.2 + 1.0)
        _, pgu = _fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 3, 128)
        _, pdn = _qt_pair(INTER, HIDDEN, 128, 5)
        plan = mlp.q4_mlp_plan(2, HIDDEN, INTER, 7)
        clean = mlp.q4_mlp_split_plain(h, nw, pgu, pdn, 1e-6, plan=plan)
        bad = mlp.q4_mlp_split_plain(h, nw, pgu, pdn, 1e-6, plan=plan,
                                     fault=fault)
    else:
        s_max, past, _, pc, t, mask, w = _k7_inputs("layer_tail", 2, 2,
                                                    "bf16", 128, False)
        t["h"] = t["h"] * 8.0
        plan, nsplit = attn_block.layer_tail_plan(2, HIDDEN, HEADS, 2, INTER,
                                                  s_max, 7)
        clean = _k7_split("layer_tail", 2, 2, s_max, past, pc, t, mask, w,
                          plan, nsplit)
        bad = _k7_split("layer_tail", 2, 2, s_max, past, pc, t, mask, w,
                        plan, nsplit, fault=fault)
    assert _moves(clean, bad, 2e-2)


def test_dropped_pad_bias_moves_the_attention_output():
    """With h = 0 (the output is o-proj(attention) alone), a peaked softmax
    (q x4) and the padded keys of row 0 planted to score 8 above its best
    real key, leaving out the pad bias moves the Hopper decomposition's
    attn_block_o output by more than 3x the 2e-2 limit of its scale; with
    the bias it stays within 2e-2 of the plain attention."""
    b, hkv, s_max, past, n_pad = 2, 2, 256, 200, 9
    g = HEADS // hkv
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(b, 1, HEADS, D)) * 4.0).float()
    kc = torch.from_numpy(rng.normal(size=(b, hkv, s_max, D))).float()
    vc = _bf16(rng.normal(size=(b, hkv, s_max, D)))
    qg = q.reshape(b, hkv, g, D)
    u = qg.sum(2)
    u = u / u.norm(dim=-1, keepdim=True)
    per_unit = (qg * u[:, :, None]).sum(-1) / math.sqrt(D)
    best = (torch.einsum("bhgd,bhsd->bhgs", qg, kc[:, :, n_pad:past])
            / math.sqrt(D)).amax((2, 3))
    a = (best[0] + 8) / per_unit[0].amin(1)
    kc[0, :, :n_pad] = a[:, None, None] * u[0][:, None, :]
    q, kc = q.bfloat16(), kc.bfloat16()
    new_kv = (_bf16(rng.normal(size=(b, 1, hkv, D))),
              _bf16(rng.normal(size=(b, 1, hkv, D))))
    mask = torch.ones((b, s_max), dtype=torch.bool)
    mask[0, :n_pad] = False
    _, po = _qt_pair(HIDDEN, HIDDEN, 128, 2)
    h = torch.zeros((b, 1, HIDDEN), dtype=torch.bfloat16)
    plan, nsplit = attn_block.layer_tail_plan(b, HIDDEN, HEADS, hkv, 0, s_max,
                                              7)
    args = (h, q, kc, vc, past, s_max, po, None, None, None, 1e-6, new_kv)
    clean = attn_block.layer_tail_split_plain(*args, mask, plan=plan,
                                              nsplit=nsplit)
    bad = attn_block.layer_tail_split_plain(*args, None, plan=plan,
                                            nsplit=nsplit)
    ref = attn_block.attn_block_o_plain(h, q, kc, vc, past, s_max, po, new_kv,
                                        mask)
    scale = ref.float().abs().max().item()
    assert (clean.float() - ref.float()).abs().max().item() <= 2e-2 * scale
    assert (bad.float() - clean.float()).abs().max().item() > 3 * 2e-2 * scale
