"""The port's quantized KV cache -- int8, packed int4, padded head_dim --
held against the JAX package on the same numpy inputs: row quantization,
cache writes, the deferred commit and the cache operations bit for bit;
attention (K3's plain version) and the fused decode layer (K7's) against the
JAX kernels in interpret mode. The port runs its plain PyTorch versions on
the CPU. Widths are lane-full (head_dim 128, hidden 1024) where a JAX kernel
runs in interpret mode. The whole model and ``model_init`` are in
tests/test_torch_kvcache_model.py."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.cache import KVCacheState
from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.ops import attention as jattn
from exllama_tpu.ops import attn_block as jab
from exllama_tpu.ops import rope as jrope

import exllama_tpu_torch as port
from exllama_tpu_torch.cache import stored_head_dim
from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.ops import attention, attn_block, rope

D = 128
QUANT = {"int8": (jattn.quantize_kv_rows, attention.quantize_kv_rows),
         "int4": (jattn.quantize_kv_rows4, attention.quantize_kv_rows4)}


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _same(got: torch.Tensor, ref):
    """Bit-equal, dtype included (int8 bytes or f32 scales)."""
    ref = np.asarray(ref)
    assert got.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def _rows(rng, *shape):
    """bf16-representable rows with the awkward ones among them: an
    all-zero row (the 1e-8 floor of the scale), a row whose values sit on
    the half-way points of its own int8 and int4 grids (round half to even),
    and a row with one large outlier."""
    x = np.asarray(_jnp_bf16(rng.normal(size=shape)), np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    d = shape[-1]
    half_way = ((np.arange(d) % 14 - 7) + 0.5) * 0.5    # (k + 0.5) * 0.5
    flat[1] = half_way
    flat[1, 0] = 63.5                             # int8 scale 63.5 / 127 = 0.5
    flat[2] = half_way
    flat[2, 0] = 3.5                              # int4 scale 3.5 / 7 = 0.5
    flat[3, 5] = 40.0
    return np.asarray(_jnp_bf16(x), np.float32)


# ------------------------------------------------------- row quantization

@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_kv_rows_bit_equal_to_jax(kind):
    """Same rows, same bytes and same f32 scales: a true f32 division and
    round half to even on both sides."""
    jq, tq = QUANT[kind]
    x = _rows(np.random.default_rng(3), 2, 5, 3, D)
    ref_q, ref_s = jq(_jnp_bf16(x))
    got_q, got_s = tq(_bf16(x))
    assert got_q.shape[-1] == (D if kind == "int8" else D // 2)
    _same(got_q, ref_q)
    _same(got_s, ref_s)
    # the all-zero row takes the 1e-8 floor; ties were among the inputs
    assert got_s.reshape(-1)[0] == np.float32(1e-8) / np.float32(
        127 if kind == "int8" else 7)
    ratio = x.reshape(-1, D)[1 if kind == "int8" else 2] / 0.5
    assert (np.abs(ratio - np.floor(ratio) - 0.5) < 1e-6).any()


def test_unpack_kv4_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    packed = rng.integers(-128, 128, size=(2, 3, 7, D // 2)).astype(np.int8)
    for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float32,
                                                     torch.float32)):
        ref = np.asarray(jattn.unpack_kv4(jnp.asarray(packed), jd), np.float32)
        got = attention.unpack_kv4(torch.from_numpy(packed), td)
        assert got.shape == (2, 3, 7, D) and got.dtype == td
        np.testing.assert_array_equal(_np(got), ref)
    # and it inverts the packing
    x = _rows(rng, 1, 4, 2, D)
    q, s = attention.quantize_kv_rows4(_bf16(x))
    raw = attention.unpack_kv4(q, torch.float32)
    want = torch.round(_bf16(x).float() / s[..., None]).clamp(-7, 7)
    assert torch.equal(raw, want)


# ----------------------------------------------------------- cache writes

def _empty_caches(kind, b, hkv, s_max, d=D):
    dc = d // 2 if kind == "int4" else d
    z = np.zeros((b, hkv, s_max, dc), np.int8)
    s = np.zeros((b, hkv, s_max), np.float32)
    return z, s


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_update_kv_cache_quantized_bit_equal_to_jax(kind, per_row):
    rng = np.random.default_rng(5 + per_row)
    b, hkv, s_max, t = 2, 3, 16, 4
    z, s = _empty_caches(kind, b, hkv, s_max)
    nk, nv = _rows(rng, b, t, hkv, D), _rows(rng, b, t, hkv, D)
    past = np.asarray([0, 9], np.int32) if per_row else 5
    ref = jattn.update_kv_cache(
        jnp.asarray(z), jnp.asarray(z), _jnp_bf16(nk), _jnp_bf16(nv),
        jnp.asarray(past, jnp.int32), jnp.asarray(s), jnp.asarray(s))
    tens = [torch.from_numpy(a.copy()) for a in (z, z, s, s)]
    out = attention.update_kv_cache(
        tens[0], tens[1], _bf16(nk), _bf16(nv),
        torch.from_numpy(past) if per_row else past, tens[2], tens[3])
    for got, held, want in zip(out, tens, ref):
        assert got is held                      # in place
        _same(got, want)
    assert tens[2].abs().sum() > 0


def test_update_kv_cache_bf16_returns_no_scales():
    kc = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)
    new = torch.ones((1, 3, 2, 16), dtype=torch.bfloat16)
    out = attention.update_kv_cache(kc, kc.clone(), new, new, 2)
    assert out[0] is kc and out[2] is None and out[3] is None
    assert kc[0, :, 2:5].eq(1).all() and kc[0, :, 5:].eq(0).all()
    with pytest.raises(ValueError):             # an int8 cache needs scales
        attention.update_kv_cache(kc.to(torch.int8), kc.to(torch.int8), new,
                                  new, 2)


# --------------------------------------------------------------- attention

def _quantized_case(kind, seed, b, t, h, hkv, s_max, filled):
    """q, and caches filled through the JAX update (bit-equal to the
    port's, see above) with rows whose magnitudes differ by up to x8, so the
    per-key scales matter."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, D)).astype(np.float32)
    mag = 2.0 ** rng.integers(-2, 2, size=(b, filled, hkv, 1))
    nk = (rng.normal(size=(b, filled, hkv, D)) * mag).astype(np.float32)
    mag = 2.0 ** rng.integers(-2, 2, size=(b, filled, hkv, 1))
    nv = (rng.normal(size=(b, filled, hkv, D)) * mag).astype(np.float32)
    z, s = _empty_caches(kind, b, hkv, s_max)
    kc, vc, ks, vs = jattn.update_kv_cache(
        jnp.asarray(z), jnp.asarray(z), _jnp_bf16(nk), _jnp_bf16(nv),
        jnp.int32(0), jnp.asarray(s), jnp.asarray(s))
    kn = rng.normal(size=(b, 1, hkv, D)).astype(np.float32)
    vn = rng.normal(size=(b, 1, hkv, D)).astype(np.float32)
    return q, (kc, vc, ks, vs), kn, vn


def _torch_caches(jc):
    return [torch.from_numpy(np.array(a)) for a in jc]


@pytest.mark.parametrize("case", ["decode_deferred", "prefill_t4",
                                  "gqa_deferred", "left_pad_mask"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_attend_quantized_matches_jax(kind, case):
    """Against the JAX flash kernels in interpret mode at the port's bf16
    attend tolerance (rtol = atol = 2e-2: the same integers and scales on
    both sides; p is rounded to bf16 at other points of the online softmax),
    and against ``impl="xla"``, which dequantizes K and V to bf16 first, at
    the JAX suite's own 0.03 (tests/test_kv_int8.py:240) of the output scale
    (V rows reach x2 here, so one bf16 step of an output is 0.031)."""
    b, t, h, hkv, s_max, attend_len = 2, 1, 4, 4, 64, 48
    past, mask, deferred = 30, None, False
    if case == "decode_deferred":
        deferred = True
    elif case == "prefill_t4":
        t, past = 4, 21
    elif case == "gqa_deferred":
        h, hkv, deferred, past = 8, 2, True, np.array([7, 33], np.int32)
    elif case == "left_pad_mask":
        t, past = 10, 0
        mask = np.ones((b, s_max), bool)
        mask[0, :4] = False
    q, jc, kn, vn = _quantized_case(
        kind, sum(map(ord, kind + case)), b, t, h, hkv, s_max, 44)
    kc, vc, ks, vs = _torch_caches(jc)
    past_t = past if isinstance(past, int) else torch.from_numpy(past)
    got = _np(attention.attend(
        _bf16(q), kc, vc, past_t, attend_len,
        None if mask is None else torch.from_numpy(mask),
        (_bf16(kn), _bf16(vn)) if deferred else None, ks, vs))
    out_scale = max(1.0, float(np.abs(got).max()))
    for impl, kw in (("flash_interpret", dict(rtol=2e-2, atol=2e-2)),
                     ("xla", dict(rtol=0, atol=0.03 * out_scale))):
        ref = np.asarray(jattn.attend(
            _jnp_bf16(q), jc[0], jc[1], jnp.asarray(past, jnp.int32),
            attend_len, None if mask is None else jnp.asarray(mask),
            impl=impl, k_scale=jc[2], v_scale=jc[3],
            new_kv=(_jnp_bf16(kn), _jnp_bf16(vn)) if deferred else None,
        ).astype(jnp.float32))
        if impl == "xla" and mask is not None:
            # attend_xla gives a fully padded query row a uniform average
            # over the whole window; the flash kernels (and the port)
            # average over its causally visible keys
            ref, cmp = ref[:, 4:], got[:, 4:]
        else:
            cmp = got
        np.testing.assert_allclose(cmp, ref, **kw)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_attend_quantized_uses_both_scales_and_both_halves(kind):
    """The faults a kernel could make move the plain output by far more
    than the tolerance: the per-key K scales or V scales replaced by their
    mean, and (int4) the two halves of the head swapped."""
    b, t, h, hkv, s_max = 1, 1, 4, 4, 64
    q, jc, kn, vn = _quantized_case(kind, 11, b, t, h, hkv, s_max, 44)
    kc, vc, ks, vs = _torch_caches(jc)
    args = (_bf16(q), kc, vc, 40, 48, None, (_bf16(kn), _bf16(vn)))
    ref = _np(attention.attend(*args, ks, vs))

    def flat(s):
        out = s.clone()
        out[:, :, :44] = s[:, :, :44].mean(dim=2, keepdim=True)
        return out

    faults = [_np(attention.attend(*args, flat(ks), vs)),
              _np(attention.attend(*args, ks, flat(vs)))]
    if kind == "int4":
        raw = attention.unpack_kv4(vc, torch.float32)
        swapped = torch.cat([raw[..., D // 2:], raw[..., :D // 2]], -1)
        b4 = (swapped[..., :D // 2].to(torch.int32) + 8) | (
            ((swapped[..., D // 2:].to(torch.int32) + 8) ^ 8) << 4)
        b4 = torch.where(b4 >= 128, b4 - 256, b4).to(torch.int8)
        faults.append(_np(attention.attend(*args[:2], b4, *args[3:], ks, vs)))
    for out in faults:
        assert np.abs(out - ref).max() > 3 * 2e-2 * np.abs(ref).max()


def test_attend_rejects_a_cache_without_its_scales():
    q = torch.zeros((1, 1, 2, 64), dtype=torch.bfloat16)
    kc = torch.zeros((1, 2, 8, 64), dtype=torch.int8)
    s = torch.zeros((1, 2, 8), dtype=torch.float32)
    with pytest.raises(ValueError):
        attention.attend(q, kc, kc, 0, 8)
    with pytest.raises(ValueError):             # neither D nor D/2 wide
        attention.attend(q, kc[..., :48], kc[..., :48], 0, 8, k_scale=s,
                         v_scale=s)
    assert attention.kv_mode(kc, 64, s) == 1
    assert attention.kv_mode(kc, 128, s) == 2
    assert attention.kv_mode(kc.to(torch.bfloat16), 64, None) == 0


# ------------------------------------------------------------------ commit

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_commit_kv_cache_quantized_bit_equal_to_jax(kind, impl):
    """L = 3 layers' bf16 rows quantized into their caches and scale
    tensors: bit-equal to the JAX package's per-layer writes and to its
    commit kernel in interpret mode (head_dim 256 for int4, whose packed
    rows must be lane-full for that kernel to run)."""
    d = 256 if kind == "int4" else 128
    n_layers, b, hkv, s_max, past = 3, 2, 2, 128, 37
    rng = np.random.default_rng(17)
    dc = d // 2 if kind == "int4" else d
    caches = rng.integers(-128, 128, size=(2 * n_layers, b, hkv, s_max, dc)
                          ).astype(np.int8)
    scales = rng.random(size=(2 * n_layers, b, hkv, s_max)).astype(np.float32)
    nk = _rows(rng, n_layers, b, 1, hkv, d)
    nv = _rows(rng, n_layers, b, 1, hkv, d)
    ref = jattn.commit_kv_cache(
        tuple(jnp.asarray(c) for c in caches[:n_layers]),
        tuple(jnp.asarray(c) for c in caches[n_layers:]),
        _jnp_bf16(nk), _jnp_bf16(nv), jnp.int32(past),
        tuple(jnp.asarray(s) for s in scales[:n_layers]),
        tuple(jnp.asarray(s) for s in scales[n_layers:]),
        impl=impl, interpret=True)
    ct = [torch.from_numpy(c.copy()) for c in caches]
    st = [torch.from_numpy(s.copy()) for s in scales]
    out = attention.commit_kv_cache(
        ct[:n_layers], ct[n_layers:], _bf16(nk), _bf16(nv), past,
        st[:n_layers], st[n_layers:], impl=impl)
    for got, want in zip(out, ref):
        for li in range(n_layers):
            _same(got[li], want[li])
    assert not np.array_equal(ct[0].numpy(), caches[0])


def test_commit_kv_cache_per_row_cursors_and_row_lists():
    """A [B] cursor takes the plain writes under any impl; the rows may be a
    list of per-layer tensors."""
    n_layers, b, hkv, s_max = 2, 2, 2, 16
    rng = np.random.default_rng(19)
    z, s = _empty_caches("int8", b, hkv, s_max)
    nk = _rows(rng, n_layers, b, 1, hkv, D)
    nv = _rows(rng, n_layers, b, 1, hkv, D)
    past = np.asarray([3, 11], np.int32)
    ref = jattn.commit_kv_cache(
        (jnp.asarray(z),) * n_layers, (jnp.asarray(z),) * n_layers,
        _jnp_bf16(nk), _jnp_bf16(nv), jnp.asarray(past),
        (jnp.asarray(s),) * n_layers, (jnp.asarray(s),) * n_layers,
        impl="pallas", interpret=True)
    mk = lambda a: [torch.from_numpy(a.copy()) for _ in range(n_layers)]  # noqa: E731
    out = attention.commit_kv_cache(
        mk(z), mk(z), list(_bf16(nk)), list(_bf16(nv)),
        torch.from_numpy(past), mk(s), mk(s), impl="pallas")
    for got, want in zip(out, ref):
        for li in range(n_layers):
            _same(got[li], want[li])


# ------------------------------------------------------- K7 layer tail

HIDDEN, HEADS, INTER = 1024, 8, 1152


def _qt_pair(k, n, gs, seed, scale=0.08):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * scale
    t = jgptq.quantize_matrix(w, gs, act_order=False, rng=rng)
    args = (t["qweight"], t["qzeros"], t["scales"], t.get("g_idx"))
    return jgptq.load_quant_tensor(*args), gptq.load_quant_tensor(*args)


def _fused_pair(parts, seed, gs=128):
    pairs = [_qt_pair(k, n, gs, seed + i) for i, (k, n) in enumerate(parts)]
    return (jgptq.concat_quant_tensors([p[0] for p in pairs]),
            gptq.concat_quant_tensors([p[1] for p in pairs]))


@pytest.mark.parametrize("entry,b,hkv,past,masked", [
    ("attn_block_o", 1, 8, 40, False),
    ("layer_tail", 2, 2, [40, 64], True),
    ("layer_step", 1, 8, 100, False),
    ("layer_step", 3, 2, [20, 7, 100], False),
])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_layer_tail_entry_points_quantized_match_jax(kind, entry, b, hkv,
                                                     past, masked):
    """The three K7 entry points over a quantized cache against the JAX
    kernel in interpret mode: atol 0.03 of max(1, |ref|), the JAX suite's
    own tolerance for this kernel (tests/test_attn_block.py), as
    tests/test_torch_fused.py holds the bf16 cache."""
    s_max = attend_len = 128
    seed = len(entry) * 5 + b + hkv + len(kind)
    q, jc, kn, vn = _quantized_case(kind, seed, b, 1, HEADS, hkv, s_max, 110)
    q = q * 0.5
    rng = np.random.default_rng(seed + 1)
    h = (rng.normal(size=(b, 1, HIDDEN)) * 0.5).astype(np.float32)
    iw = (rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32)
    nw = (rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32)
    jo, po = _qt_pair(HIDDEN, HIDDEN, 128, 2)
    jgu, pgu = _fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 31)
    jdn, pdn = _qt_pair(INTER, HIDDEN, 128, 33)
    jqkv, pqkv = _fused_pair([(HIDDEN, HEADS * D), (HIDDEN, hkv * D),
                              (HIDDEN, hkv * D)], 21)
    kc, vc, ks, vs = _torch_caches(jc)
    past_np = np.asarray(past, np.int32)
    pj = jnp.asarray(past_np)
    pt = past if isinstance(past, int) else torch.from_numpy(past_np)
    mask = None
    if masked:
        mask = np.ones((b, s_max), bool)
        mask[0, :9] = False
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask)
    jkw = dict(input_mask=mj, k_scale=jc[2], v_scale=jc[3],
               impl="pallas_interpret")
    tkw = dict(input_mask=mt, k_scale=ks, v_scale=vs)
    if entry == "attn_block_o":
        ref = jab.attn_block_o(_jnp_bf16(h), _jnp_bf16(q), jc[0], jc[1], pj,
                               attend_len, jo, (_jnp_bf16(kn), _jnp_bf16(vn)),
                               **jkw)
        got = attn_block.attn_block_o(_bf16(h), _bf16(q), kc, vc, pt,
                                      attend_len, po, (_bf16(kn), _bf16(vn)),
                                      **tkw)
    elif entry == "layer_tail":
        ref = jab.layer_tail(_jnp_bf16(h), _jnp_bf16(q), jc[0], jc[1], pj,
                             attend_len, jo, _jnp_bf16(nw), jgu, jdn, 1e-6,
                             (_jnp_bf16(kn), _jnp_bf16(vn)), **jkw)
        got = attn_block.layer_tail(_bf16(h), _bf16(q), kc, vc, pt,
                                    attend_len, po, _bf16(nw), pgu, pdn, 1e-6,
                                    (_bf16(kn), _bf16(vn)), **tkw)
    else:
        sj, cj = jrope.slice_tables(*jrope.rope_tables(s_max, D), pj, 1)
        st, ct = rope.slice_tables(*rope.rope_tables(s_max, D), pt, 1)
        ref, kj, vj = jab.layer_step(
            _jnp_bf16(h), jqkv, _jnp_bf16(iw), sj, cj, jc[0], jc[1], pj,
            attend_len, jo, _jnp_bf16(nw), jgu, jdn, 1e-6, HEADS, hkv, D,
            **jkw)
        got, kt, vt = attn_block.layer_step(
            _bf16(h), pqkv, _bf16(iw), st, ct, kc, vc, pt, attend_len, po,
            _bf16(nw), pgu, pdn, 1e-6, HEADS, hkv, D, **tkw)
        for a, r in ((kt, kj), (vt, vj)):       # the rows stay bf16
            assert a.shape == (b, 1, hkv, D) and a.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(a), _np(r), rtol=0, atol=0.03 * max(
                1.0, float(np.abs(_np(r)).max())))
    assert got.shape == (b, 1, HIDDEN) and got.dtype == torch.bfloat16
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=0.03 * max(1.0, float(np.abs(ref).max())))


# -------------------------------------------------------- cache operations

def _fake_model(kind, pad=False, head_dim=D, layers=2, hkv=2):
    cfg = port.ExLlamaConfig()
    cfg.num_hidden_layers, cfg.num_key_value_heads = layers, hkv
    cfg.head_dim, cfg.max_seq_len = head_dim, 16
    cfg.tuning.kv_cache_dtype = kind
    cfg.tuning.pad_head_dim = pad
    return types.SimpleNamespace(config=cfg, device=torch.device("cpu"))


def _cache_pair(kind, batch, seed, layers=2, hkv=2, s_max=16):
    """A JAX cache and a port cache holding the same random bytes."""
    jdtype = {"bf16": jnp.bfloat16, "int8": jnp.int8, "int4": "int4"}[kind]
    jc = JaxCache(shape=(layers, batch, s_max, hkv, D), dtype=jdtype)
    pc = port.ExLlamaCache(_fake_model(kind, layers=layers, hkv=hkv),
                           batch_size=batch)
    rng = np.random.default_rng(seed)
    state = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        held = getattr(pc, name)
        if held is None:
            assert getattr(jc.state, name) is None
            state[name] = None
            continue
        arrays = []
        for li, t in enumerate(held):
            assert tuple(t.shape) == getattr(jc.state, name)[li].shape
            if t.dtype == torch.int8:
                a = rng.integers(-128, 128, size=tuple(t.shape)).astype(np.int8)
                t.copy_(torch.from_numpy(a))
                arrays.append(jnp.asarray(a))
            else:
                a = rng.normal(size=tuple(t.shape)).astype(np.float32)
                t.copy_(torch.from_numpy(a))      # rounds to bf16 if bf16
                # a copy: jnp.asarray may alias the tensor's own memory
                arrays.append(jnp.asarray(np.array(_np(t)), getattr(
                    jc.state, name)[li].dtype))
        state[name] = tuple(arrays)
    jc.state = KVCacheState(**state)
    jc.current_seq_len = pc.current_seq_len = 9
    return jc, pc


def _assert_caches_equal(pc, jc):
    for name in ("k", "v", "k_scale", "v_scale"):
        held, ref = getattr(pc, name), getattr(jc.state, name)
        assert (held is None) == (ref is None), name
        for t, r in zip(held or (), ref or ()):
            np.testing.assert_array_equal(_np(t), np.asarray(r, np.float32))
    assert pc.current_seq_len == jc.current_seq_len


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cache_clone_roll_left_zero_match_jax(kind):
    jc, pc = _cache_pair(kind, 2, seed=23)
    ptrs = pc.kv_ptrs.tolist()
    assert len(ptrs) == (4 if kind == "bf16" else 8)
    assert ptrs == [t.data_ptr() for ts in pc._tensor_lists() for t in ts]
    jclone, pclone = jc.clone(), pc.clone()
    pclone.roll_left()
    jclone.roll_left()
    _assert_caches_equal(pclone, jclone)
    _assert_caches_equal(pc, jc)                 # the original is untouched
    assert pc.kv_ptrs.tolist() == ptrs           # and nothing moved
    assert pclone.kv_ptrs.tolist() != ptrs
    pc.roll_left()
    jc.roll_left()
    _assert_caches_equal(pc, jc)
    assert pc.kv_ptrs.tolist() == ptrs           # rolled in place
    pc.zero()
    jc.zero()
    _assert_caches_equal(pc, jc)
    assert pc.current_seq_len == 0 and pc.kv_ptrs.tolist() == ptrs


@pytest.mark.parametrize("rect", [
    # from_column, from_columns, to_column, to_columns, from_row, from_rows,
    # to_row, to_rows
    (2, 5, 7, 5, 0, 1, 0, 1),       # plain rectangle
    (0, 6, 3, 6, 1, 1, 0, 3),       # one row broadcast over three
    (4, 1, 2, 9, 0, 3, 0, 3),       # one column broadcast over nine
    (5, 1, 0, 4, 2, 1, 1, 2),       # both
])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cache_copy_states_matches_jax(kind, rect):
    jsrc, psrc = _cache_pair(kind, 3, seed=29)
    jdst, pdst = _cache_pair(kind, 3, seed=31)
    ptrs = pdst.kv_ptrs.tolist()
    jsrc.copy_states(jdst, *rect)
    psrc.copy_states(pdst, *rect)
    _assert_caches_equal(pdst, jdst)
    _assert_caches_equal(psrc, jsrc)
    assert pdst.kv_ptrs.tolist() == ptrs         # written in place
    with pytest.raises(ValueError):
        psrc.copy_states(pdst, 0, 2, 0, 3)


@pytest.mark.parametrize("kind,pad,head_dim,want", [
    ("bf16", False, 100, 100), ("bf16", True, 100, 128),
    ("int8", True, 100, 128), ("int4", True, 100, 50),
    ("bf16", True, 48, 64), ("bf16", True, 64, 64), ("int8", True, 128, 128),
    ("bf16", True, 160, 256),
])
def test_cache_storage_width_and_bytes_match_jax(kind, pad, head_dim, want):
    """The stored head width (cache.py:124-134) and the tensors' bytes."""
    assert stored_head_dim(head_dim, kind, pad) == want
    model = _fake_model(kind, pad, head_dim)
    pc = port.ExLlamaCache(model)
    jm = types.SimpleNamespace(config=types.SimpleNamespace(
        num_hidden_layers=2, num_key_value_heads=2, head_dim=head_dim,
        max_seq_len=16, batch_size=1,
        tuning=types.SimpleNamespace(kv_cache_dtype=kind, pad_head_dim=pad)))
    jc = JaxCache(jm)
    assert tuple(pc.k[0].shape) == jc.state.k[0].shape == (1, 2, 16, want)
    assert (pc.k_scale is None) == (jc.state.k_scale is None)
    elem = 2 if kind == "bf16" else 1
    scale_bytes = 0 if kind == "bf16" else 2 * 2 * 2 * 16 * 4
    assert pc.nbytes() == 2 * 2 * 2 * 16 * want * elem + scale_bytes
