"""The port's ops (plain PyTorch paths on the CPU) held against the JAX
package on the same numpy inputs. The JAX side runs its Pallas kernels in
interpret mode, as its own tests do. Kernels on the card are held against
these same plain paths by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.ops import attention as jattn
from exllama_tpu.ops import dense as jdense
from exllama_tpu.ops import norms as jnorms
from exllama_tpu.ops import quant as jquant
from exllama_tpu.ops import rope as jrope
from exllama_tpu.ops import sampling as jsampling
from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.ops import attention, dense, norms, quant, rope, sampling


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


# ---------------------------------------------------------------- q4 matmul

@pytest.mark.parametrize("m,norm,act_order,gs", [
    (1, False, False, 128),
    (1, True, False, 32),
    (7, False, True, 64),
    (7, True, True, 128),
    (40, False, False, 32),
    (40, True, True, 128),
])
def test_q4_matmul_matches_jax(m, norm, act_order, gs):
    """rtol/atol 2e-2, as tests/test_q4_matmul.py:44 (bf16 activations and
    the kernel's group-sum order vs the dequantized bf16 product)."""
    k, n = 256, 520
    rng = np.random.default_rng(m * 10 + gs + act_order)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.1
    t = gptq.quantize_matrix(w, gs, act_order, rng)
    x = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
    nw = (rng.random(k) + 0.5).astype(np.float32) if norm else None

    jqt = jgptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                  t.get("g_idx"))
    ref = np.asarray(jquant.q4_matmul(
        _jnp_bf16(x), jqt, impl="pallas_interpret",
        norm_w=None if nw is None else _jnp_bf16(nw), norm_eps=1e-6,
    ).astype(jnp.float32))
    qt = gptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                t.get("g_idx"))
    got = _np(quant.q4_matmul(_bf16(x), qt,
                              norm_w=None if nw is None else _bf16(nw)))
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


def test_q4_matmul_dispatch_by_m():
    """M <= 32 takes the GEMV wrapper, M > 32 the dequant-matmul one (on
    CPU both run their plain versions, so no launch is counted)."""
    t = gptq.quantize_matrix(np.ones((64, 16), np.float32), 32)
    qt = gptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"])
    before = (quant.q4_gemv.launches, quant.q4_dequant_matmul.launches)
    for m in (1, 32, 33):
        out = quant.q4_matmul(torch.ones((m, 64), dtype=torch.bfloat16), qt)
        assert out.shape == (m, 16)
    assert before == (quant.q4_gemv.launches,
                      quant.q4_dequant_matmul.launches)


# ---------------------------------------------------------------- attention

def _attn_case(seed, b, t, h, hkv, d, s_max):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, hkv, s_max, d)).astype(np.float32)
    vc = rng.normal(size=(b, hkv, s_max, d)).astype(np.float32)
    kn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
    vn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
    return q, kc, vc, kn, vn


@pytest.mark.parametrize("case", [
    "decode_deferred", "prefill_past", "per_row_past", "left_pad_mask",
    "gqa2_deferred", "gqa4_prefill",
])
def test_attend_matches_jax(case):
    """bf16 tolerance 2e-2: p is rounded to bf16 before the PV product on
    both sides, at different points of the online softmax."""
    b, h, hkv, d, s_max = 2, 4, 4, 64, 64
    t, past, mask, deferred = 1, 9, None, False
    if case == "decode_deferred":
        deferred = True
    elif case == "prefill_past":
        t, past = 12, 20
    elif case == "per_row_past":
        t, past = 5, np.array([3, 17], np.int32)
    elif case == "left_pad_mask":
        t, past = 10, 0
        mask = np.ones((b, s_max), bool)
        mask[0, :4] = False
    elif case == "gqa2_deferred":
        hkv, deferred, past = 2, True, 30
    elif case == "gqa4_prefill":
        h, hkv, t, past = 8, 2, 7, 11
    q, kc, vc, kn, vn = _attn_case(sum(map(ord, case)), b, t, h, hkv, d, s_max)
    attend_len = 48
    new_kv_j = (_jnp_bf16(kn), _jnp_bf16(vn)) if deferred else None
    new_kv_t = (_bf16(kn), _bf16(vn)) if deferred else None
    past_j = jnp.asarray(past, jnp.int32)
    ref = np.asarray(jattn.attend(
        _jnp_bf16(q), _jnp_bf16(kc), _jnp_bf16(vc), past_j, attend_len,
        None if mask is None else jnp.asarray(mask), impl="flash_interpret",
        new_kv=new_kv_j,
    ).astype(jnp.float32))
    past_t = past if isinstance(past, int) else torch.from_numpy(past)
    got = _np(attention.attend(
        _bf16(q), _bf16(kc), _bf16(vc), past_t, attend_len,
        None if mask is None else torch.from_numpy(mask), new_kv=new_kv_t,
    ))
    # every row, the fully left-padded ones included: both sides add the
    # pad bias after the causal mask, so those rows average V over their
    # causally visible (padding) keys
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


def test_update_kv_cache_in_place():
    kc = torch.zeros((2, 2, 8, 4), dtype=torch.bfloat16)
    vc = torch.zeros_like(kc)
    new = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    attention.update_kv_cache(kc, vc, new.bfloat16(), new.bfloat16(),
                              torch.tensor([1, 4]))
    ref = jattn.update_kv_cache(
        jnp.zeros((2, 2, 8, 4), jnp.bfloat16), jnp.zeros((2, 2, 8, 4),
                                                         jnp.bfloat16),
        jnp.asarray(new.numpy(), jnp.bfloat16),
        jnp.asarray(new.numpy(), jnp.bfloat16), jnp.asarray([1, 4]),
    )[0]
    np.testing.assert_array_equal(_np(kc), np.asarray(ref, np.float32))


def test_int8_cache_is_attended():
    """An int8 cache with its scales is taken (tests/test_torch_kvcache.py
    holds it against the JAX kernels): close to the bf16 cache of the same
    rows, at the JAX suite's limit for that (tests/test_kv_int8.py:108)."""
    rng = np.random.default_rng(2)
    q = _bf16(rng.normal(size=(1, 4, 4, 64)) * 0.5)
    new = _bf16(rng.normal(size=(2, 1, 8, 2, 64)) * 0.5)
    kc = torch.zeros((1, 2, 32, 64), dtype=torch.bfloat16)
    vc = torch.zeros_like(kc)
    attention.update_kv_cache(kc, vc, new[0], new[1], 0)
    k8, v8 = kc.to(torch.int8), vc.to(torch.int8)
    ks, vs = torch.zeros((2, 1, 2, 32))
    attention.update_kv_cache(k8, v8, new[0], new[1], 0, ks, vs)
    ref = attention.attend(q, kc, vc, 4, 32)
    got = attention.attend(q, k8, v8, 4, 32, k_scale=ks, v_scale=vs)
    assert (got.float() - ref.float()).abs().max() < 0.05
    assert not torch.equal(got, ref)


# ------------------------------------------------- dense, norm and rope

@pytest.mark.parametrize("m", [1, 3, 40])
def test_dense_matmul_matches_jax(m):
    """f32 outputs from bf16 inputs; 1e-4 relative covers the sum order."""
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 384)) * 0.05).astype(np.float32)
    ref = np.asarray(jdense.dense_matmul(
        _jnp_bf16(x), _jnp_bf16(w), impl="pallas_interpret"))
    got = dense.dense_matmul(_bf16(x), _bf16(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    w = rng.random(64).astype(np.float32) + 0.5
    ref = np.asarray(jnorms.rms_norm(_jnp_bf16(x), _jnp_bf16(w), 1e-5),
                     np.float32)
    got = _np(norms.rms_norm(_bf16(x), _bf16(w), 1e-5))
    # one bf16 ulp: the f32 mean is summed in another order
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)


def test_rope_with_ntk_alpha_matches_jax():
    d, s_max, alpha = 64, 48, 2.5
    base = 10000.0 * alpha ** (d / (d - 2))
    sj, cj = jrope.rope_tables(s_max, d, base=base, compress_pos_emb=2.0)
    st, ct = rope.rope_tables(s_max, d, base=base, compress_pos_emb=2.0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, d)).astype(np.float32)
    past = np.array([4, 30], np.int32)
    ref = jrope.apply_rope_sliced(
        _jnp_bf16(x), *jrope.slice_tables(sj, cj, jnp.asarray(past), 5))
    got = rope.apply_rope_sliced(
        _bf16(x), *rope.slice_tables(st, ct, torch.from_numpy(past), 5))
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=1e-2)
    s1, c1 = rope.slice_tables(st, ct, 7, 3)
    assert s1.shape == (1, 3, 1, d) and torch.equal(c1[0, :, 0], ct[7:10])


# ----------------------------------------------------------------- sampling

@pytest.mark.parametrize("temperature,top_k,top_p,min_p,typical", [
    (0.95, 40, 0.65, 0.0, 0.0),
    (1.3, 0, 0.9, 0.02, 0.0),
    (0.7, 20, 0.0, 0.0, 0.5),
    (1.0, 0, 0.0, 0.0, 0.0),
])
def test_filter_probs_matches_jax(temperature, top_k, top_p, min_p, typical):
    """Exactly the same tokens survive; the probabilities agree to a few
    f32 ulps (rtol 1e-6: softmax and cumsum sum in another order)."""
    rng = np.random.default_rng(top_k + int(temperature * 10))
    lg = (rng.normal(size=(3, 300)) * 3).astype(np.float32)
    ref = np.asarray(jsampling.filter_probs(
        jnp.asarray(lg), temperature, top_k, top_p, min_p, typical))
    got = sampling.filter_probs(torch.from_numpy(lg), temperature, top_k,
                                top_p, min_p, typical).numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sustain,decay", [(4, 3), (-1, 0), (20, 0)])
def test_apply_rep_penalty_matches_jax(sustain, decay):
    rng = np.random.default_rng(sustain + 7)
    seq = rng.integers(0, 50, size=(2, 16)).astype(np.int32)
    lg = rng.normal(size=(2, 50)).astype(np.float32)
    ref = np.asarray(jsampling.apply_rep_penalty(
        jnp.asarray(lg), jnp.asarray(seq), jnp.int32(11), 1.3, sustain,
        decay))
    got = sampling.apply_rep_penalty(
        torch.from_numpy(lg), torch.from_numpy(seq), 11, 1.3, sustain, decay
    ).numpy()
    np.testing.assert_array_equal(got, ref)


def test_greedy_and_sample():
    lg = np.array([[0.1, 3.0, 3.0, -1.0], [5.0, 0.0, 0.0, 0.0]], np.float32)
    got = sampling.greedy(torch.from_numpy(lg)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsampling.greedy(
        jnp.asarray(lg))))
    settings = sampling.SamplerSettings(top_k=1)
    gen = torch.Generator().manual_seed(0)
    tok, prob = sampling.sample(torch.from_numpy(lg), gen, settings)
    np.testing.assert_array_equal(tok.numpy(), [1, 0])
    np.testing.assert_allclose(prob.numpy(), [1.0, 1.0])


# ------------------------------------------ K3's split-KV decode, in plain code

SPLIT_CASES = {
    # name: (b, t, h, hkv, past, deferred, masked, kind)
    "decode_past0": (2, 1, 4, 4, 0, True, False, None),
    "decode_per_row": (2, 1, 4, 4, [30, 390], True, False, None),
    "decode_not_deferred": (1, 1, 4, 2, 200, False, False, None),
    "rows_t3_gqa4": (2, 3, 8, 2, [5, 300], False, False, None),
    "left_pad_gqa": (2, 1, 8, 2, 150, True, True, None),
    "int8_deferred": (2, 1, 4, 2, [64, 333], True, False, "int8"),
    "int4_left_pad": (2, 1, 4, 2, 250, True, True, "int4"),
}
SPLIT_S, SPLIT_LEN, SPLIT_D = 448, 400, 64


def _split_inputs(name):
    b, t, h, hkv, past, deferred, masked, kind = SPLIT_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, kc, vc, kn, vn = _attn_case(rng.integers(1 << 30), b, t, h, hkv,
                                   SPLIT_D, SPLIT_S)
    kc, vc = _bf16(kc), _bf16(vc)
    ks = vs = None
    if kind is not None:
        quant_rows = (attention.quantize_kv_rows if kind == "int8"
                      else attention.quantize_kv_rows4)
        (kc, ks), (vc, vs) = (quant_rows(c.transpose(1, 2)) for c in (kc, vc))
        kc, vc = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    mask = None
    if masked:
        mask = np.ones((b, SPLIT_S), bool)
        mask[0, :40] = False
    past_t = past if isinstance(past, int) else torch.tensor(past)
    new_kv = (_bf16(kn), _bf16(vn)) if deferred else None
    args = (_bf16(q), kc, vc, past_t, SPLIT_LEN,
            None if mask is None else torch.from_numpy(mask), new_kv, ks, vs)
    return args, past, mask


def _chunk(nsplit):
    chunk = attention.KEY_TILE * -(-SPLIT_LEN // (attention.KEY_TILE * nsplit))
    assert -(-SPLIT_LEN // chunk) == nsplit
    return chunk


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_attend_split_decomposition_is_exact(name, nsplit):
    """The split partials and their combine, in f32 with p unrounded, equal
    one softmax over all keys (and the in-flight row) computed in f64 from
    the same f32 scores, to 1e-5 of the output scale: the decomposition
    itself adds nothing but f32 sum order. Splits past a row's cursor see
    no key and must weigh nothing."""
    args, _, _ = _split_inputs(name)
    q, kc, vc, past, alen, mask, new_kv, ks, vs = args
    got = attention.attend_split_plain(*args, nsplit=nsplit,
                                       chunk=_chunk(nsplit),
                                       p_dtype=torch.float32,
                                       out_dtype=torch.float32)
    scores, ok, qf, v, vsc = attention._masked_scores(
        q, kc, vc, past, alen, mask, new_kv is not None, ks, vs)
    p_scale = torch.ones_like(scores) if vsc is None else vsc.expand_as(scores)
    if new_kv is not None:
        s_new, v_new = attention._in_flight(qf, new_kv, SPLIT_D)
        scores = torch.cat([scores, s_new], -1)
        ok = torch.cat([ok, torch.ones_like(ok[..., :1])], -1)
        p_scale = torch.cat([p_scale, torch.ones_like(p_scale[..., :1])], -1)
        v = torch.cat([v, v_new], 2)
    sd = scores.double()
    p = torch.where(ok, torch.exp(sd - sd.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, 1.0, l)
    ref = torch.einsum("bhgts,bhsd->bthgd", p * p_scale.double(), v.double())
    ref = (ref / l.permute(0, 3, 1, 2, 4)).reshape(got.shape)
    scale = ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_attend_split_matches_plain_and_jax(name, nsplit):
    """With p rounded to bf16 (against each split's own max, as K3's decode
    path does) the bf16 output stays within 2e-2 of attend_plain (rounded
    against the final max) and of the JAX package's flash attention, run in
    interpret mode as its own tests run it."""
    args, past, mask = _split_inputs(name)
    q, kc, vc, past_t, alen, mask_t, new_kv, ks, vs = args
    got = _np(attention.attend_split_plain(*args, nsplit=nsplit,
                                           chunk=_chunk(nsplit)))
    np.testing.assert_allclose(got, _np(attention.attend_plain(*args)),
                               rtol=2e-2, atol=2e-2)
    if nsplit not in (3, 7):     # one JAX run per case and split edge kind
        return
    jnp_ = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ref = np.asarray(jattn.attend(
        jnp.asarray(_np(q), jnp.bfloat16),
        jnp_(kc) if ks is not None else jnp.asarray(_np(kc), jnp.bfloat16),
        jnp_(vc) if ks is not None else jnp.asarray(_np(vc), jnp.bfloat16),
        jnp.asarray(past, jnp.int32), alen,
        None if mask is None else jnp.asarray(mask), impl="flash_interpret",
        new_kv=None if new_kv is None else tuple(
            jnp.asarray(_np(x), jnp.bfloat16) for x in new_kv),
        k_scale=None if ks is None else jnp_(ks),
        v_scale=None if vs is None else jnp_(vs),
    ).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("items,attend_len,sms", [
    (32, 2048, 132), (32, 2001, 132), (16, 2048, 132), (64, 256, 132),
    (1, 64, 132), (1, 65, 132), (4, 1, 8), (1024, 4096, 132), (3, 777, 114),
])
def test_split_plan_covers_every_key_once(items, attend_len, sms):
    """K3 decode's splits: chunks of whole 64-key tiles; the nsplit splits
    [i*chunk, (i+1)*chunk) cover [0, attend_len) once, none starts past it;
    about two work items per SM, or one split per tile where the keys run
    out."""
    nsplit, chunk = attention.split_plan(items, attend_len, sms)
    assert chunk % attention.KEY_TILE == 0 and chunk > 0
    assert nsplit * chunk >= attend_len > (nsplit - 1) * chunk
    covered = np.zeros(attend_len, int)
    for i in range(nsplit):
        covered[i * chunk:min((i + 1) * chunk, attend_len)] += 1
    assert (covered == 1).all()
    # the shortest chunk of whole tiles with which about 2 * sms items,
    # ``want`` splits a triple, cover the keys
    want = -(-2 * sms // items)
    assert want * chunk >= attend_len > want * (chunk - attention.KEY_TILE)
    assert nsplit <= want


def test_split_plan_at_llama7b():
    """7B at B = 1 (32 kv heads, one row each) past 2000 (attend_len 2048)
    on the H100's 132 SMs: 8 splits of 256 keys, 256 work items -- the
    first slice's K3 ran 32 blocks."""
    assert attention.split_plan(32, 2048, 132) == (8, 256)
    assert attention.decode_rows(1, 1) == 1


@pytest.mark.parametrize("t,g,rows", [
    (1, 1, 1), (1, 4, 4), (1, 8, 8), (3, 4, 16), (2, 8, 16), (1, 32, 16),
    (16, 1, 16), (17, 1, None), (2, 9, None), (1919, 1, None),
])
def test_decode_rows_by_shape(t, g, rows):
    """Every T = 1 step and up to 16 query rows a kv head take the decode
    path, rounded up to a power of two; more take the prefill tiles."""
    assert attention.decode_rows(t, g) == rows
