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
    if mask is not None:
        # query rows that see no unmasked key: the port returns 0 there
        # (the left-pad rows of row 0); compare the rest
        hidden = np.zeros((b, t), bool)
        hidden[0, :4] = True
        assert np.all(got[hidden] == 0.0)
        got, ref = got[~hidden], ref[~hidden]
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


def test_int8_cache_not_ported():
    q = torch.zeros((1, 1, 2, 64), dtype=torch.bfloat16)
    kc = torch.zeros((1, 2, 8, 64), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        attention.attend(q, kc, kc, 0, 8)


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
