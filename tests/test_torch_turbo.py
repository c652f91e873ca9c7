"""The port's W4A8 turbo and fused-GLU matmul modes -- K9 q4_gemv_a8 (a8,
a8x2; alone and inside K6 / K7), the resident int8 image, K10 q4_prefill_a8,
K11 w8_matmul, K12 q4_matmul_glu -- held against the JAX package on the same
numpy inputs. The port runs its plain PyTorch versions on the CPU; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_q4_matmul.py
does. Tolerances are max |difference| over max |reference| unless a test
says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _planted

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models import llama as jllama
from exllama_tpu.ops import attn_block as jab
from exllama_tpu.ops import mlp as jmlp
from exllama_tpu.ops import quant as jquant
from exllama_tpu.ops import rope as jrope

import exllama_tpu_torch as port
from exllama_tpu_torch.config import TuningParams
from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.models import llama
from exllama_tpu_torch.ops import attn_block, mlp, quant, rope

HIDDEN, HEADS, D, INTER = 1024, 8, 128, 1152


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


def _qt_pair(k, n, gs, seed, act_order=False, scale=0.05):
    """The same GPTQ tensor loaded by both packages (bf16 scales in both)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * scale
    t = jgptq.quantize_matrix(w, gs, act_order, rng)
    args = (t["qweight"], t["qzeros"], t["scales"], t.get("g_idx"))
    return jgptq.load_quant_tensor(*args), gptq.load_quant_tensor(*args)


def _fused_pair(parts, seed, gs=128, scale=0.08):
    pairs = [_qt_pair(k, n, gs, seed + i, scale=scale)
             for i, (k, n) in enumerate(parts)]
    return (jgptq.concat_quant_tensors([p[0] for p in pairs]),
            gptq.concat_quant_tensors([p[1] for p in pairs]))


# ------------------------------------------------------------ K9 q4_gemv_a8

@pytest.mark.parametrize("impl", ["pallas_a8", "pallas_a8x2"])
@pytest.mark.parametrize("gs", [32, 128])
@pytest.mark.parametrize("m,norm,act_order", [
    (1, False, False), (1, True, False), (4, False, True),
    (4, True, False), (18, False, False), (18, True, True),
])
def test_q4_gemv_a8_matches_jax(m, norm, act_order, gs, impl):
    """5e-3: both sides do the same integer arithmetic on the same int8
    activations; only the order of the f32 sums over groups, rounding ties
    of x/sx and the bf16 output rounding (2^-9) differ."""
    k, n = 256, 520
    jqt, qt = _qt_pair(k, n, gs, 100 * m + gs + act_order, act_order)
    rng = np.random.default_rng(7 * m + gs)
    x = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
    nw = (rng.random(k) + 0.5).astype(np.float32) if norm else None
    ref = jquant.q4_matmul(
        _jnp_bf16(x), jqt, impl=impl + "_interpret",
        norm_w=None if nw is None else _jnp_bf16(nw), norm_eps=1e-6)
    got = quant.q4_matmul(_bf16(x), qt, impl,
                          norm_w=None if nw is None else _bf16(nw))
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel(got, ref) <= 5e-3
    direct = quant.q4_gemv_a8(_bf16(x), qt, None if nw is None else _bf16(nw),
                              1e-6, two_pass=impl == "pallas_a8x2")
    assert torch.equal(direct, got)


@pytest.mark.parametrize("gs", [32, 128])
def test_a8_noise_contracts_of_the_jax_suite_hold_on_the_port(gs):
    """tests/test_q4_matmul.py:85-132 on the port's plain versions: a8
    within 1.5% of the exact plain product; a8x2 within 0.4% of the exact
    kernel's arithmetic and below 0.45 of the a8 error -- and a8 does differ
    from exact (the mode really switches the arithmetic). The JAX test
    holds a8x2 against its exact kernel, whose weights q*s - zs stay f32
    (as in K1); the port's plain exact path rounds them to bf16 first,
    which alone is one bf16 step of the output (0.5%) here and there, so
    the kernel's arithmetic is written out below."""
    rng = np.random.default_rng(8)           # the JAX tests' own recipe
    w = rng.normal(size=(256, 512)).astype(np.float32) * 0.05
    t = gptq.quantize_matrix(w, gs, False, rng)
    qt = gptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"])
    x = _bf16(rng.normal(size=(4, 256)).astype(np.float32) * 0.5)
    exact = quant.q4_matmul(x, qt, "pallas")
    assert torch.equal(exact, quant.q4_matmul(x, qt))
    assert 0 < _rel(quant.q4_matmul(x, qt, "pallas_a8"), exact) < 0.015
    kernel = (x.float() @ gptq.dequantize_t(qt, torch.float32)).bfloat16()
    err_a8 = _rel(quant.q4_matmul(x, qt, "pallas_a8"), kernel)
    err_x2 = _rel(quant.q4_matmul(x, qt, "pallas_a8x2"), kernel)
    assert err_x2 < 4e-3 and err_x2 < 0.45 * err_a8
    assert torch.equal(quant.q4_matmul(x, qt, "pallas_a8t"),
                       quant.q4_matmul(x, qt, "pallas_a8"))


# ------------------------------------------------------- the int8 image

@pytest.mark.parametrize("act_order", [False, True])
def test_with_w8_matches_the_jax_image(act_order):
    """The port's K-major image [N, K] against the JAX image [K, N_pad]
    transposed, on the true columns: equal except +-1 on at most 0.1% of the
    entries (a product or a division rounded the other way at a tie), scales
    within 1e-6 relative; the image round-trips the dequantized weight
    within 0.51/127 of each column's maximum (tests/test_q4_matmul.py:
    214-218). Built in chunks of columns, it equals the image built in one
    piece."""
    k, n = 256, 520
    jqt, qt = _qt_pair(k, n, 32, 11, act_order)
    j8, p8 = jgptq.with_w8(jqt), gptq.with_w8(qt)
    assert p8.w8.shape == (n, k) and p8.w8.dtype == torch.int8
    assert p8.w8.is_contiguous()
    assert p8.w8_scale.shape == (n,) and p8.w8_scale.dtype == torch.float32
    ref8 = np.asarray(j8.w8)[:, :n].T.astype(np.int32)
    diff = np.abs(p8.w8.numpy().astype(np.int32) - ref8)
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    np.testing.assert_allclose(p8.w8_scale.numpy(),
                               np.asarray(j8.w8_scale)[0, :n], rtol=1e-6)
    wd = gptq.dequantize(qt)
    rt = p8.w8.t().numpy().astype(np.float32) * p8.w8_scale.numpy()
    colmax = np.abs(wd).max(axis=0) + 1e-9
    assert (np.abs(rt - wd).max(axis=0) / colmax).max() < 0.51 / 127
    assert gptq.with_w8(p8) is p8
    whole = gptq.dequantize_t(qt, torch.float32)
    scale = whole.abs().amax(dim=0).clamp_min(1e-20) * (1.0 / 127.0)
    one_piece = torch.round(whole / scale).clamp_(-127, 127).to(torch.int8)
    assert torch.equal(p8.w8, one_piece.t())
    assert torch.equal(p8.w8_scale, scale)


def test_w8_fields_are_carried_by_to_concat_and_permute():
    """The K-major images of two parts concatenate along their rows (one a
    column) into the image of the concatenated tensor, and a column
    permutation permutes the image's rows."""
    _, a = _qt_pair(64, 16, 32, 1)
    _, b = _qt_pair(64, 24, 32, 2)
    s = gptq.with_w8_scale(a)
    assert s.w8 is None and torch.equal(s.w8_scale, gptq.with_w8(a).w8_scale)
    assert gptq.with_w8_scale(s) is s
    a8, b8 = gptq.with_w8(a), gptq.with_w8(b)
    moved = a8.to("cpu")
    assert torch.equal(moved.w8, a8.w8)
    assert torch.equal(moved.w8_scale, a8.w8_scale)
    cat = gptq.concat_quant_tensors([a8, b8])
    whole = gptq.with_w8(gptq.concat_quant_tensors([a, b]))
    assert cat.w8.shape == (40, 64) and cat.w8.is_contiguous()
    assert torch.equal(cat.w8, whole.w8)
    assert torch.equal(cat.w8_scale, whole.w8_scale)
    half = gptq.concat_quant_tensors([a8, b])        # one part without image
    assert half.w8 is None and half.w8_scale is None
    perm = np.arange(16)[::-1].copy()
    p = gptq.permute_out_columns(a8, perm)
    assert torch.equal(p.w8, gptq.with_w8(gptq.permute_out_columns(a, perm)).w8)
    assert torch.equal(p.w8, a8.w8.flip(0)) and p.w8.is_contiguous()


# ------------------------------------------------------- K10, K11 prefill

@pytest.mark.parametrize("image,gs,act_order", [
    (False, 32, False), (False, 128, False),
    (True, 32, False), (True, 128, False), (True, 32, True),
])
def test_turbo_prefill_matches_jax(image, gs, act_order):
    """K10 (no image) and K11 (image) plain versions against the JAX
    package's "pallas_a8t" at M = 96: 5e-3 (the same int8 operands but for
    rounding ties, exact integer sums, then the bf16 output rounding), and
    within 3% of the exact product (tests/test_q4_matmul.py:189, :225)."""
    k, n, m = 256, 1024, 96
    jqt, qt = _qt_pair(k, n, gs, 9 + gs + act_order, act_order)
    x = (np.random.default_rng(9).normal(size=(m, k)) * 0.5).astype(np.float32)
    if image:
        jqt, qt = jgptq.with_w8(jqt), gptq.with_w8(qt)
    ref = jquant.q4_matmul(_jnp_bf16(x), jqt, impl="pallas_a8t_interpret")
    got = quant.q4_matmul(_bf16(x), qt, "pallas_a8t")
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel(got, ref) <= 5e-3
    exact = quant.q4_matmul(_bf16(x), qt)
    assert 0 < _rel(got, exact) < 0.03
    xg = _bf16(x)
    if act_order:
        xg = xg.index_select(1, qt.x_map.long())
    if image:
        assert torch.equal(got, quant.w8_matmul(xg, qt))
    else:
        # the column scales: attached ones and per-call ones are the same
        ws = gptq.w8_col_scale(qt)
        assert torch.equal(got, quant.q4_prefill_a8(xg, qt, ws))
        scaled = gptq.with_w8_scale(qt)
        assert torch.equal(got, quant.q4_matmul(_bf16(x), scaled,
                                                "pallas_a8t"))


@pytest.mark.parametrize("m,k,n,gs", [
    (33, 288, 136, 32), (130, 512, 264, 256), (257, 768, 520, 768),
])
def test_turbo_prefill_plain_matches_jax_at_ragged_shapes(m, k, n, gs):
    """K10's plain version, which the card holds K10 to, against the JAX
    package's "pallas_a8t" (no image) at the shapes K10's tiles find hard:
    M off the 256-row tile, N off the 128-column tile, a K that ends in
    half a 64-deep slab, groupsizes 32 / 256 / K. 5e-3, as above."""
    jqt, qt = _qt_pair(k, n, gs, 21 + m)
    x = (np.random.default_rng(m).normal(size=(m, k)) * 0.5).astype(np.float32)
    ref = jquant.q4_matmul(_jnp_bf16(x), jqt, impl="pallas_a8t_interpret")
    got = quant.q4_matmul(_bf16(x), qt, "pallas_a8t")
    assert got.shape == (m, n)
    assert _rel(got, ref) <= 5e-3
    assert torch.equal(got, quant.q4_prefill_a8_plain(
        _bf16(x), qt, gptq.w8_col_scale(qt)))


@pytest.mark.parametrize("m,k,n,gs", [
    (33, 256, 520, 32), (130, 512, 136, 128), (257, 288, 264, 32),
])
def test_w8_matmul_plain_on_the_k_major_image_matches_jax(m, k, n, gs):
    """K11's plain version, which the card holds K11 to, on the port's
    K-major image [N, K] against the JAX package's ``_q4_matmul_w8`` (its
    Pallas kernel in interpret mode) on the JAX image [K, N_pad], at N off
    the 128-column tile and M off the 256-row tile: 5e-3, as above. Fed the
    JAX image transposed, the port's plain version gives the same values up
    to the bf16 output rounding; fed that image's bytes read as [N, K] (the
    layout mistaken), its output moves by far more than the tolerance."""
    jqt, qt = _qt_pair(k, n, gs, 31 + m)
    j8, p8 = jgptq.with_w8(jqt), gptq.with_w8(qt)
    x = (np.random.default_rng(m).normal(size=(m, k)) * 0.5).astype(np.float32)
    ref = np.asarray(jquant._q4_matmul_w8(
        _jnp_bf16(x), j8.w8, j8.w8_scale, jnp.bfloat16, interpret=True))[:, :n]
    got = quant.w8_matmul_plain(_bf16(x), p8.w8, p8.w8_scale)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel(got, ref) <= 5e-3
    assert torch.equal(got, quant.w8_matmul(_bf16(x), p8))
    jimg = np.ascontiguousarray(np.asarray(j8.w8)[:, :n])          # [K, N]
    ws = torch.from_numpy(np.asarray(j8.w8_scale)[0, :n].copy())
    same = quant.w8_matmul_plain(_bf16(x), torch.from_numpy(jimg.T.copy()), ws)
    assert _rel(same, ref) <= 2 ** -8
    mistaken = quant.w8_matmul_plain(
        _bf16(x), torch.from_numpy(jimg.reshape(n, k)), ws)
    assert _rel(mistaken, ref) > 3 * 5e-3


@pytest.mark.parametrize("impl", ["pallas_a8", "pallas_a8x2"])
def test_a8_decode_modes_leave_prefill_exact(impl):
    """M > 32 under "pallas_a8" / "pallas_a8x2" is the exact K2 path, bit
    for bit (tests/test_q4_matmul.py:190-197)."""
    _, qt = _qt_pair(256, 1024, 128, 9)
    x = _bf16(np.random.default_rng(9).normal(size=(96, 256)) * 0.5)
    assert torch.equal(quant.q4_matmul(x, qt, impl), quant.q4_matmul(x, qt))


# ------------------------------------------------------------ K12 glu

@pytest.mark.parametrize("m", [8, 96])
def test_glu_fused_down_matches_jax(m):
    """q4_matmul(glu=(ni, ou)) against the JAX package's on the same raw
    gate|up values (M = 96: the kernel path, M = 8: the fallback); ou is
    padded_n(ni) in the JAX layout and ni in the port's. 5e-3
    (tests/test_q4_matmul.py:267)."""
    k, ni = 256, 512
    jgu, _ = _fused_pair([(k, ni), (k, ni)], 13, scale=0.1)
    jdn, pdn = _qt_pair(ni, k, 128, 15, scale=0.1)
    x = _jnp_bf16(np.random.default_rng(13).normal(size=(m, k)) * 0.3)
    fused = jquant.q4_matmul(x, jgu, impl="pallas_interpret")
    ou = jgptq.padded_n(ni)
    ref = jquant.q4_matmul(fused, jdn, impl="pallas_interpret", glu=(ni, ou))
    raw = np.asarray(fused, np.float32)
    ours = _bf16(np.concatenate([raw[:, :ni], raw[:, ou:ou + ni]], axis=1))
    got = quant.q4_matmul(ours, pdn, glu=(ni, ni))
    assert got.shape == (m, k)
    assert _rel(got, ref) <= 5e-3
    two_step = quant.q4_matmul(quant.glu_silu_mul(ours, ni, ni), pdn)
    assert torch.equal(got, two_step)
    with pytest.raises(ValueError):
        quant.q4_matmul(ours, pdn, glu=(ni, ni + 8))


@pytest.mark.parametrize("m,ni,n,gs", [
    (33, 288, 136, 32), (130, 512, 264, 512), (257, 768, 520, 256),
])
def test_glu_fused_down_plain_matches_jax_at_ragged_shapes(m, ni, n, gs):
    """K12's plain version against the JAX package's GLU down projection on
    the JAX package's own raw gate|up layout (up at ou = padded_n(ni) != ni,
    padding after each half) at ragged M, N off the 128-column tile, ni
    ending in half a 64-deep slab, groupsizes 32 / K / 256. 5e-3, as
    above."""
    k = 256
    jgu, _ = _fused_pair([(k, ni), (k, ni)], 17 + m, gs=32, scale=0.1)
    jdn, pdn = _qt_pair(ni, n, gs, 19 + m, scale=0.1)
    x = _jnp_bf16(np.random.default_rng(m).normal(size=(m, k)) * 0.3)
    fused = jquant.q4_matmul(x, jgu, impl="pallas_interpret")
    ou = jgptq.padded_n(ni)
    assert ou != ni
    ref = jquant.q4_matmul(fused, jdn, impl="pallas_interpret", glu=(ni, ou))
    raw = _bf16(fused)
    got = quant.q4_matmul(raw, pdn, glu=(ni, ou))
    assert got.shape == (m, n)
    assert _rel(got, ref) <= 5e-3
    assert torch.equal(got, quant.q4_matmul_glu_plain(raw, pdn, ni, ou))


def test_glu_goes_to_its_kernel_only_where_the_jax_gate_allows(monkeypatch):
    """M > 32, no act-order, not "pallas_a8t" (quant.py:1408-1420)."""
    calls = []
    real = quant.q4_matmul_glu
    monkeypatch.setattr(quant, "q4_matmul_glu",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    _, down = _qt_pair(64, 16, 32, 3)
    _, down_act = _qt_pair(64, 16, 32, 3, act_order=True)
    for m, qt, impl, want in ((40, down, "auto", 1), (40, down, "pallas_a8", 1),
                              (32, down, "auto", 0), (40, down_act, "auto", 0),
                              (40, down, "pallas_a8t", 0)):
        calls.clear()
        x = torch.ones((m, 128), dtype=torch.bfloat16)
        assert quant.q4_matmul(x, qt, impl, glu=(64, 64)).shape == (m, 16)
        assert len(calls) == want, (m, impl)


# --------------------------------------------- K9 inside the fused kernels

@pytest.mark.parametrize("impl", ["pallas_a8", "pallas_a8x2"])
@pytest.mark.parametrize("m", [1, 5])
def test_q4_mlp_a8_matches_jax(m, impl):
    """2e-2 of max(1, |ref|): a8 noise through two GEMVs on both sides, and
    bf16 rounding of gate|up before the silu."""
    jgu, pgu = _fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 3)
    jdn, pdn = _qt_pair(INTER, HIDDEN, 128, 5, scale=0.08)
    rng = np.random.default_rng(11 + m)
    h = (rng.normal(size=(1, m, HIDDEN)) * 0.5).astype(np.float32)
    nw = (rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32)
    ref = _np(jmlp.q4_mlp(_jnp_bf16(h), _jnp_bf16(nw), jgu, jdn, 1e-6,
                          impl=impl + "_interpret"))
    got = mlp.q4_mlp(_bf16(h), _bf16(nw), pgu, pdn, 1e-6, impl)
    assert got.shape == (1, m, HIDDEN) and got.dtype == torch.bfloat16
    atol = 2e-2 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=atol)
    exact = mlp.q4_mlp(_bf16(h), _bf16(nw), pgu, pdn, 1e-6)
    assert not torch.equal(got, exact)
    assert torch.equal(got, mlp.q4_mlp_a8(_bf16(h), _bf16(nw), pgu, pdn, 1e-6,
                                          two_pass=impl == "pallas_a8x2"))


@pytest.mark.parametrize("impl", ["pallas_a8", "pallas_a8x2"])
@pytest.mark.parametrize("entry,b,hkv,past,masked", [
    ("attn_block_o", 2, 8, [40, 64], True),
    ("layer_tail", 1, 2, 255, False),
    ("layer_step", 3, 8, [20, 7, 133], True),
])
def test_layer_tail_entry_points_a8_match_jax(entry, b, hkv, past, masked,
                                              impl):
    """2e-2 of max(1, |ref|), as the MLP case above; every GEMV phase of
    the JAX kernel (qkv, o, gate|up, down) runs a8 too. layer_step in a8:
    5e-2, the JAX suite's own limit for it (tests/test_attn_block.py:478) --
    its qkv rows pass through rope and a softmax before the next int8
    quantization, so a bf16 step of difference there draws other int8
    roundings downstream."""
    tol = 5e-2 if (entry, impl) == ("layer_step", "pallas_a8") else 2e-2
    s_max = attend_len = 256
    rng = np.random.default_rng(len(entry) * 7 + b + hkv)

    def r(*shape):
        return (rng.normal(size=shape) * 0.5).astype(np.float32)

    x = dict(h=r(b, 1, HIDDEN), q=r(b, 1, HEADS, D), kc=r(b, hkv, s_max, D),
             vc=r(b, hkv, s_max, D), kn=r(b, 1, hkv, D), vn=r(b, 1, hkv, D),
             iw=(rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32),
             nw=(rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32))
    jo, po = _qt_pair(HIDDEN, HIDDEN, 128, 2, scale=0.08)
    jgu, pgu = _fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 31)
    jdn, pdn = _qt_pair(INTER, HIDDEN, 128, 33, scale=0.08)
    jqkv, pqkv = _fused_pair([(HIDDEN, HEADS * D), (HIDDEN, hkv * D),
                              (HIDDEN, hkv * D)], 21)
    past_np = np.asarray(past, np.int32)
    pj = jnp.asarray(past_np)
    pt = past if isinstance(past, int) else torch.from_numpy(past_np)
    mask = None
    if masked:
        mask = np.ones((b, s_max), bool)
        mask[0, :9] = False
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask)
    j = {k: _jnp_bf16(v) for k, v in x.items()}
    t = {k: _bf16(v) for k, v in x.items()}
    jimpl = impl + "_interpret"
    if entry == "attn_block_o":
        ref = jab.attn_block_o(j["h"], j["q"], j["kc"], j["vc"], pj,
                               attend_len, jo, (j["kn"], j["vn"]),
                               input_mask=mj, impl=jimpl)
        got = attn_block.attn_block_o(t["h"], t["q"], t["kc"], t["vc"], pt,
                                      attend_len, po, (t["kn"], t["vn"]),
                                      input_mask=mt, impl=impl)
    elif entry == "layer_tail":
        ref = jab.layer_tail(j["h"], j["q"], j["kc"], j["vc"], pj, attend_len,
                             jo, j["nw"], jgu, jdn, 1e-6, (j["kn"], j["vn"]),
                             input_mask=mj, impl=jimpl)
        got = attn_block.layer_tail(t["h"], t["q"], t["kc"], t["vc"], pt,
                                    attend_len, po, t["nw"], pgu, pdn, 1e-6,
                                    (t["kn"], t["vn"]), input_mask=mt,
                                    impl=impl)
        assert torch.equal(got, attn_block.layer_tail_a8(
            t["h"], t["q"], t["kc"], t["vc"], pt, attend_len, po, t["nw"],
            pgu, pdn, 1e-6, (t["kn"], t["vn"]), input_mask=mt,
            two_pass=impl == "pallas_a8x2"))
    else:
        sj, cj = jrope.slice_tables(*jrope.rope_tables(s_max, D), pj, 1)
        st, ct = rope.slice_tables(*rope.rope_tables(s_max, D), pt, 1)
        ref, kj, vj = jab.layer_step(
            j["h"], jqkv, j["iw"], sj, cj, j["kc"], j["vc"], pj, attend_len,
            jo, j["nw"], jgu, jdn, 1e-6, HEADS, hkv, D, input_mask=mj,
            impl=jimpl)
        got, kt, vt = attn_block.layer_step(
            t["h"], pqkv, t["iw"], st, ct, t["kc"], t["vc"], pt, attend_len,
            po, t["nw"], pgu, pdn, 1e-6, HEADS, hkv, D, input_mask=mt,
            impl=impl)
        for ours, theirs in ((kt, kj), (vt, vj)):
            np.testing.assert_allclose(
                _np(ours), _np(theirs), rtol=0,
                atol=tol * max(1.0, float(np.abs(_np(theirs)).max())))
    ref = _np(ref)
    assert got.shape == (b, 1, HIDDEN) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(got), ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("impl", ["pallas_a8", "pallas_a8x2"])
@pytest.mark.parametrize("b,hkv,n_pad", [(1, 8, 0), (2, 2, 9)])
def test_attn_block_o_a8_attention_at_its_own_scale(b, hkv, n_pad, impl):
    """h = 0 on a peaked softmax with planted keys (the card-only test of
    the same name in test_torch_kernels.py), on the plain versions: the a8
    o-projection stays within 2e-2 of the exact one, while each attention
    fault moves the a8 output by more than 3x that."""
    hidden, heads, s_max, past = 1024, 8, 512, 400
    gen = torch.Generator().manual_seed(3)
    _, o = _qt_pair(hidden, hidden, 128, 2, scale=0.08)
    q, kc, vc, new_kv, mask = _planted(gen, b, heads, hkv, s_max, past, n_pad,
                                       device="cpu")
    h = torch.zeros((b, 1, hidden), dtype=torch.bfloat16)
    exact = attn_block.attn_block_o(h, q, kc, vc, past, s_max, o, new_kv,
                                    mask).float()
    got = attn_block.attn_block_o(h, q, kc, vc, past, s_max, o, new_kv, mask,
                                  impl=impl).float()
    scale = exact.abs().max()
    assert 0 < (got - exact).abs().max() <= 2e-2 * scale
    lost = torch.ones((b, s_max), dtype=torch.bool)
    lost[:, 128:256] = False
    faults = [((-new_kv[0], new_kv[1]), mask),
              (new_kv, lost if mask is None else lost & mask)]
    if mask is not None:
        faults.append((new_kv, None))
    for kv, msk in faults:
        moved = attn_block.attn_block_o(h, q, kc, vc, past, s_max, o, kv, msk,
                                        impl=impl).float() - got
        assert moved.abs().max() > 3 * 2e-2 * scale


# ------------------------------------------------------------ whole model

def _tiny(cfg):
    cfg.hidden_size = 256
    cfg.intermediate_size = 384
    cfg.num_attention_heads = 2
    cfg.num_key_value_heads = 1
    cfg.head_dim = D
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 512
    cfg.max_seq_len = 64
    cfg.max_input_len = 64
    cfg.max_attention_size = 64 * 64
    cfg.tuning.attn_len_bucket = 32
    return cfg


# mode -> (matmul_impl, prefill_w8, EXL_GLU_FUSE, prefill limit, decode limit)
MODES = {
    "a8": ("pallas_a8", "off", "0", 0.02, 0.12),
    "a8x2": ("pallas_a8x2", "off", "0", 0.02, 0.03),
    "a8t": ("pallas_a8t", "off", "0", 0.05, 0.12),
    "a8t_image": ("pallas_a8t", "on", "0", 0.05, 0.12),
    "glu": ("pallas", "off", "1", 0.02, 0.03),
}
N_PROMPT = {"a8": 34, "a8x2": 35, "a8t": 36, "a8t_image": 37, "glu": 38}


def _models(mode):
    impl, w8, _, _, _ = MODES[mode]
    jc = _tiny(JaxConfig())
    jc.tuning.matmul_impl = impl + "_interpret"
    jc.tuning.attn_impl = "flash_interpret"
    jc.tuning.prefill_w8 = w8
    pc = _tiny(port.ExLlamaConfig())
    pc.tuning.matmul_impl = impl
    pc.tuning.prefill_w8 = w8
    jp = jax_synth(jc, 128, False, 7)
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    if w8 == "on":
        # the constructors attach the images only on their accelerators
        jp = jllama._attach_prefill_w8(jp, jc)
        pp = llama._attach_prefill_w8(pp, pc)
        assert pp.layers[0].down.w8 is not None and pp.layers[0].o.w8 is None
        assert pp.layers[0].o.w8_scale is not None
    return (jllama.ExLlama(jc, params=jp),
            port.ExLlama(pc, params=pp, device="cpu"))


@pytest.mark.parametrize("mode", list(MODES))
def test_model_matches_jax_in_each_turbo_mode(mode, monkeypatch):
    """A prefill longer than 32 rows (the prefill kernels' side of the
    switch), then 3 teacher-forced decode steps: logits within 2% (prefill)
    and 3% (decode) of the logit scale for the exact-grade modes (a8x2, glu;
    a8 leaves prefill exact), 5% for the int8 prefill of a8t. Decode under
    a8 / a8t: 12%. On this model the one-pass int8 activations put either
    package's own a8 logits 5-10% of the logit scale away from its exact
    ones (two to three groups a row average nothing out), and the bf16-level
    differences between the packages (1% in the exact mode) draw other int8
    roundings, so the two a8 results sit as far apart as each sits from
    exact (3-9% measured). Same inputs give the same integers: the op-level
    tests above hold that to 5e-3. Each mode also moves the logits away
    from the exact path's."""
    _, _, glu, lim_prefill, lim_decode = MODES[mode]
    monkeypatch.setenv("EXL_GLU_FUSE", glu)
    glu_calls = []
    real = quant.q4_matmul_glu
    monkeypatch.setattr(quant, "q4_matmul_glu",
                        lambda *a: glu_calls.append(1) or real(*a))
    jm, pm = _models(mode)
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    # a prompt length of its own per mode: the JAX side reads EXL_GLU_FUSE
    # while it traces, so it must not meet a compiled step of another mode
    n = N_PROMPT[mode]
    ids = (np.arange(n, dtype=np.int32)[None, :] * 37 + 11) % 512
    steps = [ids] + [np.array([[t]], np.int32) for t in (3, 400, 77)]
    got_all = []
    for i, tok in enumerate(steps):
        ref = np.asarray(jm.forward(tok, jcache, last_id_only=i > 0))
        got = pm.forward(tok, pcache, last_id_only=i > 0).numpy()
        assert got.shape == ref.shape
        lim = lim_decode if i else lim_prefill
        assert np.abs(got - ref).max() <= lim * np.abs(ref).max(), (mode, i)
        got_all.append(got)
    assert pcache.current_seq_len == jcache.current_seq_len == n + 3
    assert len(glu_calls) == (2 if mode == "glu" else 0)   # one per layer

    if mode != "glu":
        pm.config.tuning.matmul_impl = "auto"
        cache = port.ExLlamaCache(pm)
        moved = [float(np.abs(pm.forward(tok, cache, last_id_only=i > 0)
                              .numpy() - got_all[i]).max())
                 for i, tok in enumerate(steps)]
        assert moved[-1] > 0
        assert (moved[0] > 0) == (mode in ("a8t", "a8t_image"))


@pytest.mark.parametrize("impl", ["auto", "pallas_a8", "pallas_a8x2",
                                  "pallas_a8t"])
def test_generate_simple_runs_under_each_impl(impl):
    """The generator needs nothing new: the same greedy request runs under
    each matmul_impl and its first token is the model's own argmax."""
    cfg = _tiny(port.ExLlamaConfig())
    cfg.tuning.matmul_impl = impl
    params = port.make_synthetic_params(cfg, 128, False, seed=5, device="cpu",
                                        fast=True)
    model = port.ExLlama(cfg, params=params, device="cpu")
    cache = port.ExLlamaCache(model)
    gen = port.ExLlamaGenerator(model, port.FakeTokenizer(), cache, seed=0)
    gen.settings.top_k = 1
    prompt = "the quick brown fox jumps over the lazy dog"     # 43 > 32 rows
    text = gen.generate_simple(prompt, max_new_tokens=5)
    assert isinstance(text, str)
    assert gen.sequence.shape == (1, len(prompt) + 5)
    assert cache.current_seq_len == len(prompt) + 5 - 1
    # greedy: the first new token is the argmax after the same two calls,
    # the prompt but its last token as a prefill, then that token as a step
    fresh, n = port.ExLlamaCache(model), len(prompt)
    model.forward(gen.sequence[:, :n - 1], fresh, preprocess_only=True)
    logits = model.forward(gen.sequence[:, n - 1:n], fresh)
    assert int(logits[0, -1].argmax()) == int(gen.sequence[0, n])


# ------------------------------------------------------------ config knobs

def test_matmul_knobs_accept_and_reject():
    t = TuningParams()
    ref = JaxConfig().tuning
    assert t.matmul_impl == ref.matmul_impl == "auto"
    assert t.prefill_w8 == ref.prefill_w8 == "auto"
    assert t.prefill_w8_budget_gb is None     # the JAX default is a 16 GiB
    for impl in ("auto", "pallas", "pallas_a8", "pallas_a8x2", "xla",
                 "pallas_a8t"):
        t.matmul_impl = impl
        assert t.matmul_impl == impl
    for impl in ("pallas_interpret", "pallas_a8_interpret",
                 "pallas_a8x2_interpret", "pallas_a8t_interpret"):
        with pytest.raises(NotImplementedError):
            t.matmul_impl = impl
    for impl in ("triton", "pallas_a8x3", ""):
        with pytest.raises(ValueError):
            t.matmul_impl = impl
    assert t.matmul_impl == "pallas_a8t"
    for w8 in ("auto", "on", "off"):
        t.prefill_w8 = w8
    with pytest.raises(ValueError):
        t.prefill_w8 = "maybe"
    t.prefill_w8_budget_gb = 40.0
    _, qt = _qt_pair(64, 16, 32, 1)
    x = torch.ones((1, 64), dtype=torch.bfloat16)
    # "xla" is the plain path (an oracle), the interpret strings TPU-only
    assert torch.equal(quant.q4_matmul(x, qt, "xla"),
                       quant._q4_matmul_plain(x, qt))
    with pytest.raises(NotImplementedError):
        quant.q4_matmul(x, qt, "pallas_interpret")
    with pytest.raises(ValueError):
        quant.q4_matmul(x, qt, "cublas")


def test_attach_prefill_w8_priority_and_budget():
    """down first, then gate|up, then qkv, never o; "auto" spends what the
    budget leaves after the packed weights and the KV cache
    (exllama_tpu/models/llama.py:753-839)."""
    cfg = _tiny(port.ExLlamaConfig())
    params = port.make_synthetic_params(cfg, 128, False, seed=1, device="cpu",
                                        fast=True)
    packed = sum(llama._quant_bytes(getattr(lp, f)) for lp in params.layers
                 for f in ("qkv", "o", "gateup", "down"))
    kv = 2 * 2 * cfg.max_seq_len * cfg.head_dim * 2

    def images(budget_bytes):
        cfg.tuning.prefill_w8 = "auto"
        cfg.tuning.prefill_w8_budget_gb = (packed + kv + budget_bytes) / 2 ** 30
        out = llama._attach_prefill_w8(params, cfg)
        for lp in out.layers:
            assert all(getattr(lp, f).w8_scale is not None
                       for f in ("qkv", "o", "gateup", "down"))
        return [(li, f) for li, lp in enumerate(out.layers)
                for f in ("qkv", "o", "gateup", "down")
                if getattr(lp, f).w8 is not None]

    down = 384 * 256 + 4 * 256
    gateup = 256 * 768 + 4 * 768
    assert images(0) == []
    assert images(down) == [(0, "down")]
    assert images(2 * down + gateup) == [(0, "gateup"), (0, "down"),
                                         (1, "down")]
    everything = [(li, f) for li in (0, 1) for f in ("qkv", "gateup", "down")]
    assert images(1 << 30) == everything
    cfg.tuning.prefill_w8 = "on"
    cfg.tuning.prefill_w8_budget_gb = None
    full = llama._attach_prefill_w8(params, cfg)
    model = port.ExLlama(cfg, params=full, device="cpu")
    assert model.w8_image_bytes() == sum(
        getattr(lp, f).in_features * getattr(lp, f).out_features
        for lp in full.layers for f in ("qkv", "gateup", "down")) + sum(
        4 * getattr(lp, f).out_features
        for lp in full.layers for f in ("qkv", "o", "gateup", "down"))
    cfg.tuning.prefill_w8 = "auto"
    with pytest.raises(ValueError):
        llama._attach_prefill_w8(params, cfg)      # no card, no budget given


def test_plain_products_leave_the_tf32_switch_alone():
    """The plain versions scope TF32 off and restore the process-wide
    setting."""
    _, qt = _qt_pair(64, 16, 32, 1)
    x = torch.ones((2, 64), dtype=torch.bfloat16)
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            quant.q4_gemv_plain(x, qt)
            quant.q4_gemv_a8_plain(x, qt, two_pass=True)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
