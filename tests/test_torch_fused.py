"""The port's fused decode path -- K5 head_argmax, K6 q4_mlp, K7 layer_tail
(attn_block_o / layer_tail / layer_step), K8 kv_commit -- held against the
JAX package on the same numpy inputs (plain PyTorch paths on the CPU; the
JAX side runs its Pallas kernels in interpret mode, as tests/test_attn_block.py
and tests/test_mlp_fused.py do). Widths are lane-full (hidden 1024, head_dim
128) because the JAX fused gates ask for them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.ops import attention as jattn
from exllama_tpu.ops import attn_block as jab
from exllama_tpu.ops import dense as jdense
from exllama_tpu.ops import mlp as jmlp
from exllama_tpu.ops import rope as jrope

import exllama_tpu_torch as port
from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.models.llama import forward_chunk
from exllama_tpu_torch.ops import attention, attn_block, dense, mlp, rope
from exllama_tpu_torch.ops.norms import rms_norm

HIDDEN, HEADS, D, INTER = 1024, 8, 128, 1152


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _check(got, ref, tol=0.03):
    """The JAX suite's fused-kernel tolerance (tests/test_attn_block.py)."""
    ref = _np(ref)
    atol = tol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=atol)


def _qt_pair(k, n, gs, seed, scale=0.08):
    """The same GPTQ tensor loaded by both packages."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * scale
    t = jgptq.quantize_matrix(w, gs, act_order=False, rng=rng)
    args = (t["qweight"], t["qzeros"], t["scales"], t.get("g_idx"))
    return jgptq.load_quant_tensor(*args), gptq.load_quant_tensor(*args)


def _fused_pair(parts, seed, gs=128):
    """[(k, n), ...] -> the column concatenation in both packages."""
    pairs = [_qt_pair(k, n, gs, seed + i) for i, (k, n) in enumerate(parts)]
    return (jgptq.concat_quant_tensors([p[0] for p in pairs]),
            gptq.concat_quant_tensors([p[1] for p in pairs]))


# ---------------------------------------------------------------- K5 head

@pytest.mark.parametrize("m", [1, 3])
def test_head_argmax_matches_jax(m):
    """The same token wherever the top-2 margin exceeds 1e-2 of the logit
    scale (bf16 rounding of the normed row and f32 sum order otherwise
    decide near-ties)."""
    rng = np.random.default_rng(41 + 100 * m)
    k, v = 256, 1024
    x = rng.normal(size=(m, 1, k)).astype(np.float32)
    nw = (rng.random(k) + 0.5).astype(np.float32)
    w = (rng.normal(size=(k, v)) * 0.05).astype(np.float32)
    ref = np.asarray(jdense.head_argmax(
        _jnp_bf16(x), _jnp_bf16(nw), _jnp_bf16(w), 1e-6,
        impl="pallas_interpret"))
    got = dense.head_argmax(_bf16(x), _bf16(nw), _bf16(w), 1e-6).numpy()
    assert got.shape == ref.shape == (m, 1) and got.dtype == np.int32
    logits = _np(dense.dense_gemv_plain(
        rms_norm(_bf16(x[:, 0]), _bf16(nw), 1e-6), _bf16(w)))
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2 * np.abs(logits).max()
    assert clear.any()
    np.testing.assert_array_equal(got[clear], ref[clear])


def test_head_argmax_tie_takes_the_earliest_index():
    """A duplicated maximum column: both packages return the earlier one."""
    rng = np.random.default_rng(47)
    k, v = 256, 1024
    x = rng.normal(size=(1, 1, k)).astype(np.float32)
    nw = np.ones(k, np.float32)
    w = (rng.normal(size=(k, v)) * 0.05).astype(np.float32)
    top = int(dense.head_argmax(_bf16(x), _bf16(nw), _bf16(w), 1e-6)[0, 0])
    dup = 700 if top < 700 else 5
    w[:, dup] = w[:, top]
    want = min(top, dup)
    ref = np.asarray(jdense.head_argmax(
        _jnp_bf16(x), _jnp_bf16(nw), _jnp_bf16(w), 1e-6,
        impl="pallas_interpret"))
    got = dense.head_argmax(_bf16(x), _bf16(nw), _bf16(w), 1e-6).numpy()
    assert int(ref[0, 0]) == int(got[0, 0]) == want


# ------------------------------------------------------------------ K6 MLP

@pytest.mark.parametrize("gs", [128, 32])
@pytest.mark.parametrize("m", [1, 5])
def test_q4_mlp_matches_jax(m, gs):
    (jgu, pgu) = _fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 3, gs)
    jdn, pdn = _qt_pair(INTER, HIDDEN, gs, 5)
    rng = np.random.default_rng(11 + m)
    h = (rng.normal(size=(1, m, HIDDEN)) * 0.5).astype(np.float32)
    nw = (rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32)
    assert mlp.fused_mlp_applicable(pgu, pdn, HIDDEN, m)
    ref = jmlp.q4_mlp(_jnp_bf16(h), _jnp_bf16(nw), jgu, jdn, 1e-6,
                      impl="pallas_interpret")
    got = mlp.q4_mlp(_bf16(h), _bf16(nw), pgu, pdn, 1e-6)
    assert got.shape == (1, m, HIDDEN) and got.dtype == torch.bfloat16
    _check(got, ref)


def test_fused_mlp_gate():
    """The JAX gate's semantic conditions; the TPU ones have no
    counterpart."""
    _, pgu = _fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 3)
    _, pdn = _qt_pair(INTER, HIDDEN, 128, 5)
    _, pdn64 = _qt_pair(INTER, HIDDEN, 64, 5)
    ok = mlp.fused_mlp_applicable
    assert ok(pgu, pdn, HIDDEN, 32)
    assert not ok(pgu, pdn, HIDDEN, 33)           # beyond the GEMV regime
    assert not ok(pgu, pdn64, HIDDEN, 1)          # two groupsizes
    assert not ok(None, pdn, HIDDEN, 1)           # unfused gate / up
    assert not ok(pgu, pdn, HIDDEN + 128, 1)      # residual width


# ------------------------------------------------------- K7 layer tail

def _tail_inputs(b, hkv, s_max, seed):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.normal(size=shape) * 0.5).astype(np.float32)

    return dict(h=r(b, 1, HIDDEN), q=r(b, 1, HEADS, D), kc=r(b, hkv, s_max, D),
                vc=r(b, hkv, s_max, D), kn=r(b, 1, hkv, D), vn=r(b, 1, hkv, D),
                iw=(rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32),
                nw=(rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32))


@pytest.mark.parametrize("entry,b,hkv,past,masked,attend_len", [
    ("attn_block_o", 1, 8, 0, False, 256),
    ("attn_block_o", 2, 8, [40, 64], True, 256),
    ("layer_tail", 1, 8, 77, False, 256),
    ("layer_tail", 1, 2, 255, False, 256),
    ("layer_tail", 3, 8, [0, 7, 133], False, 256),
    ("layer_tail", 1, 8, 300, False, 512),
    ("layer_step", 1, 2, 0, False, 256),
    ("layer_step", 1, 8, 255, False, 256),
    ("layer_step", 3, 8, [20, 7, 133], True, 256),
])
def test_layer_tail_entry_points_match_jax(entry, b, hkv, past, masked,
                                           attend_len, monkeypatch):
    """atol 0.03 of max(1, |ref|): the JAX suite's own tolerance for these
    kernels. attend_len 512 runs the JAX kernel over 128-key strips, as
    tests/test_attn_block.py::test_multi_kv_strips does."""
    monkeypatch.setattr(jab, "_pick_bk", lambda al: 128)
    s_max = attend_len
    x = _tail_inputs(b, hkv, s_max, seed=len(entry) * 7 + b + hkv)
    jo, po = _qt_pair(HIDDEN, HIDDEN, 128, 2)
    jgu, pgu = _fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 31)
    jdn, pdn = _qt_pair(INTER, HIDDEN, 128, 33)
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
    assert attn_block.attn_o_applicable(po, HIDDEN, HEADS, D, 1, True,
                                        batch=b, kv_heads=hkv)

    if entry == "attn_block_o":
        ref = jab.attn_block_o(j["h"], j["q"], j["kc"], j["vc"], pj,
                               attend_len, jo, (j["kn"], j["vn"]),
                               input_mask=mj, impl="pallas_interpret")
        got = attn_block.attn_block_o(t["h"], t["q"], t["kc"], t["vc"], pt,
                                      attend_len, po, (t["kn"], t["vn"]),
                                      input_mask=mt)
    elif entry == "layer_tail":
        ref = jab.layer_tail(j["h"], j["q"], j["kc"], j["vc"], pj,
                             attend_len, jo, j["nw"], jgu, jdn, 1e-6,
                             (j["kn"], j["vn"]), input_mask=mj,
                             impl="pallas_interpret")
        got = attn_block.layer_tail(t["h"], t["q"], t["kc"], t["vc"], pt,
                                    attend_len, po, t["nw"], pgu, pdn, 1e-6,
                                    (t["kn"], t["vn"]), input_mask=mt)
    else:
        assert attn_block.layer_step_applicable(pqkv, po, HIDDEN, HEADS, D)
        sj, cj = jrope.slice_tables(*jrope.rope_tables(s_max, D), pj, 1)
        st, ct = rope.slice_tables(*rope.rope_tables(s_max, D), pt, 1)
        ref, kj, vj = jab.layer_step(
            j["h"], jqkv, j["iw"], sj, cj, j["kc"], j["vc"], pj, attend_len,
            jo, j["nw"], jgu, jdn, 1e-6, HEADS, hkv, D, input_mask=mj,
            impl="pallas_interpret")
        got, kt, vt = attn_block.layer_step(
            t["h"], pqkv, t["iw"], st, ct, t["kc"], t["vc"], pt, attend_len,
            po, t["nw"], pgu, pdn, 1e-6, HEADS, hkv, D, input_mask=mt)
        assert kt.shape == vt.shape == (b, 1, hkv, D)
        _check(kt, kj)
        _check(vt, vj)
    assert got.shape == (b, 1, HIDDEN) and got.dtype == torch.bfloat16
    _check(got, ref)


def test_layer_tail_gates():
    _, po = _qt_pair(HIDDEN, HIDDEN, 128, 2)
    _, po64 = _qt_pair(HIDDEN, HIDDEN, 64, 2)
    _, pqkv = _fused_pair([(HIDDEN, HIDDEN), (HIDDEN, 256), (HIDDEN, 256)], 21)
    ok = attn_block.attn_o_applicable
    assert ok(po, HIDDEN, HEADS, D, 1, True, batch=32, kv_heads=2)
    assert not ok(po, HIDDEN, HEADS, D, 4, True)            # prefill
    assert not ok(po, HIDDEN, HEADS, D, 1, False)           # no deferral
    assert not ok(po, HIDDEN, HEADS, D, 1, True, batch=33)  # B > 32
    assert not ok(po, HIDDEN, 16, 64, 1, True)              # head_dim 64
    assert not ok(po, HIDDEN, HEADS, D, 1, True, kv_heads=3)
    assert attn_block.layer_step_applicable(pqkv, po, HIDDEN, HEADS, D)
    assert not attn_block.layer_step_applicable(pqkv, po64, HIDDEN, HEADS, D)
    assert not attn_block.same_groupsize(pqkv, po64)


def test_layer_tail_takes_only_a_bf16_cache():
    """... unless the cache comes with its scales: an int8 cache alone is
    refused, with k_scale / v_scale it is attended
    (tests/test_torch_kvcache.py holds that against the JAX kernel)."""
    x = _tail_inputs(1, 8, 64, seed=3)
    _, po = _qt_pair(HIDDEN, HIDDEN, 128, 2)
    kc = torch.zeros((1, 8, 64, D), dtype=torch.int8)
    args = (_bf16(x["h"]), _bf16(x["q"]), kc, kc, 5, 64, po,
            (_bf16(x["kn"]), _bf16(x["vn"])))
    with pytest.raises(ValueError):
        attn_block.attn_block_o(*args)
    scale = torch.ones((1, 8, 64), dtype=torch.float32)
    out = attn_block.attn_block_o(*args, k_scale=scale, v_scale=scale)
    assert out.shape == (1, 1, HIDDEN) and torch.isfinite(out.float()).all()


# ------------------------------------------------------------ K8 commit

@pytest.mark.parametrize("per_row", [False, True])
def test_commit_kv_cache_matches_jax_exactly(per_row):
    """L=3 layers' rows into their caches: bit-equal to the JAX package's
    commit kernel (a scalar cursor) or its plain writes (per-row cursors,
    which both packages send to the plain path)."""
    n_layers, b, hkv, s_max = 3, 2, 2, 64
    rng = np.random.default_rng(5 + per_row)
    kc = rng.normal(size=(n_layers, b, hkv, s_max, D)).astype(np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    nk = rng.normal(size=(n_layers, b, 1, hkv, D)).astype(np.float32)
    nv = rng.normal(size=nk.shape).astype(np.float32)
    past = np.asarray([5, 40], np.int32) if per_row else 37
    ks, vs, _, _ = jattn.commit_kv_cache(
        tuple(_jnp_bf16(c) for c in kc), tuple(_jnp_bf16(c) for c in vc),
        _jnp_bf16(nk), _jnp_bf16(nv), jnp.asarray(past, jnp.int32),
        impl="pallas", interpret=True)
    pk, pv = [_bf16(c) for c in kc], [_bf16(c) for c in vc]
    attention.commit_kv_cache(
        pk, pv, _bf16(nk), _bf16(nv),
        torch.from_numpy(past) if per_row else past, impl="pallas")
    for li in range(n_layers):
        np.testing.assert_array_equal(_np(pk[li]), _np(ks[li]))
        np.testing.assert_array_equal(_np(pv[li]), _np(vs[li]))


def test_cache_builds_the_commit_pointer_array_once():
    """ExLlamaCache.kv_ptrs, K8's operand: the 2L cache base pointers (K
    layers, then V) on the cache's device, built with the cache; a clone
    builds its own."""
    cache = port.ExLlamaCache(_port_model())
    want = [t.data_ptr() for t in cache.k + cache.v]
    assert cache.kv_ptrs.dtype == torch.int64
    assert cache.kv_ptrs.tolist() == want
    clone = cache.clone()
    got = clone.kv_ptrs.tolist()
    assert got == [t.data_ptr() for t in clone.k + clone.v] and got != want


# ------------------------------------------------------------ whole model

def _tiny(cfg, kv_heads=1):
    cfg.hidden_size = 256
    cfg.intermediate_size = 384
    cfg.num_attention_heads = 2
    cfg.num_key_value_heads = kv_heads
    cfg.head_dim = D
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 512
    cfg.max_seq_len = 64
    cfg.max_input_len = 64
    cfg.max_attention_size = 64 * 64
    cfg.tuning.attn_len_bucket = 32
    return cfg


KNOBS = {
    "default": {},
    "fuse_qkv": dict(fuse_qkv=True),
    "commit_pallas": dict(commit_impl="pallas"),
    "mlp_only": dict(fuse_attn=False),
    # the whole layer in K7, its K/V rows staged in the cache for K8
    "fuse_qkv_commit_pallas": dict(fuse_qkv=True, commit_impl="pallas"),
}


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_model_matches_jax_in_each_configuration(knobs):
    """Prefill, then 4 teacher-forced decode steps, each knob combination on
    both sides: logits within 3% of the logit scale (the JAX package's own
    two paths differ by up to 2.1% on such a model)."""
    jc = _tiny(JaxConfig())
    jc.tuning.matmul_impl = "pallas_interpret"
    jc.tuning.attn_impl = "flash_interpret"
    pc = _tiny(port.ExLlamaConfig())
    for cfg in (jc, pc):
        for k, v in KNOBS[knobs].items():
            setattr(cfg.tuning, k, v)
    jp = jax_synth(jc, 128, False, 7)
    jm = JaxModel(jc, params=jp)
    pm = port.ExLlama(pc, params=port.params_from_jax(
        jax.tree.map(np.asarray, jp), pc, device="cpu"), device="cpu")
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    ids = (np.arange(9, dtype=np.int32)[None, :] * 37 + 11) % 512
    steps = [ids] + [np.array([[t]], np.int32) for t in (3, 400, 77, 250)]
    for i, tok in enumerate(steps):
        ref = np.asarray(jm.forward(tok, jcache, last_id_only=i > 0))
        got = pm.forward(tok, pcache, last_id_only=i > 0).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 0.03 * np.abs(ref).max(), i
    assert pcache.current_seq_len == jcache.current_seq_len == 13


def _port_model(seed=8, **knobs):
    cfg = _tiny(port.ExLlamaConfig(), kv_heads=2)
    for k, v in knobs.items():
        setattr(cfg.tuning, k, v)
    params = port.make_synthetic_params(cfg, 128, False, seed=seed,
                                        device="cpu", fast=True)
    return port.ExLlama(cfg, params=params, device="cpu")


def test_forward_chunk_argmax_head_matches_the_logits():
    """head_mode="argmax" returns int32 [B, 1] ids equal to the argmax of
    head_mode="logits" wherever the top-2 margin is clear (1e-2 of scale)."""
    model = _port_model()
    cfg = model.config
    kw = dict(attend_len=cfg.max_seq_len, last_token_only=True,
              preprocess_only=False, heads=cfg.num_attention_heads,
              kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
              eps=cfg.rms_norm_eps)
    cache = port.ExLlamaCache(model, batch_size=2)
    tokens = torch.tensor([[5, 9, 200, 31], [7, 7, 1, 400]], dtype=torch.int32)
    checked = 0
    for pos in range(tokens.shape[1]):
        tok = tokens[:, pos:pos + 1]
        logits = forward_chunk(model.params, cache, tok, pos, None, **kw)
        ids = forward_chunk(model.params, cache, tok, pos, None,
                            head_mode="argmax", **kw)
        assert ids.shape == (2, 1) and ids.dtype == torch.int32
        lg = logits[:, 0].numpy()
        top2 = np.sort(lg, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-2 * np.abs(lg).max()
        np.testing.assert_array_equal(ids[:, 0].numpy()[clear],
                                      lg.argmax(1)[clear])
        checked += int(clear.sum())
    assert checked > 0
    with pytest.raises(ValueError):
        forward_chunk(model.params, cache, tok, 0, None, head_mode="topk",
                      **kw)


def test_default_configuration_matches_the_separate_one():
    """The port's default (fused) configuration against its first slice's
    (fusions off, plain commit), same weights: decode logits within 3%."""
    fused = _port_model(seed=9)
    separate = _port_model(seed=9, fuse_mlp=False, fuse_attn=False,
                           commit_impl="xla")
    caches = [port.ExLlamaCache(m) for m in (fused, separate)]
    ids = (np.arange(6, dtype=np.int32)[None, :] * 29 + 3) % 512
    for tok in [ids] + [np.array([[t]], np.int32) for t in (17, 301, 4)]:
        a, b = (m.forward(tok, c).numpy()
                for m, c in zip((fused, separate), caches))
        assert np.abs(a - b).max() <= 0.03 * np.abs(b).max()
