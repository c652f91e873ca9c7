"""Groupsizes and head dims the reference takes, on the port (plain PyTorch
paths on the CPU) against the JAX package: 4-bit matmuls at groupsize 256
and at groupsize = K (a checkpoint quantized without groups), the
``attn_impl`` routes by head dim (K3, or the einsum attention the reference
runs outside its flash kernel), tiny head_dim-256 / head_dim-100 /
groupsize-256 models, the tensor-core GEMV's split plan, and ``gen_tokens``
after a left-padded ``gen_begin``."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.generator import ExLlamaGenerator as JaxGenerator
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.ops import attention as jattn
from exllama_tpu.ops import quant as jquant

import exllama_tpu_torch as port
from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.ops import attention, quant


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _rel(got, ref) -> float:
    got = got.to(torch.float32).numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _qt_pair(k, n, gs, seed, act_order=False):
    """The same GPTQ tensor loaded by both packages."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    t = jgptq.quantize_matrix(w, gs, act_order, rng)
    args = (t["qweight"], t["qzeros"], t["scales"], t.get("g_idx"))
    return jgptq.load_quant_tensor(*args), gptq.load_quant_tensor(*args)


# ------------------------------------------------------------- groupsizes

@pytest.mark.parametrize("gs,ok", [
    (32, True), (256, True), (512, True), (96, False), (48, False),
    (16, False), (1024, False),
])
def test_check_qt_tensors_takes_any_groupsize_dividing_k(gs, ok):
    """A multiple of 32 that divides K = 512 (gs = K too) is taken; 96
    does not divide 512, 48 and 16 are not multiples of 32, 1024 > K."""
    words = torch.zeros((512 // 8, 64), dtype=torch.int32)
    ng = max(512 // gs, 1)
    s = torch.ones((ng, 64), dtype=torch.bfloat16)
    qt = gptq.QuantTensor(words, s, s.clone(), None, gs)
    if ok:
        quant.check_qt_tensors(qt, torch.device("cpu"))
    else:
        with pytest.raises(ValueError):
            quant.check_qt_tensors(qt, torch.device("cpu"))


@pytest.mark.parametrize("m,gs,act_order", [
    (1, 256, False), (7, 256, True), (40, 256, False),
    (1, 512, False), (18, 512, False), (40, 512, True),
])
def test_q4_matmul_matches_jax_at_large_groupsizes(m, gs, act_order):
    """Groupsize 256 and groupsize = K (512): the port's dispatcher (K1 /
    K2's plain versions here) against the JAX package's plain path
    (matmul_impl "xla"), rtol/atol 2e-2 as tests/test_q4_matmul.py:44."""
    k, n = 512, 264
    jqt, qt = _qt_pair(k, n, gs, 31 * m + gs + act_order, act_order)
    rng = np.random.default_rng(m + gs)
    x = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
    nw = (rng.random(k) + 0.5).astype(np.float32)
    ref = np.asarray(jquant.q4_matmul(
        _jnp_bf16(x), jqt, impl="xla", norm_w=_jnp_bf16(nw),
        norm_eps=1e-6).astype(jnp.float32))
    got = quant.q4_matmul(_bf16(x), qt, norm_w=_bf16(nw)).float().numpy()
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("impl", ["pallas_a8", "pallas_a8x2"])
@pytest.mark.parametrize("m,gs", [(1, 256), (18, 256), (4, 512)])
def test_q4_gemv_a8_matches_jax_at_large_groupsizes(m, gs, impl):
    """K9's arithmetic at groupsize 256 and = K: 5e-3 against the JAX
    package's a8 kernel in interpret mode, as test_torch_turbo.py holds it
    at 32 / 128 (the same int8 activations and integer group sums)."""
    k, n = 512, 264
    jqt, qt = _qt_pair(k, n, gs, 7 * m + gs)
    x = (np.random.default_rng(m).normal(size=(m, k)) * 0.5).astype(
        np.float32)
    ref = jquant.q4_matmul(_jnp_bf16(x), jqt, impl=impl + "_interpret")
    got = quant.q4_matmul(_bf16(x), qt, impl)
    assert _rel(got, ref) <= 5e-3


def test_gemv_route_and_split_plan():
    """K1 / K9 take the tensor-core route at 2..32 rows and at one row
    outside groupsizes 32 / 64 / 128. The split plan fits its (128-column
    tile, K split) blocks in one wave of two an SM, each split at least 8
    units of 32 k, none empty (the C side normalises the same way)."""
    assert not quant.gemv_tc_route(1, 128)
    assert quant.gemv_tc_route(1, 256) and quant.gemv_tc_route(1, 4096)
    assert quant.gemv_tc_route(2, 128) and quant.gemv_tc_route(32, 32)
    assert quant.gemv_rows(2) == quant.gemv_rows(16) == 16
    assert quant.gemv_rows(17) == quant.gemv_rows(32) == 32
    # Llama-7B on 132 SMs: qkv, o, gate|up, down
    assert [quant.gemv_split_plan(n, k, 132) for n, k in (
        (12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008))] == [
        2, 8, 1, 8]
    for n, k, sms in ((264, 512, 132), (100, 256, 8), (8192, 11008, 132),
                      (136, 2048, 132), (256, 8192, 132)):
        s = quant.gemv_split_plan(n, k, sms)
        units = k // 32
        per = -(-units // s)
        assert 1 <= s and (s - 1) * per < units <= s * per
        assert s == 1 or per >= quant.GEMV_MIN_SPLIT_UNITS


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("impl,d,route", [
    ("auto", 64, "flash"), ("auto", 128, "flash"), ("auto", 256, "flash"),
    ("auto", 100, "xla"), ("auto", 96, "xla"), ("auto", 384, "xla"),
    ("xla", 128, "xla"), ("xla", 100, "xla"), ("flash", 256, "flash"),
])
def test_resolve_attn_impl_by_head_dim(impl, d, route):
    """"auto" is K3 where the port's copy of the JAX predicate holds (64 or
    a multiple of 128, within the 64 / 128 / 256 K3 is built for)."""
    assert attention.resolve_attn_impl(impl, d) == route


@pytest.mark.parametrize("d", [100, 96, 384])
def test_flash_route_refuses_other_head_dims(d):
    with pytest.raises(ValueError):
        attention.resolve_attn_impl("flash", d)


def test_attn_impl_is_a_knob_with_the_jax_values():
    cfg = port.ExLlamaConfig()
    assert cfg.tuning.attn_impl == "auto"
    for v in ("flash", "xla", "auto"):
        cfg.tuning.attn_impl = v
    with pytest.raises(ValueError):
        cfg.tuning.attn_impl = "flash_interpret"


def _attn_inputs(seed, b, t, h, hkv, d, s_max, kind):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    kv = rng.normal(size=(2, b, s_max, hkv, d)).astype(np.float32)
    if kind == "bf16":
        return q, [np.swapaxes(x, 1, 2) for x in kv], None
    quant_rows = (jattn.quantize_kv_rows4 if kind == "int4"
                  else jattn.quantize_kv_rows)
    caches, scales = [], []
    for x in kv:
        c, s = quant_rows(jnp.asarray(x))          # [B, S, Hkv, ..]
        caches.append(np.swapaxes(np.asarray(c), 1, 2))
        scales.append(np.swapaxes(np.asarray(s), 1, 2))
    return q, caches, scales


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("t,deferred", [(1, True), (7, False)])
def test_attend_at_head_dim_256_matches_jax(kind, t, deferred):
    """K3's plain version at head_dim 256 over bf16 / int8 / int4 caches
    against the JAX flash kernel in interpret mode (which takes 256),
    2e-2 as at 64 / 128 (tests/test_torch_ops.py, test_torch_kvcache.py):
    p rounded to bf16 at other points of the online softmax."""
    b, h, hkv, d, s_max = 2, 4, 2, 256, 64
    q, (kc, vc), sc = _attn_inputs(d + t + len(kind), b, t, h, hkv, d, s_max,
                                   kind)
    rng = np.random.default_rng(5)
    past = np.array([3, 20], np.int32)
    mask = np.ones((b, s_max), bool)
    mask[0, :2] = False
    new = [rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
           for _ in range(2)] if deferred else None
    ks, vs = (None, None) if sc is None else sc
    ref = jattn.attend(
        _jnp_bf16(q), jnp.asarray(kc if sc else kc.astype(np.float32),
                                  None if sc else jnp.bfloat16),
        jnp.asarray(vc if sc else vc.astype(np.float32),
                    None if sc else jnp.bfloat16),
        jnp.asarray(past), 48, jnp.asarray(mask), impl="flash_interpret",
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
        new_kv=None if new is None else tuple(_jnp_bf16(x) for x in new))
    tc = (lambda a: torch.from_numpy(np.array(a))) if sc else _bf16
    got = attention.attend(
        _bf16(q), tc(kc), tc(vc), torch.from_numpy(past), 48,
        torch.from_numpy(mask),
        new_kv=None if new is None else tuple(_bf16(x) for x in new),
        k_scale=None if ks is None else torch.from_numpy(np.array(ks)),
        v_scale=None if vs is None else torch.from_numpy(np.array(vs)))
    assert _rel(got, ref) <= 2e-2


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("t,deferred", [(1, True), (6, False)])
def test_attend_xla_matches_jax(kind, t, deferred):
    """The einsum route against the JAX package's ``attend_xla`` at head
    dim 64 (the same arithmetic: dequantize to bf16, f32 scores, NEG_INF,
    softmax rounded to bf16): 1e-2, the two frameworks' f32 sums and
    exponentials in another order, each rounded to bf16. Head dim 100 runs
    in test_head_dim_100_model_matches_jax's subprocess."""
    b, h, hkv, d, s_max = 2, 4, 2, 64, 48
    q, (kc, vc), sc = _attn_inputs(7 * t + len(kind), b, t, h, hkv, d, s_max,
                                   kind)
    rng = np.random.default_rng(9)
    past = np.array([2, 30], np.int32)
    mask = np.ones((b, s_max), bool)
    mask[0, :3] = False
    new = [rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
           for _ in range(2)] if deferred else None
    ks, vs = (None, None) if sc is None else sc
    jc = (lambda a: jnp.asarray(a)) if sc else _jnp_bf16
    tc = (lambda a: torch.from_numpy(np.array(a))) if sc else _bf16
    ref = jattn.attend_xla(
        _jnp_bf16(q), jc(kc), jc(vc), jnp.asarray(past), 40,
        jnp.asarray(mask), None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs),
        None if new is None else tuple(_jnp_bf16(x) for x in new))
    got = attention.attend_xla(
        _bf16(q), tc(kc), tc(vc), torch.from_numpy(past), 40,
        torch.from_numpy(mask),
        None if new is None else tuple(_bf16(x) for x in new),
        None if ks is None else torch.from_numpy(np.array(ks)),
        None if vs is None else torch.from_numpy(np.array(vs)))
    assert _rel(got, ref) <= 1e-2


# ----------------------------------------------------------------- models

def _shape(cfg, hidden, heads, kv_heads, head_dim, inter=512):
    cfg.hidden_size = hidden
    cfg.intermediate_size = inter
    cfg.num_attention_heads = heads
    cfg.num_key_value_heads = kv_heads
    cfg.head_dim = head_dim
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 256
    cfg.max_seq_len = 64
    cfg.max_input_len = 64
    cfg.max_attention_size = 64 * 64
    cfg.tuning.attn_len_bucket = 16
    return cfg


def _pair(shape, groupsize, seed, kv="bf16", jax_attn="xla"):
    jc = _shape(JaxConfig(), *shape)
    jc.tuning.matmul_impl = "xla"
    jc.tuning.attn_impl = jax_attn
    jc.tuning.kv_cache_dtype = kv
    jp = jax_synth(jc, groupsize, False, seed)
    pc = _shape(port.ExLlamaConfig(), *shape)
    pc.tuning.kv_cache_dtype = kv
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")


def _take_state(pcache, jcache):
    """The JAX cache's bytes and scales into the port's tensors."""
    for name in ("k", "v", "k_scale", "v_scale"):
        for t, a in zip(getattr(pcache, name) or (),
                        getattr(jcache.state, name) or ()):
            t.copy_(torch.from_numpy(np.array(a)))


def _held(jm, pm, lim_prefill, lim_decode, share_state=False):
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    assert tuple(pcache.k[0].shape) == jcache.state.k[0].shape
    ids = (np.arange(11, dtype=np.int32)[None, :] * 37 + 11) % 256
    steps = [ids] + [np.array([[t]], np.int32) for t in (3, 200, 77)]
    for i, tok in enumerate(steps):
        ref = np.asarray(jm.forward(tok, jcache, last_id_only=i > 0))
        got = pm.forward(tok, pcache, last_id_only=i > 0).numpy()
        lim = lim_decode if i else lim_prefill
        assert np.abs(got - ref).max() <= lim * np.abs(ref).max(), i
        if share_state:
            _take_state(pcache, jcache)


@pytest.mark.parametrize("kv", ["bf16", "int4"])
def test_head_dim_256_model_matches_jax(kv):
    """Two heads of 256 (GQA 2:1): the port's "auto" takes K3 (its plain
    version here), the JAX package on the CPU its einsum path. bf16: 2%
    prefill, 3% decode, the limits of tests/test_torch_model.py. int4: each
    decode step from the JAX cache state at 3%, the prefill at 20% -- the
    limits and the reasons of tests/test_torch_kvcache_model.py (a
    quantizer amplifies a bf16 step of difference into other integers)."""
    jm, pm = _pair((512, 2, 1, 256), 128, 11, kv)
    quantized = kv != "bf16"
    _held(jm, pm, 0.2 if quantized else 0.02, 0.03, share_state=quantized)


def test_groupsize_256_model_matches_jax():
    """Groupsize 256 in every projection, the JAX package's plain matmuls:
    2% prefill, 3% decode."""
    jm, pm = _pair((512, 4, 2, 128), 256, 13)
    assert pm.params.layers[0].down.groupsize == 256
    _held(jm, pm, 0.02, 0.03)


_HD100 = r"""
import jax
import numpy as np
import torch
from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.ops import attention as jattn
import jax.numpy as jnp
import exllama_tpu_torch as port
from exllama_tpu_torch.ops import attention

def shape(cfg):
    cfg.hidden_size = 400          # 4 heads x 100
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 2
    cfg.head_dim = 100
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 256
    cfg.max_seq_len = 64
    cfg.tuning.attn_len_bucket = 16
    return cfg

jc = shape(JaxConfig())
jc.tuning.matmul_impl = "xla"
jp = make_synthetic_params(jc, 16, False, seed=78)
for kind in ("bf16", "int4"):
    jc.tuning.kv_cache_dtype = kind
    jm = JaxModel(jc, params=jp)
    pc = shape(port.ExLlamaConfig())
    pc.tuning.kv_cache_dtype = kind
    assert pc.tuning.attn_impl == "auto"
    pm = port.ExLlama(pc, params=port.params_from_jax(
        jax.tree.map(np.asarray, jp), pc, device="cpu"), device="cpu")
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    assert tuple(pcache.k[0].shape) == jcache.state.k[0].shape
    ids = (np.arange(10, dtype=np.int32)[None] * 3 + 1) % 256
    before = attention.attend.launches
    for i, tok in enumerate([ids, np.array([[9]], np.int32),
                             np.array([[200]], np.int32)]):
        ref = np.asarray(jm.forward(tok, jcache, last_id_only=i > 0))
        got = pm.forward(tok, pcache, last_id_only=i > 0).numpy()
        lim = (0.2 if i == 0 else 0.03) if kind == "int4" else (
            0.03 if i else 0.02)
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel <= lim, (kind, i, rel)
        if kind == "int4":      # each step from the JAX cache state
            for name in ("k", "v", "k_scale", "v_scale"):
                for t, a in zip(getattr(pcache, name),
                                getattr(jcache.state, name)):
                    t.copy_(torch.from_numpy(np.array(a)))
    # a CPU run counts nothing; the route is the plain einsum one
    assert attention.attend.launches == before
    assert attention.resolve_attn_impl("auto", 100) == "xla"

# the einsum route at head dim 100 against the JAX attend_xla
rng = np.random.default_rng(4)
q = rng.normal(size=(2, 5, 4, 100)).astype(np.float32)
kv = rng.normal(size=(2, 2, 2, 48, 100)).astype(np.float32)
new = rng.normal(size=(2, 2, 1, 2, 100)).astype(np.float32)
past = np.array([4, 30], np.int32)
mask = np.ones((2, 48), bool)
mask[0, :3] = False
bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
jb = lambda a: jnp.asarray(a, jnp.bfloat16)
for t, deferred in ((5, False), (1, True)):
    ref = np.asarray(jattn.attend_xla(
        jb(q[:, :t]), jb(kv[0]), jb(kv[1]), jnp.asarray(past), 40,
        jnp.asarray(mask), new_kv=(jb(new[0]), jb(new[1])) if deferred
        else None).astype(jnp.float32))
    got = attention.attend_xla(
        bf(q[:, :t]), bf(kv[0]), bf(kv[1]), torch.from_numpy(past), 40,
        torch.from_numpy(mask), (bf(new[0]), bf(new[1])) if deferred
        else None).float().numpy()
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max(), t
print("HEAD_DIM_100_OK")
"""


def test_head_dim_100_model_matches_jax():
    """OpenLlama-3B's head_dim 100 without padding: the port's "auto" takes
    the einsum route (K3 does not take 100), the JAX package its einsum
    path; bf16: 2% prefill, 3% decode; int4 (which pad_head_dim never
    padded): 20% / 3% from the JAX cache state, as above; the route's
    attention against the JAX attend_xla at 1e-2. In a subprocess, as the
    JAX suite runs its head_dim-100 case (tests/test_attention.py:202):
    XLA's CPU code for the odd widths has unsettled later compiles in the
    same process."""
    r = subprocess.run([sys.executable, "-c", _HD100], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "HEAD_DIM_100_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


# ---------------------------------------------------- gen_tokens and mask

def test_gen_tokens_after_a_masked_begin_is_n_single_tokens_of_jax():
    """B = 2, row 0 left-padded by 3 tokens: the port's ``gen_tokens(n)``
    against n calls of the JAX ``gen_single_token`` (greedy, no repetition
    penalty), which the JAX ``gen_tokens`` docstring declares it equal to
    but whose loop drops the mask. The JAX logits of each step are read
    from a copy of its cache; a step's tokens must agree wherever the JAX
    top-1 margin exceeds 3x the cross-package noise of the prefill logits,
    and the comparison stops where a row's trajectories part on a
    near-tie. The padded row must be checked at least once, and the
    unmasked JAX loop must give that row other logits (the mask matters)."""
    jm, pm = _pair((256, 4, 2, 64), 128, 21, jax_attn="flash_interpret")
    ids = (np.arange(2 * 9, dtype=np.int32).reshape(2, 9) * 13 + 1) % 256
    ids[0, :3] = 0
    mask = np.ones((2, 64), bool)
    mask[0, :3] = False
    n = 6
    pgen = port.ExLlamaGenerator(pm, port.FakeTokenizer(),
                                 port.ExLlamaCache(pm, batch_size=2))
    jgen = JaxGenerator(jm, None, JaxCache(jm, batch_size=2))
    for s in (pgen.settings, jgen.settings):
        s.top_k = 1
        s.token_repetition_penalty_max = 1.0
    jgen.tokenizer = type("T", (), {"bos_token_id": 1,
                                    "eos_token_id": 2})()
    pgen.gen_begin(ids, mask=mask)
    jgen.gen_begin(ids, mask=mask)
    noise_p = pm.forward(ids, port.ExLlamaCache(pm, batch_size=2),
                         input_mask=torch.from_numpy(mask)).numpy()[:, -1]
    noise_j = np.asarray(jm.forward(ids, JaxCache(jm, batch_size=2),
                                    input_mask=mask))[:, -1]
    noise = np.abs(noise_p - noise_j).max()
    ptoks = pgen.gen_tokens(n)
    assert ptoks.shape == (2, n)
    def cache_copy():       # forward donates the cache's buffers
        c = JaxCache(jm, copy_from=jgen.cache)
        c.state = jax.tree.map(lambda a: jnp.array(a, copy=True), c.state)
        return c

    live, checked = [True, True], [0, 0]
    for i in range(n):
        seq = jgen.sequence[:, -1:]
        logits = np.asarray(jm.forward(
            seq, cache_copy(), input_mask=jnp.asarray(mask)))[:, -1]
        unmasked = np.asarray(jm.forward(seq, cache_copy()))[:, -1]
        if i == 0:
            assert np.abs(unmasked[0] - logits[0]).max() > 3 * noise
        jt = jgen.gen_single_token().reshape(-1)
        for r in range(2):
            assert jt[r] == int(logits[r].argmax())
            if not live[r]:
                continue
            top2 = np.sort(logits[r])[-2:]
            if top2[1] - top2[0] > 3 * noise:
                assert ptoks[r, i] == jt[r], (r, i)
                checked[r] += 1
            live[r] = bool(ptoks[r, i] == jt[r])
    assert checked[0] > 0
