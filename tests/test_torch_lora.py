"""LoRA adapters in the port (``lora.ExLlamaLora``, ``ops.quant.lora_delta``,
``forward(..., lora=)``, ``ExLlamaGenerator.lora``) against the JAX package
on the CPU, at tests/test_lora.py's shapes (hidden 256, intermediate 512, 4
heads of 64, 2 layers, vocab 128, max_seq_len 64). Both packages load the
same adapter files, written in the PEFT layout by the port's
``utils.fabricate.fabricate_lora``.

Tolerances: the loaded A / B bit for bit (both round one f32 to bf16);
``lora_delta`` within rtol / atol 2e-2 (tests/test_q4_matmul.py:44); logits
within 3% of the logit scale, the two packages' own spread on this model
(tests/test_torch_beams.py); a zero adapter equal to none within the JAX
test's atol 1e-5 (tests/test_lora.py:70); tokens where the margin is clear.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.generator import ExLlamaGenerator as JaxGenerator
from exllama_tpu.lora import ExLlamaLora as JaxLora
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.ops.quant import lora_delta as jax_lora_delta
from exllama_tpu.tokenizer import FakeTokenizer as JaxTokenizer

import exllama_tpu_torch as port
from exllama_tpu_torch.formats.loader import save_safetensors
from exllama_tpu_torch.lora import LayerLora
from exllama_tpu_torch.models import llama
from exllama_tpu_torch.ops.quant import lora_delta, q4_matmul
from exllama_tpu_torch.ops.sampling import apply_rep_penalty
from exllama_tpu_torch.utils.fabricate import fabricate_lora

MARGIN = 0.03
VOCAB = 128
PROJ = ("q", "k", "v", "o", "gate", "up", "down")
# adapter Q: PEFT's default targets on a Llama model; A: every projection;
# partial: projections adapted on one layer only (zero pairs on the other).
# Scale 0.5 moves the logits (test_nonzero_adapter_changes_the_output); an
# adapter much stronger than that makes another model whose bf16 noise is
# amplified, in the JAX package's own two paths too.
ADAPTERS = {
    "Q": dict(targets=("q", "v"), r=8, alpha=16, scale=0.5),
    "A": dict(targets=PROJ, r=16, alpha=16, scale=0.5),
    "partial": dict(targets={0: ("q", "gate"), 1: ("o", "down")}, r=4,
                    alpha=8, scale=0.5),
}


def _tiny(cfg, head_dim=64):
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = cfg.num_key_value_heads = 256 // head_dim
    cfg.head_dim = head_dim
    cfg.num_hidden_layers = 2
    cfg.vocab_size = VOCAB
    cfg.max_seq_len = 64
    cfg.max_input_len = 64
    cfg.max_attention_size = 64 * 64
    cfg.tuning.attn_len_bucket = 16
    return cfg


# model variants: (JAX / port tuning, act_order)
VARIANTS = {
    "fused": ({}, False),
    "unfused": (dict(fuse_projections=False), False),
    "act-order folded": ({}, True),
    "act-order unfolded": (dict(fold_act_order=False), True),
}


@pytest.fixture(scope="module")
def models():
    """variant -> (JAX model, port model), built once each."""
    built = {}

    def get(variant):
        if variant not in built:
            tuning, act = VARIANTS[variant]
            jc = _tiny(JaxConfig())
            jc.tuning.matmul_impl = "xla"
            pc = _tiny(port.ExLlamaConfig())
            for k, v in tuning.items():
                setattr(jc.tuning, k, v)
                setattr(pc.tuning, k, v)
            jp = jax_synth(jc, 128, act, seed=3)
            pp = port.params_from_jax(
                jax.tree.map(np.asarray, jp), pc, device="cpu",
                down_folds=getattr(jp, "_down_folds", None))
            built[variant] = (JaxModel(jc, params=jp),
                              port.ExLlama(pc, params=pp, device="cpu"))
        return built[variant]

    return get


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """name -> (config path, adapter path), for the 64-wide-head model."""
    root = tmp_path_factory.mktemp("adapters")
    cfg = _tiny(port.ExLlamaConfig())
    out = {name: fabricate_lora(str(root / name), cfg, seed=i, **a)
           for i, (name, a) in enumerate(ADAPTERS.items())}
    out["zero"] = fabricate_lora(str(root / "zero"), cfg, PROJ, r=4,
                                 alpha=8, scale=0.0)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the shapes are tiny and the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


# ------------------------------------------------------------ the loader

@pytest.mark.parametrize("variant", ["fused", "unfused", "act-order folded"])
@pytest.mark.parametrize("adapter", list(ADAPTERS))
def test_loaded_adapters_equal_the_jax_stacked(models, adapters, variant,
                                               adapter):
    """Every pair bit for bit, None where the JAX package has None: the
    transpose, the alpha / r scale in f32, the zero pairs of layers without
    an adapter, and on the folded act-order model the fold's permutation
    of gate / up B columns and down A rows."""
    jm, pm = models(variant)
    if variant == "act-order folded":
        assert any(f is not None for f in pm.params.down_folds)
    jl, pl = JaxLora(jm, *adapters[adapter]), port.ExLlamaLora(
        pm, *adapters[adapter])
    assert pl.lora_scaling == jl.lora_scaling and len(pl.stacked) == 2
    for jlayer, player in zip(jl.stacked, pl.stacked):
        assert isinstance(player, LayerLora)
        for p in PROJ:
            jab, pab = getattr(jlayer, p), getattr(player, p)
            assert (jab is None) == (pab is None), p
            if jab is None:
                continue
            for j, t in zip(jab, pab):
                assert t.dtype == torch.bfloat16 and t.shape == j.shape
                np.testing.assert_array_equal(_bits(t), _bits(j))


def test_the_fold_reaches_the_adapter(models, adapters):
    """On the folded act-order model, adapter A's gate / up B and down A
    are the unfolded model's, permuted by the layer's fold."""
    _, folded = models("act-order folded")
    _, plain = models("act-order unfolded")
    assert all(f is None for f in plain.params.down_folds)
    a = port.ExLlamaLora(folded, *adapters["A"]).stacked
    b = port.ExLlamaLora(plain, *adapters["A"]).stacked
    for li, fold in enumerate(folded.params.down_folds):
        fold = torch.from_numpy(fold)
        assert torch.equal(a[li].gate[1], b[li].gate[1][:, fold])
        assert torch.equal(a[li].up[1], b[li].up[1][:, fold])
        assert torch.equal(a[li].down[0], b[li].down[0][fold, :])
        assert torch.equal(a[li].q[0], b[li].q[0])


def test_bin_adapter_loads_as_the_safetensors_one(models, adapters,
                                                  tmp_path):
    """A torch .bin adapter (read with torch.load(weights_only=True)) gives
    the same pairs as the same tensors in .safetensors."""
    _, pm = models("fused")
    cfgp, path = adapters["partial"]
    from exllama_tpu_torch.formats.loader import SafetensorsFile

    f = SafetensorsFile(path)
    bin_path = str(tmp_path / "adapter_model.bin")
    torch.save({k: torch.from_numpy(np.array(f.get(k))) for k in f.keys()},
               bin_path)
    a = port.ExLlamaLora(pm, cfgp, path).stacked
    b = port.ExLlamaLora(pm, cfgp, bin_path).stacked
    for x, y in zip(a, b):
        for p in PROJ:
            if getattr(x, p) is None:
                assert getattr(y, p) is None
                continue
            for s, t in zip(getattr(x, p), getattr(y, p)):
                assert torch.equal(s, t)


def test_bf16_adapter_loads_as_the_f32_one(models, adapters, tmp_path):
    """An adapter stored in bf16 (as PEFT saves a bf16 model's adapter):
    the port's reader takes the raw bits, so it loads as the same values
    stored in f32."""
    _, pm = models("fused")
    cfgp, path = adapters["Q"]
    from exllama_tpu_torch.formats.loader import SafetensorsFile

    f = SafetensorsFile(path)
    vals = {k: torch.from_numpy(np.array(f.get(k))).to(torch.bfloat16)
            for k in f.keys()}
    f32_path = str(tmp_path / "f32.safetensors")
    save_safetensors({k: v.float().numpy() for k, v in vals.items()},
                     f32_path)
    # the same bits as I16, then the header's dtype renamed to BF16
    i16_path = str(tmp_path / "i16.safetensors")
    save_safetensors({k: v.view(torch.int16).numpy()
                      for k, v in vals.items()}, i16_path)
    with open(i16_path, "rb") as fh:
        n = int.from_bytes(fh.read(8), "little")
        header, data = json.loads(fh.read(n)), fh.read()
    for v in header.values():
        v["dtype"] = "BF16"
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    bf16_path = str(tmp_path / "bf16.safetensors")
    with open(bf16_path, "wb") as fh:
        fh.write(len(head).to_bytes(8, "little") + head + data)
    a = port.ExLlamaLora(pm, cfgp, bf16_path).stacked
    b = port.ExLlamaLora(pm, cfgp, f32_path).stacked
    for x, y in zip(a, b):
        for s, t in zip(x.q + x.v, y.q + y.v):
            assert torch.equal(s, t)


def _write(tmp_path, tensors, config=None):
    cfgp = tmp_path / "adapter_config.json"
    cfgp.write_text(json.dumps(config or {"r": 4, "lora_alpha": 8}))
    path = str(tmp_path / "adapter_model.safetensors")
    save_safetensors(tensors, path)
    return str(cfgp), path


_Q = "base_model.model.model.layers.0.self_attn.q_proj"


@pytest.mark.parametrize("case,match", [
    ("bad shape", "incompatible"),
    ("nonzero bias", "bias"),
    ("fan_in_fan_out", "fan_in_fan_out"),
    ("incomplete pair", "incomplete"),
    ("unsupported key", "unsupported key"),
])
def test_loader_errors(models, tmp_path, case, match):
    """The JAX loader's errors (tests/test_lora.py:85-116), raised by both
    packages on the same file."""
    jm, pm = models("fused")
    z = np.zeros
    tensors, config = {
        "bad shape": ({f"{_Q}.lora_A.weight": z((4, 999), np.float32),
                       f"{_Q}.lora_B.weight": z((256, 4), np.float32)},
                      None),
        "nonzero bias": ({f"{_Q}.bias": np.ones((256,), np.float32)}, None),
        "fan_in_fan_out": ({}, {"r": 4, "lora_alpha": 8,
                                "fan_in_fan_out": True}),
        "incomplete pair": ({f"{_Q}.lora_A.weight": z((4, 256), np.float32)},
                            None),
        "unsupported key": ({"lm_head.lora_A.weight": z((4, 256), np.float32)},
                            None),
    }[case]
    files = _write(tmp_path, tensors, config)
    for model, cls in ((pm, port.ExLlamaLora), (jm, JaxLora)):
        with pytest.raises(ValueError, match=match):
            cls(model, *files)


def test_zero_bias_is_ignored(models, tmp_path):
    _, pm = models("fused")
    files = _write(tmp_path, {
        f"{_Q}.lora_A.weight": np.ones((4, 256), np.float32),
        f"{_Q}.lora_B.weight": np.ones((256, 4), np.float32),
        f"{_Q}.bias": np.zeros((256,), np.float32)})
    lora = port.ExLlamaLora(pm, *files)
    assert lora.bias_ignored and lora.stacked[0].q is not None
    assert lora.stacked[1].q is not None and lora.stacked[0].k is None
    assert not lora.stacked[1].q[0].any()          # the zero-filled layer


# ------------------------------------------------------------ lora_delta

@pytest.mark.parametrize("per_row", [False, True])
def test_lora_delta_matches_jax(per_row):
    """Both forms (one adapter; one a batch row) against the JAX function
    on the same bf16 inputs."""
    rng = np.random.default_rng(11)
    lead = (3,) if per_row else ()
    x = rng.standard_normal((3, 5, 256), np.float32)
    a = rng.standard_normal(lead + (256, 8), np.float32) * 0.1
    b = rng.standard_normal(lead + (8, 384), np.float32) * 0.1
    xb, ab, bb = (jnp.asarray(t, jnp.bfloat16) for t in (x, a, b))
    ref = np.asarray(jax_lora_delta(xb, (ab, bb)).astype(jnp.float32))

    def to_port(t):
        return torch.from_numpy(np.array(t.astype(jnp.float32))).to(
            torch.bfloat16)

    got = lora_delta(to_port(xb), (to_port(ab), to_port(bb)))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 384)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)


def test_q4_matmul_adds_the_low_rank_term_and_refuses_norm_and_glu(models):
    _, pm = models("unfused")
    qt = pm.params.layers[0].q
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 3, 256), generator=g).to(torch.bfloat16)
    ab = (torch.randn((256, 4), generator=g).to(torch.bfloat16),
          torch.randn((4, 256), generator=g).to(torch.bfloat16))
    got = q4_matmul(x, qt, lora=ab)
    assert torch.equal(got, q4_matmul(x, qt) + lora_delta(x, ab))
    with pytest.raises(ValueError):
        q4_matmul(x, qt, norm_w=pm.params.layers[0].input_norm, lora=ab)
    with pytest.raises(ValueError):
        q4_matmul(x, qt, glu=(128, 128), lora=ab)


# ------------------------------------------------------------- the model

def _run(model, lora, steps, jax_side=False):
    """Prefill logits of all 8 tokens, then 3 teacher-forced steps."""
    cache = (JaxCache if jax_side else port.ExLlamaCache)(model)
    out = []
    for i, tok in enumerate(steps):
        lg = model.forward(tok, cache, last_id_only=i > 0, lora=lora)
        out.append(np.asarray(lg, np.float32))
    return out


def _steps():
    rng = np.random.default_rng(5)
    ids = rng.integers(4, VOCAB, size=(1, 8)).astype(np.int32)
    return [ids] + [rng.integers(4, VOCAB, size=(1, 1)).astype(np.int32)
                    for _ in range(3)]


@pytest.mark.parametrize("variant,adapter", [
    ("fused", "Q"), ("fused", "A"), ("unfused", "Q"), ("unfused", "A"),
    ("fused", "partial"), ("act-order folded", "A"),
    ("act-order unfolded", "A"),
])
def test_model_logits_match_jax(models, adapters, variant, adapter):
    """``ExLlama.forward(..., lora=)``: prefill and teacher-forced decode
    logits within 3% of the logit scale of the JAX package's with the same
    adapter, after the adapter has moved the port's logits by more than 3x
    that."""
    jm, pm = models(variant)
    steps = _steps()
    jl = JaxLora(jm, *adapters[adapter])
    pl = port.ExLlamaLora(pm, *adapters[adapter])
    ref = _run(jm, jl, steps, jax_side=True)
    got = _run(pm, pl, steps)
    base = _run(pm, None, steps)
    for r, g, b in zip(ref, got, base):
        scale = np.abs(r).max()
        assert np.abs(g - r).max() <= MARGIN * scale
        assert np.abs(g - b).max() > 3 * MARGIN * scale


def test_zero_adapter_is_no_adapter(models, adapters):
    """Zero pairs on every projection, on the plain route both ways
    (``matmul_impl="xla"`` keeps the fused routes off with or without an
    adapter): the logits of no adapter within 1e-5."""
    _, pm = models("fused")
    cfg = _tiny(port.ExLlamaConfig())
    cfg.tuning.matmul_impl = "xla"
    model = port.ExLlama(cfg, params=pm.params, device="cpu")
    lora = port.ExLlamaLora(model, *adapters["zero"])
    assert lora.lora_scaling == 2.0 and lora.stacked[0].down is not None
    for g, b in zip(_run(model, lora, _steps()), _run(model, None, _steps())):
        np.testing.assert_allclose(g, b, atol=1e-5)


def test_nonzero_adapter_changes_the_output(models, adapters):
    """tests/test_lora.py:73-82 on the port: adapted q and down present,
    k not adapted, the logits move."""
    _, pm = models("fused")
    lora = port.ExLlamaLora(pm, *adapters["partial"])
    assert lora.stacked[0].q is not None and lora.stacked[0].down is not None
    assert lora.stacked[0].k is None
    got, base = _run(pm, lora, _steps()[:1]), _run(pm, None, _steps()[:1])
    assert np.max(np.abs(got[0] - base[0])) > 1e-3


# ------------------------------------------------------------- the gates

ROUTES = ("layer_step", "layer_tail", "attn_block_o", "q4_mlp", "attend")


@pytest.fixture(scope="module")
def gate_model(tmp_path_factory):
    """2 layers of 2 heads of 128 (K7's head_dim), and the adapters for its
    shapes."""
    cfg = _tiny(port.ExLlamaConfig(), head_dim=128)
    params = port.make_synthetic_params(cfg, 128, False, seed=4,
                                        device="cpu")
    root = tmp_path_factory.mktemp("gate_adapters")
    files = {name: fabricate_lora(str(root / name), cfg, targets, r=4)
             for name, targets in (("Q", ("q", "v")), ("A", PROJ),
                                   ("o", ("o",)),
                                   ("mlp", ("gate", "up", "down")))}
    return params, files


# per decode step of 2 layers: which fused routes run (the JAX gates:
# llama.py:199-232 any adapter refuses layer_step; :289 an adapted o
# refuses K7; :297-298, :353-359 an adapted gate / up / down refuses K6
# and K7's MLP), and how many projections take the input norm in their
# prologue (none under an adapted q / k / v, :234-251)
# under a q / k / v adapter the qkv product keeps the input norm in its
# prologue (the adapters read the plainly normed x), as without one, so
# that a row's projection does not depend on its batch-mates' adapters
GATE_ROUTES = {
    (None, False): dict(layer_tail=2, prologue=2),
    (None, True): dict(layer_step=2),
    ("Q", False): dict(layer_tail=2, prologue=2),
    ("Q", True): dict(layer_tail=2, prologue=2),
    ("A", False): dict(attend=2, prologue=2),
    ("A", True): dict(attend=2, prologue=2),
    ("o", True): dict(attend=2, q4_mlp=2, prologue=2),
    ("mlp", True): dict(attn_block_o=2, prologue=2),
}


@pytest.mark.parametrize("adapter,qkv_fuse", list(GATE_ROUTES))
def test_fused_routes_follow_the_jax_gates(gate_model, monkeypatch, adapter,
                                           qkv_fuse):
    """One decode step on the CPU with a spy on the model's fused entry
    points: an adapter keeps off exactly the fused kernels the JAX gates
    refuse, and each adapted projection gets its low-rank term."""
    params, files = gate_model
    cfg = _tiny(port.ExLlamaConfig(), head_dim=128)
    cfg.tuning.fuse_qkv = qkv_fuse
    model = port.ExLlama(cfg, params=params, device="cpu")
    lora = None if adapter is None else port.ExLlamaLora(model,
                                                        *files[adapter])
    cache = port.ExLlamaCache(model)
    model.forward(np.arange(4, 12, dtype=np.int32)[None], cache,
                  preprocess_only=True, lora=lora)
    calls = {k: 0 for k in ROUTES + ("prologue", "adapted")}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(llama, name, wrapped)

    for name in ROUTES:
        spy(name, getattr(llama, name))
    q4 = llama.q4_matmul

    def q4_spy(x, qt, impl="auto", norm_w=None, norm_eps=1e-6, glu=None,
               lora=None):
        calls["prologue"] += norm_w is not None
        calls["adapted"] += lora is not None
        return q4(x, qt, impl, norm_w, norm_eps, glu, lora)

    monkeypatch.setattr(llama, "q4_matmul", q4_spy)
    delta = llama.lora_delta

    def delta_spy(x, ab):
        calls["adapted"] += 1
        return delta(x, ab)

    monkeypatch.setattr(llama, "lora_delta", delta_spy)
    model.forward(np.array([[20]], np.int32), cache, lora=lora)
    want = {k: 0 for k in calls}
    want.update(GATE_ROUTES[(adapter, qkv_fuse)])
    want["adapted"] = 2 * {None: 0, "Q": 2, "A": 7, "o": 1,
                           "mlp": 3}[adapter]
    assert calls == want


# --------------------------------------------------------- the generator

@pytest.fixture(scope="module")
def gen_pair():
    """The JAX and port models of tests/test_torch_beams.py (vocab 260,
    max_seq_len 96), with adapter Q written for them."""
    import tempfile

    def tiny(cfg):
        cfg = _tiny(cfg)
        cfg.vocab_size, cfg.max_seq_len = 260, 96
        cfg.max_input_len, cfg.max_attention_size = 96, 96 * 96
        cfg.tuning.attn_len_bucket = 32
        return cfg

    jc = tiny(JaxConfig())
    jc.tuning.matmul_impl = "xla"
    jp = jax_synth(jc, 128, False, seed=21)
    pc = tiny(port.ExLlamaConfig())
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    jm, pm = JaxModel(jc, params=jp), port.ExLlama(pc, params=pp,
                                                   device="cpu")
    root = tempfile.mkdtemp()
    files = fabricate_lora(root, pc, ("q", "v", "down"), r=8, scale=0.5,
                           seed=7)
    return jm, pm, JaxLora(jm, *files), port.ExLlamaLora(pm, *files)


def _pgen(pm, lora, batch=1, **settings):
    g = port.ExLlamaGenerator(pm, port.FakeTokenizer(),
                              port.ExLlamaCache(pm, batch_size=batch))
    g.lora = lora
    for k, v in settings.items():
        setattr(g.settings, k, v)
    return g


def _jgen(jm, lora, batch=1, **settings):
    g = JaxGenerator(jm, JaxTokenizer(), JaxCache(jm, batch_size=batch))
    g.lora = lora
    for k, v in settings.items():
        setattr(g.settings, k, v)
    return g


def _gaps(pm, lora, ids, toks):
    """Teacher-forced on the port with ``lora``: how far below the best of
    the penalized, BOS-banned logits each of ``toks`` lies, over the raw
    logits' scale."""
    g = _pgen(pm, lora)
    g.gen_begin(ids)
    s = g.settings
    gaps = []
    for t in toks:
        logits = pm.forward(g.sequence[:, -1:], g.cache,
                            lora=lora)[:, -1].float()
        row = apply_rep_penalty(logits, g._seq_buf, g.sequence.shape[1],
                                s.token_repetition_penalty_max,
                                s.token_repetition_penalty_sustain,
                                s.token_repetition_penalty_decay)[0]
        row[g.tokenizer.bos_token_id] -= 10000.0
        gaps.append(float(row.max() - row[int(t)])
                    / float(logits.abs().max()))
        g.gen_accept_token([[int(t)]])
        g._sync_seq_buf()
    return np.array(gaps)


def _ids(n):
    return ((np.arange(n, dtype=np.int32)[None, :] * 37 + 11) % 256
            + 4).astype(np.int32)


def test_gen_tokens_with_an_adapter(gen_pair):
    """``generator.lora`` reaches the decode loop: gen_tokens at top-k 1
    equals gen_single_token step by step bit for bit, differs from the
    adapter-free tokens, and the JAX package's gen_tokens with the same
    adapter lies within the margin of the port's best at every step."""
    jm, pm, jl, pl = gen_pair
    ids = _ids(20)
    g = _pgen(pm, pl, top_k=1)
    g.gen_begin(ids)
    got = g.gen_tokens(8)[0]
    s = _pgen(pm, pl, top_k=1)
    s.gen_begin(ids)
    ref = [int(s.gen_single_token()[0, 0]) for _ in range(8)]
    assert got.tolist() == ref
    plain = _pgen(pm, None, top_k=1)
    plain.gen_begin(ids)
    assert plain.gen_tokens(8)[0].tolist() != ref
    j = _jgen(jm, jl, top_k=1)
    j.gen_begin(ids)
    jt = j.gen_tokens(8)[0]
    assert _gaps(pm, pl, ids, jt).max() <= MARGIN


def test_decode_loop_drops_its_graphs_when_the_adapter_changes(gen_pair):
    """The adapter's identity is part of the loop's epoch: the same adapter
    keeps the graphs, another one (or none) drops them. (The CPU runs the
    step eagerly and captures nothing; a held entry stands in for a
    graph.)"""
    _, pm, _, pl = gen_pair
    g = _pgen(pm, pl, top_k=1)
    g.gen_begin(_ids(20))
    g.gen_tokens(1)
    g._loop.graphs[32] = "held"
    g.gen_tokens(1)
    assert g._loop.graphs == {32: "held"} and g._loop.lora is pl.stacked
    other = port.ExLlamaLora(pm, pl.lora_config_path, pl.lora_path)
    for lora in (other, None, pl):
        g.lora = lora
        g.gen_tokens(1)
        assert g._loop.graphs == {}
        g._loop.graphs[32] = "held"


def test_beam_search_with_an_adapter(gen_pair):
    """Beam search at top-k 1 under an adapter is the port's greedy under
    it, bit for bit, and its tokens lie within the margin of the port's
    best; the JAX package's beams under the same adapter too."""
    jm, pm, jl, pl = gen_pair
    ids = _ids(24)
    toks = {}
    for name, g in (("port", _pgen(pm, pl, top_k=1, beams=3, beam_length=3)),
                    ("jax", _jgen(jm, jl, top_k=1, beams=3, beam_length=3))):
        g.gen_begin(ids)
        g.begin_beam_search()
        toks[name] = [int(g.beam_search()[0, 0]) for _ in range(6)]
        g.end_beam_search()
    greedy = _pgen(pm, pl, top_k=1)
    greedy.gen_begin(ids)
    assert toks["port"] == [int(greedy.gen_single_token()[0, 0])
                            for _ in range(6)]
    assert _gaps(pm, pl, ids, toks["jax"]).max() <= MARGIN


def test_cfg_with_an_adapter(gen_pair):
    """generate_cfg under an adapter (alpha 0.3, top-k 1): the JAX tokens,
    each within the margin of the port's best teacher-forced mixed
    log-softmax (the port's own tokens equal where the margin is clear)."""
    jm, pm, jl, pl = gen_pair
    prompts = ["a cheerful story", "a sad one"]
    jg, pg = _jgen(jm, jl, batch=2, top_k=1), _pgen(pm, pl, batch=2, top_k=1)
    jg.generate_cfg(prompts, 0.3, 8)
    pg.generate_cfg(prompts, 0.3, 8)
    assert pg.sequence.shape == jg.sequence.shape
    jtoks, ptoks = jg.sequence[0, -8:], pg.sequence[0, -8:]

    s = pg.settings
    ids, mask = port.FakeTokenizer().encode(prompts, return_mask=True)
    g = _pgen(pm, pl, batch=2, top_k=1)
    full = np.zeros((2, 96), bool)
    full[:, :ids.shape[1]] = mask
    g.gen_begin(ids, mask=full)
    gaps = []
    for t in jtoks:
        logits = pm.forward(g.sequence[:, -1:], g.cache, input_mask=g._mask,
                            lora=pl)[:, -1].float()
        lg = apply_rep_penalty(logits, g._seq_buf, g.sequence.shape[1],
                               s.token_repetition_penalty_max,
                               s.token_repetition_penalty_sustain,
                               s.token_repetition_penalty_decay)
        lp = torch.log_softmax(lg, dim=-1)
        mixed = 0.7 * lp[0] + 0.3 * lp[1]
        gaps.append(float(mixed.max() - mixed[int(t)])
                    / float(logits.abs().max()))
        g.gen_accept_token(np.array([[t], [t]], np.int32))
        g._sync_seq_buf()
    assert max(gaps) <= MARGIN, (gaps, jtoks, ptoks)
    first = np.nonzero(jtoks != ptoks)[0]
    assert first.size == 0 or gaps[first[0]] > 0.0
