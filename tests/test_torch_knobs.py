"""The knobs that open in this slice, held against the JAX package on the
CPU at the tiny shapes: f32 scales (``scale_dtype="f32"``), a 4-bit lm_head
(``quantize_lm_head``, the argmax head and an odd vocabulary too), the
act-order down projection left unfolded (``fold_act_order=False``) and the
plain path by name (``matmul_impl="xla"``); and the one stated deviation of
the port's KV writes (a per-row cursor outside the cache)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu import model_init as jinit
from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.config import TuningParams as JaxTuning
from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.ops.attention import update_kv_cache as jax_update_kv

import exllama_tpu_torch as port
from exllama_tpu_torch import model_init
from exllama_tpu_torch.config import TuningParams
from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.models.llama import forward_chunk
from exllama_tpu_torch.ops import attention, attn_block, mlp, quant


def _tiny(cfg, vocab=512):
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 2
    cfg.head_dim = 64
    cfg.num_hidden_layers = 2
    cfg.vocab_size = vocab
    cfg.max_seq_len = 64
    cfg.max_input_len = 64
    cfg.max_attention_size = 64 * 64
    cfg.tuning.attn_len_bucket = 16
    return cfg


# knob -> (JAX / port tuning values, act_order, groupsize, vocab, fast draw)
CASES = {
    "scale_f32": (dict(scale_dtype="f32"), False, 64, 512, False),
    "scale_f32_act_order": (dict(scale_dtype="f32"), True, 32, 512, False),
    "quantize_lm_head": (dict(quantize_lm_head=True), False, 64, 512, False),
    "quantize_lm_head_v32001": (dict(quantize_lm_head=True), False, 128,
                                32001, True),
    "fold_act_order_off": (dict(fold_act_order=False), True, 32, 512, False),
}


def _pair(case, seed=0):
    knobs, act, gs, vocab, fast = CASES[case]
    jc = _tiny(JaxConfig(), vocab)
    jc.tuning.matmul_impl = "xla"
    jc.tuning.attn_impl = "xla"
    pc = _tiny(port.ExLlamaConfig(), vocab)
    for k, v in knobs.items():
        setattr(jc.tuning, k, v)
        setattr(pc.tuning, k, v)
    jp = jax_synth(jc, gs, act, seed, fast=fast)
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")


@pytest.mark.parametrize("knob,value", [
    ("scale_dtype", "f32"), ("quantize_lm_head", True),
    ("fold_act_order", False), ("matmul_impl", "xla"),
])
def test_tuning_takes_the_jax_value(knob, value):
    """Every value the JAX package takes (the TPU-only interpret strings
    aside) is taken, read back and set back."""
    t, ref = TuningParams(), JaxTuning()
    assert getattr(t, knob) == getattr(ref, knob)
    default = getattr(t, knob)
    setattr(t, knob, value)
    setattr(ref, knob, value)
    assert getattr(t, knob) == getattr(ref, knob) == value
    setattr(t, knob, default)
    assert getattr(t, knob) == default


@pytest.mark.parametrize("impl", ["pallas_interpret", "pallas_a8t_interpret",
                                  "xla_interpret"])
def test_interpret_strings_still_raise(impl):
    with pytest.raises(NotImplementedError):
        TuningParams().matmul_impl = impl
    with pytest.raises(ValueError):
        TuningParams().scale_dtype = "f16"


@pytest.mark.parametrize("act_order", [False, True])
def test_f32_scales_are_the_jax_bits(act_order):
    """scale_dtype="f32": scales and zscale = (z+1)*s rounded once, to f32,
    bit-equal to the JAX package's; the dequantized weight too."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((256, 96), dtype=np.float32) * 0.02
    t = gptq.quantize_matrix(w, 64, act_order, rng)
    got = gptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                 t.get("g_idx"), scale_dtype="f32")
    ref = jgptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                  t.get("g_idx"), scale_dtype=np.float32)
    assert got.scales.dtype == got.zscale.dtype == torch.float32
    n = got.out_features
    np.testing.assert_array_equal(got.scales.numpy(),
                                  np.asarray(ref.scales)[:, :n])
    np.testing.assert_array_equal(got.zscale.numpy(),
                                  np.asarray(ref.zscale)[:, :n])
    quant.check_qt_tensors(got, torch.device("cpu"))
    np.testing.assert_array_equal(gptq.dequantize(got),
                                  jgptq.dequantize(ref)[:, :n])


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_jax_under_the_knob(case):
    """Prefill logits within 2% of the logit scale and 3 teacher-forced
    decode steps within 3% (the port's logit tolerances: the JAX package's
    own two paths differ by up to 2.1% on this model)."""
    jm, pm = _pair(case)
    knobs, act, *_ = CASES[case]
    lp = pm.params
    if "scale_dtype" in knobs:
        assert lp.layers[0].o.scales.dtype == torch.float32
    if "quantize_lm_head" in knobs:
        assert isinstance(lp.lm_head, gptq.QuantTensor)
        assert lp.lm_head.out_features == pm.config.vocab_size
    if "fold_act_order" in knobs:
        assert lp.layers[0].down.x_map is not None
    vocab = pm.config.vocab_size
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    ids = (np.arange(11, dtype=np.int32)[None, :] * 37 + 11) % vocab
    ref = np.asarray(jm.forward(ids, jcache, last_id_only=False))
    got = pm.forward(ids, pcache, last_id_only=False).numpy()
    assert got.shape == ref.shape == (1, 11, vocab)
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
    rng = np.random.default_rng(1)
    for step in range(3):
        tok = rng.integers(0, vocab, size=(1, 1)).astype(np.int32)
        ref = np.asarray(jm.forward(tok, jcache))
        got = pm.forward(tok, pcache).numpy()
        assert np.abs(got - ref).max() <= 0.03 * np.abs(ref).max(), step


@pytest.mark.parametrize("case", ["quantize_lm_head",
                                  "quantize_lm_head_v32001"])
def test_argmax_head_over_a_4bit_lm_head(case):
    """head_mode="argmax" over a 4-bit lm_head is the argmax of its logits
    (q4_matmul, then argmax, as the JAX package does), and agrees with the
    JAX logits' argmax wherever their top-1 margin exceeds 3x the
    cross-package noise."""
    jm, pm = _pair(case, seed=2)
    cfg = pm.config
    ids = (np.arange(9, dtype=np.int32)[None, :] * 29 + 5) % cfg.vocab_size
    kw = dict(attend_len=16, last_token_only=False, preprocess_only=False,
              heads=cfg.num_attention_heads,
              kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
              eps=cfg.rms_norm_eps)
    tokens = torch.as_tensor(ids)
    logits = forward_chunk(pm.params, port.ExLlamaCache(pm), tokens, 0,
                           None, **kw)
    top = forward_chunk(pm.params, port.ExLlamaCache(pm), tokens, 0, None,
                        head_mode="argmax", **kw)
    assert top.dtype == torch.int32 and top.shape == (1, 9)
    assert torch.equal(top, torch.argmax(logits, dim=-1).to(torch.int32))
    ref = np.asarray(jm.forward(ids, JaxCache(jm), last_id_only=False))[0]
    noise = np.abs(logits.numpy()[0] - ref).max()
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 3 * noise
    assert clear.any()
    np.testing.assert_array_equal(top.numpy()[0][clear],
                                  ref.argmax(-1)[clear])


def test_xla_is_the_plain_path_and_refuses_the_fused_kernels():
    """matmul_impl="xla" runs _q4_matmul_plain (after the norm and act-order
    prologue) on any device, and the fused kernels' gates refuse it, as the
    JAX package's gate refuses its megakernels under "xla"."""
    rng = np.random.default_rng(5)
    t = gptq.quantize_matrix(rng.standard_normal((256, 64), np.float32)
                             * 0.02, 64, True, rng)
    qt = gptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                t["g_idx"])
    x = torch.randn((3, 256)).bfloat16()
    nw = (torch.rand(256) + 0.5).bfloat16()
    assert torch.equal(quant.q4_matmul(x, qt, "xla", norm_w=nw),
                       quant.q4_gemv_plain(x, qt, nw))
    gu = gptq.QuantTensor(torch.zeros((32, 1024), dtype=torch.int32),
                          torch.ones((4, 1024)).bfloat16(),
                          torch.ones((4, 1024)).bfloat16(), None, 64)
    dn = gptq.QuantTensor(torch.zeros((64, 256), dtype=torch.int32),
                          torch.ones((8, 256)).bfloat16(),
                          torch.ones((8, 256)).bfloat16(), None, 64)
    assert mlp.fused_mlp_applicable(gu, dn, 256, 1)
    assert not mlp.fused_mlp_applicable(gu, dn, 256, 1, "xla")
    o = _o_proj(dn, 256)
    assert attn_block.attn_o_applicable(o, 256, 2, 128, 1, True)
    assert not attn_block.attn_o_applicable(o, 256, 2, 128, 1, True,
                                            impl="xla")


def _o_proj(qt, k):
    """A K x 256 tensor of qt's groupsize (o-projection shaped)."""
    return gptq.QuantTensor(torch.zeros((k // 8, 256), dtype=torch.int32),
                            torch.ones((k // qt.groupsize, 256)).bfloat16(),
                            torch.ones((k // qt.groupsize, 256)).bfloat16(),
                            None, qt.groupsize)


def _ns(mod, argv):
    parser = argparse.ArgumentParser()
    mod.add_args(parser)
    return parser.parse_known_args(argv)[0]


@pytest.mark.parametrize("argv", [["--scale_f32"], ["--matmul_impl", "xla"],
                                  ["--scale_f32", "--matmul_impl", "xla"]])
def test_model_init_takes_scale_f32_and_xla(argv, tmp_path):
    """--scale_f32 (which the JAX package's benchmark adds to the JAX
    model_init vocabulary) and --matmul_impl xla give the JAX make_config's
    knobs."""
    path = tmp_path / "config.json"
    path.write_text("{}")
    base = ["-c", str(path), "-m", "x"]
    got = model_init.make_config(_ns(model_init, base + argv))
    jargs = _ns(jinit, base + [a for a in argv if a != "--scale_f32"])
    jargs.scale_f32 = "--scale_f32" in argv
    ref = jinit.make_config(jargs)
    assert got.tuning.scale_dtype == ref.tuning.scale_dtype
    assert got.tuning.matmul_impl == ref.tuning.matmul_impl


@pytest.mark.parametrize("cursors", [[3, 16], [16, -1], [-1, 15]])
def test_row_cursor_outside_the_cache_is_skipped_where_jax_clamps(cursors):
    """The stated deviation (ops/attention._write_at): a [B] cursor outside
    [0, S) leaves the port's row as it was, where the JAX package's vmapped
    dynamic_update_slice writes it over a valid row: a cursor at S or beyond
    is clamped to S - 1, a negative one counts from the end (-1 lands at
    S - 1). Rows inside the cache are written bit-equal by both."""
    b, hkv, s, d = 2, 2, 16, 8
    rng = np.random.default_rng(7)
    kc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    nk = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    nv = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    bf = jnp.bfloat16
    jk, jv, *_ = jax_update_kv(jnp.asarray(kc, bf), jnp.asarray(vc, bf),
                               jnp.asarray(nk, bf), jnp.asarray(nv, bf),
                               jnp.asarray(cursors, jnp.int32))
    pk = torch.from_numpy(kc).bfloat16()
    pv = torch.from_numpy(vc).bfloat16()
    attention.update_kv_cache(pk, pv, torch.from_numpy(nk).bfloat16(),
                              torch.from_numpy(nv).bfloat16(),
                              torch.tensor(cursors, dtype=torch.int32))
    jk = np.asarray(jk.astype(jnp.float32))
    jv = np.asarray(jv.astype(jnp.float32))
    for row, c in enumerate(cursors):
        got_k, got_v = pk[row].float().numpy(), pv[row].float().numpy()
        if 0 <= c < s:
            np.testing.assert_array_equal(got_k, jk[row])
            np.testing.assert_array_equal(got_v, jv[row])
            continue
        clamp = min(max(c + s if c < 0 else c, 0), s - 1)
        old = torch.from_numpy(kc[row]).bfloat16().float().numpy()
        np.testing.assert_array_equal(got_k, old)           # skipped
        assert not np.array_equal(jk[row][:, clamp], old[:, clamp])
        np.testing.assert_array_equal(
            jk[row][:, clamp],
            torch.from_numpy(nk[row, 0]).bfloat16().float().numpy())
