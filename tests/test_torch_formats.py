"""The port's config parsing, GPTQ format and checkpoint loading, held
against the JAX package on the same inputs (numpy arrays from one seed)."""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats import gptq as jgptq
from exllama_tpu_torch.config import ExLlamaConfig, TuningParams
from exllama_tpu_torch.formats import gptq


def test_config_parses_written_config_json(tmp_path):
    cfg = {
        "hidden_size": 512, "intermediate_size": 1376,
        "num_attention_heads": 8, "num_key_value_heads": 2,
        "num_hidden_layers": 3, "vocab_size": 1000, "rms_norm_eps": 1e-5,
        "rope_theta": 500000.0, "bos_token_id": 1, "eos_token_id": 2,
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    ours, ref = ExLlamaConfig(str(path)), JaxConfig(str(path))
    for c in (ours, ref):
        c.alpha_value = 2.0
        c.calculate_rotary_embedding_base()
    for f in ("hidden_size", "intermediate_size", "num_attention_heads",
              "num_key_value_heads", "num_hidden_layers", "vocab_size",
              "rms_norm_eps", "rotary_embedding_base", "head_dim",
              "num_key_value_groups", "bos_token_id", "eos_token_id",
              "pad_token_id", "max_seq_len", "max_input_len",
              "max_attention_size", "compress_pos_emb"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.tuning.attn_len_bucket == ref.tuning.attn_len_bucket


@pytest.mark.parametrize("knob,value", [
    ("fuse_mlp", True), ("fuse_attn", True), ("commit_impl", "pallas"),
    ("kv_cache_dtype", "int8"), ("scale_dtype", "f32"),
    ("quantize_lm_head", True),
])
def test_tuning_knob_outside_the_slice_raises(knob, value):
    t = TuningParams()
    setattr(t, knob, getattr(t, knob))       # the slice value is accepted
    with pytest.raises(NotImplementedError):
        setattr(t, knob, value)


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("gs,n", [(32, 256), (64, 520), (128, 520)])
def test_dequantize_equals_jax(gs, n, act_order):
    """Exact (bit-identical f32) dequantized weights and x_map."""
    k = 256
    rng = np.random.default_rng(gs + n + act_order)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.1
    t = gptq.quantize_matrix(w, gs, act_order, np.random.default_rng(1))
    tj = jgptq.quantize_matrix(w, gs, act_order, np.random.default_rng(1))
    for key in t:
        np.testing.assert_array_equal(t[key], tj[key])
    ours = gptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                  t.get("g_idx"))
    ref = jgptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                  t.get("g_idx"))
    np.testing.assert_array_equal(gptq.dequantize(ours), jgptq.dequantize(ref))
    if act_order:
        np.testing.assert_array_equal(ours.x_map.numpy(),
                                      np.asarray(ref.x_map))
    else:
        assert ours.x_map is None and ref.x_map is None


def test_npair_unpack_matches_jax_and_repacks_to_wire():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 16, size=(64, 520), dtype=np.uint8)
    words = jgptq.pack_npair(q)
    np.testing.assert_array_equal(gptq.unpack_npair(words, 520), q)
    np.testing.assert_array_equal(
        gptq.unpack_gptq_qweight(gptq.pack_gptq_qweight(q)), q
    )


def test_import_leaves_out_jax():
    code = (
        "import sys, exllama_tpu_torch, exllama_tpu_torch.generator\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'exllama_tpu' or m.startswith('exllama_tpu.')"
        " or m == 'ml_dtypes']\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _fabricate(tmp_path, act_order):
    from exllama_tpu.utils.fabricate import fabricate

    out = tmp_path / ("ckpt_act" if act_order else "ckpt")
    fabricate(str(out), "tiny", 128, act_order, seed=5, verbose=False)
    return out


@pytest.mark.parametrize("act_order", [False, True])
def test_load_model_params_matches_jax_loader(tmp_path, act_order):
    """A fabricated tiny checkpoint through both loaders: identical weights,
    then prefill logits within 2% of the logit scale."""
    from exllama_tpu.cache import ExLlamaCache as JaxCache
    from exllama_tpu.formats.loader import load_model_params as jax_load
    from exllama_tpu.models.llama import ExLlama as JaxModel

    import exllama_tpu_torch as port

    ckpt = _fabricate(tmp_path, act_order)
    jc = JaxConfig(str(ckpt / "config.json"))
    jc.model_path = str(ckpt)
    jc.max_seq_len = 32
    jc.tuning.matmul_impl = "xla"
    pc = port.ExLlamaConfig(str(ckpt / "config.json"))
    pc.model_path = str(ckpt)
    pc.max_seq_len = 32

    jp = jax_load(jc)
    pp = port.load_model_params(pc, device="cpu")
    assert pc.groupsize == jc.groupsize and pc.act_order == jc.act_order
    conv = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    for a, b in zip(pp.layers, conv.layers):
        for f in ("qkv", "q", "o", "gateup", "gate", "down"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert torch.equal(x.qweight, y.qweight), f
                assert torch.equal(x.zscale, y.zscale), f
    assert torch.equal(pp.lm_head, conv.lm_head)
    assert torch.equal(pp.embed, conv.embed)

    ids = (np.arange(9, dtype=np.int32)[None, :] * 11 + 7) % 32000
    jm = JaxModel(jc, params=jp)
    ref = np.asarray(jm.forward(ids, JaxCache(jm), last_id_only=False))
    pm = port.ExLlama(pc, params=pp, device="cpu")
    got = pm.forward(ids, port.ExLlamaCache(pm), last_id_only=False).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 0.02 * scale
