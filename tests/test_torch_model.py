"""The port's model, cache and generator (plain PyTorch paths on the CPU)
held against the JAX package's ``ExLlama.forward`` in the slice
configuration, on parameters the JAX package built (``params_from_jax``).
Shapes follow ``exllama_tpu.utils.fabricate``'s tiny model."""

import jax
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models.llama import ExLlama as JaxModel

import exllama_tpu_torch as port

VOCAB = 512


def _tiny(cfg, kv_heads=2):
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = kv_heads
    cfg.head_dim = 64
    cfg.num_hidden_layers = 2
    cfg.vocab_size = VOCAB
    cfg.max_seq_len = 64
    cfg.max_input_len = 64
    cfg.max_attention_size = 64 * 64
    cfg.tuning.attn_len_bucket = 16
    return cfg


def _jax_config(**kw):
    c = _tiny(JaxConfig(), **kw)
    # the slice configuration, kernels in interpret mode
    c.tuning.matmul_impl = "pallas_interpret"
    c.tuning.attn_impl = "flash_interpret"
    c.tuning.fuse_mlp = False
    c.tuning.fuse_attn = False
    c.tuning.commit_impl = "xla"
    return c


def _pair(act_order=False, groupsize=128, seed=0, kv_heads=2):
    jc = _jax_config(kv_heads=kv_heads)
    jp = jax_synth(jc, groupsize, act_order, seed)
    pc = _tiny(port.ExLlamaConfig(), kv_heads=kv_heads)
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")


@pytest.mark.parametrize("act_order,groupsize", [(False, 128), (True, 32)])
def test_forward_matches_jax_prefill_and_teacher_forced_decode(
    act_order, groupsize
):
    """Prefill logits within 2% of the logit scale, then 16 teacher-forced
    decode steps compared step by step within 3%: bf16 rounds at other
    places in the two frameworks, and on this model the JAX package's own
    two paths (matmul_impl "pallas" vs "xla") already differ by up to 2.1%
    of the logit scale."""
    jm, pm = _pair(act_order, groupsize)
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    ids = (np.arange(13, dtype=np.int32)[None, :] * 37 + 11) % VOCAB
    ref = np.asarray(jm.forward(ids, jcache, last_id_only=False))
    got = pm.forward(ids, pcache, last_id_only=False).numpy()
    assert got.shape == ref.shape == (1, 13, VOCAB)
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()

    rng = np.random.default_rng(1)
    for step in range(16):
        tok = rng.integers(0, VOCAB, size=(1, 1)).astype(np.int32)
        ref = np.asarray(jm.forward(tok, jcache))
        got = pm.forward(tok, pcache).numpy()
        assert np.abs(got - ref).max() <= 0.03 * np.abs(ref).max(), step
    assert pcache.current_seq_len == jcache.current_seq_len == 29


def test_greedy_tokens_agree_where_the_margin_is_clear():
    """Greedy decoding in both packages, each fed its own tokens: a step's
    token must agree wherever the JAX top-1 margin exceeds 3x the measured
    cross-package logit noise (on random weights the margins are often
    below the noise, so exact trajectories are not a sound check)."""
    jm, pm = _pair(seed=3)
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    ids = (np.arange(8, dtype=np.int32)[None, :] * 29 + 5) % VOCAB
    jl = np.asarray(jm.forward(ids, jcache))[:, -1]
    pl = pm.forward(ids, pcache).numpy()[:, -1]
    checked = 0
    for _ in range(12):
        noise = np.abs(jl - pl).max()
        top2 = np.sort(jl[0])[-2:]
        jt, pt = int(jl.argmax()), int(pl.argmax())
        if top2[1] - top2[0] > 3 * noise:
            assert jt == pt
            checked += 1
        if jt != pt:
            break          # trajectories diverged on a near-tie
        tok = np.array([[jt]], np.int32)
        jl = np.asarray(jm.forward(tok, jcache))[:, -1]
        pl = pm.forward(tok, pcache).numpy()[:, -1]
    assert checked > 0


def test_batched_left_pad_and_chunked_prefill_match_jax():
    """B=2 with a left-pad input_mask, prefilled in chunks of 5 rows; the
    last-token logits of both rows within 2% of the logit scale."""
    jm, pm = _pair(seed=2, kv_heads=4)
    for cfg in (jm.config, pm.config):
        cfg.max_input_len = 10          # 5 rows per chunk at B=2
    ids = (np.arange(2 * 11, dtype=np.int32).reshape(2, 11) * 13 + 1) % VOCAB
    mask = np.zeros((2, 64), bool)
    mask[0, :11] = True
    mask[1, 3:11] = True
    ids[1, :3] = 0
    ref = np.asarray(jm.forward(ids, JaxCache(jm, batch_size=2),
                                input_mask=mask))
    got = pm.forward(ids, port.ExLlamaCache(pm, batch_size=2),
                     input_mask=mask).numpy()
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()


def test_generate_simple_and_cache_reuse():
    """generate_simple runs the prefill -> decode loop on the port, stops
    at max_new_tokens, and gen_begin_reuse keeps the common prefix."""
    _, pm = _pair(seed=4)
    cache = port.ExLlamaCache(pm)
    gen = port.ExLlamaGenerator(pm, port.FakeTokenizer(), cache, seed=0)
    gen.settings.top_k = 1
    text = gen.generate_simple("hello tpu", max_new_tokens=6, loop_chunk=4)
    assert isinstance(text, str)
    assert gen.sequence.shape == (1, 9 + 6)
    assert cache.current_seq_len == 9 + 6 - 1
    first = gen.sequence.copy()

    # same prompt again, greedy: identical continuation from a fresh start
    gen.gen_begin(first[:, :9])
    toks = gen.gen_tokens(6)
    np.testing.assert_array_equal(toks, first[:, 9:])
    reused = gen.gen_begin_reuse(first[:, :12])
    assert reused == 12 and cache.current_seq_len == 11
    gen.gen_rewind(2)
    assert cache.current_seq_len == 9 and gen.sequence.shape == (1, 10)


def test_entry_points_default_to_the_card():
    cfg = _tiny(port.ExLlamaConfig())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        port.make_synthetic_params(cfg)
    params = port.make_synthetic_params(cfg, device="cpu", fast=True)
    with pytest.raises(RuntimeError, match="cuda"):
        port.ExLlama(cfg, params=params)
    assert params.layers[0].qkv.qweight.device.type == "cpu"
