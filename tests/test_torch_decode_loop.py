"""The port's decode loop (``generator.DecodeLoop``: the step that reads its
position from the device, which the card captures as a CUDA graph per
attend-length bucket) on the CPU, where the same step runs eagerly.

Held to the port's own int-cursor path bit for bit (both sides compute the
same integers and the same f32 operations in the same order), and to the
JAX package's ``gen_tokens`` where the margin is clear: every JAX token
lies within 3% of the logit scale of the port's best on the port's own
teacher-forced logits (the two packages' logits sit up to ~2-3% of the
scale apart on this model, tests/test_torch_model.py). Shapes are those of
tests/test_beam_search.py: hidden 256, 2 layers, vocab 260, max_seq_len 96,
attn_len_bucket 32, so a decode from 27 tokens crosses a bucket.
"""

import jax
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.generator import ExLlamaGenerator as JaxGenerator
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.ops import sampling as jsampling
from exllama_tpu.tokenizer import FakeTokenizer as JaxTokenizer

import exllama_tpu_torch as port
from exllama_tpu_torch.benchmark import greedy_decode, greedy_loop
from exllama_tpu_torch.models.llama import forward_chunk
from exllama_tpu_torch.ops.sampling import apply_rep_penalty, rep_penalty_mask

MARGIN = 0.03      # of the logit scale: the two packages' own spread


def _tiny(cfg):
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 4
    cfg.head_dim = 64
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 260
    cfg.max_seq_len = 96
    cfg.tuning.attn_len_bucket = 32
    return cfg


@pytest.fixture(scope="module")
def pair():
    jc = _tiny(JaxConfig())
    jc.tuning.matmul_impl = "xla"
    jp = jax_synth(jc, 128, False, seed=21)
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp),
                              _tiny(port.ExLlamaConfig()), device="cpu")
    return JaxModel(jc, params=jp), pp


def _port_model(pp, **tuning):
    cfg = _tiny(port.ExLlamaConfig())
    for k, v in tuning.items():
        setattr(cfg.tuning, k, v)
    return port.ExLlama(cfg, params=pp, device="cpu")


def _gen(model, seed=0, **settings):
    g = port.ExLlamaGenerator(model, port.FakeTokenizer(),
                              port.ExLlamaCache(model), seed=seed)
    for k, v in settings.items():
        setattr(g.settings, k, v)
    return g


def _ids(n, salt=0):
    return ((np.arange(n, dtype=np.int32)[None, :] * 37 + 11 + salt) % 256
            + 4).astype(np.int32)


def _caches_equal(a, b):
    for x, y in zip(a._tensor_lists(), b._tensor_lists()):
        for s, t in zip(x, y):
            assert torch.equal(s, t)
    assert a.current_seq_len == b.current_seq_len


CONFIGS = {
    "default": {},
    "fuse_qkv+K8": dict(fuse_qkv=True, commit_impl="pallas"),
    "int8": dict(kv_cache_dtype="int8"),
}
SETTINGS = {
    "greedy": dict(top_k=1),
    "sampled": {},             # top-k 40, top-p 0.65, the default penalty
}


@pytest.mark.parametrize("sampling", list(SETTINGS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_loop_on_the_device_cursor_equals_the_int_cursor_path(pair, config,
                                                              sampling):
    """gen_tokens (the step on a [1] tensor cursor and a tensor history
    position) against n gen_single_token calls (model.forward at an int
    cursor, the history written at an int position), from one generator
    seed, across the 32 bucket: tokens, caches and histories bit-equal,
    the device cursor advanced on the device."""
    pm = _port_model(pair[1], **CONFIGS[config])
    ids = _ids(28)
    a = _gen(pm, seed=5, **SETTINGS[sampling])
    b = _gen(pm, seed=5, **SETTINGS[sampling])
    a.gen_begin(ids)
    b.gen_begin(ids)
    got = a.gen_tokens(12)                     # positions 27..38
    ref = np.concatenate([b.gen_single_token() for _ in range(12)], axis=1)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(a.sequence, b.sequence)
    _caches_equal(a.cache, b.cache)
    assert torch.equal(a._seq_buf, b._seq_buf)
    assert int(a.cache.cursor[0]) == 27 + 12
    assert sorted(a._loop.graphs) == []        # the CPU runs it eagerly


def test_loop_reaches_the_last_cache_position(pair):
    """A decode that fills the cache: the last token, of a step at position
    S - 1, lands in the history's spare column and is returned."""
    pm = _port_model(pair[1])
    a, b = _gen(pm, top_k=1), _gen(pm, top_k=1)
    ids = _ids(90)
    a.gen_begin(ids)
    b.gen_begin(ids)
    got = a.gen_tokens(7)                      # positions 89..95
    ref = np.concatenate([b.gen_single_token() for _ in range(7)], axis=1)
    np.testing.assert_array_equal(got, ref)
    assert a.cache.current_seq_len == 96
    with pytest.raises(AssertionError):
        a.gen_tokens(1)


def _teacher_forced_gaps(pm, ids, toks, settings):
    """For each token of ``toks`` [n], fed one after the other after
    ``ids``: how far below the port's best it lies on the port's penalized,
    BOS-banned logits, over the raw logits' scale."""
    g = _gen(pm)
    g.settings = settings
    g.gen_begin(ids)
    s = settings
    gaps = []
    for t in toks:
        logits = pm.forward(g.sequence[:, -1:], g.cache)[:, -1].float()
        lg = apply_rep_penalty(
            logits, g._seq_buf, g.sequence.shape[1],
            s.token_repetition_penalty_max,
            s.token_repetition_penalty_sustain,
            s.token_repetition_penalty_decay)[0]
        lg[g.tokenizer.bos_token_id] -= 10000.0
        gaps.append(float(lg.max() - lg[int(t)])
                    / float(logits.abs().max()))
        g.gen_accept_token([[int(t)]])
        g._sync_seq_buf()
    return np.array(gaps)


@pytest.mark.parametrize("prompt,n", [(28, 12), (60, 10)])
def test_gen_tokens_matches_jax_greedy_where_the_margin_is_clear(pair, prompt,
                                                                 n):
    """JAX gen_tokens (_decode_loop_n, top-k 1) from the same prompt: every
    JAX token is the port's best, or within MARGIN of it, on the port's
    teacher-forced logits; where the port's own tokens agree they are
    equal."""
    jm, pp = pair
    pm = _port_model(pp)
    ids = _ids(prompt, salt=3)
    jg = JaxGenerator(jm, JaxTokenizer(), JaxCache(jm))
    jg.settings.top_k = 1
    jg.gen_begin(ids)
    jtoks = jg.gen_tokens(n)[0]
    g = _gen(pm, top_k=1)
    g.gen_begin(ids)
    ptoks = g.gen_tokens(n)[0]
    gaps = _teacher_forced_gaps(pm, ids, jtoks, g.settings)
    assert gaps.max() <= MARGIN, (gaps, jtoks, ptoks)
    first = np.nonzero(jtoks != ptoks)[0]
    assert first.size == 0 or gaps[first[0]] > 0.0


@pytest.mark.parametrize("seq_len,sustain,decay", [
    (0, 256, 128), (1, 3, 4), (7, 3, 4), (40, 256, 128), (40, -1, 0),
    (64, 3, 4),
])
def test_rep_penalty_mask_tensor_seq_len_is_bit_equal(seq_len, sustain,
                                                      decay):
    """A [1] int32 tensor seq_len (read on the device) against the int one,
    and both against the JAX function: bit-equal (the same f32 values
    scattered by max)."""
    rng = np.random.default_rng(seq_len)
    seq = rng.integers(0, 50, size=(2, 64)).astype(np.int32)
    t = torch.from_numpy(seq)
    by_int = rep_penalty_mask(t, seq_len, 50, 1.15, sustain, decay)
    by_tensor = rep_penalty_mask(
        t, torch.tensor([seq_len], dtype=torch.int32), 50, 1.15, sustain,
        decay)
    ref = np.asarray(jsampling.rep_penalty_mask(
        seq, np.int32(seq_len), 50, 1.15, sustain, decay))
    assert torch.equal(by_int, by_tensor)
    np.testing.assert_array_equal(by_tensor.numpy(), ref)


@pytest.mark.parametrize("attend_len", [None, 96])
def test_greedy_loop_equals_forward_chunk_argmax(pair, attend_len):
    """The benchmark's greedy loop (DecodeLoop, head_mode "argmax", fuse_qkv
    + the K8 commit, at a tensor cursor) against forward_chunk(head_mode=
    "argmax") called at int cursors, from one prefilled cache: tokens and
    caches bit-equal. With attend_len None the loop takes each step's
    bucket, as the generator does."""
    pm = _port_model(pair[1])
    cfg = pm.config
    ids = _ids(28, salt=7)
    caches = []
    for _ in range(2):
        c = port.ExLlamaCache(pm)
        pm.forward(ids[:, :-1], c, preprocess_only=True)
        caches.append(c)
    loop = greedy_loop(pm, caches[0])
    loop.attend_len = attend_len
    past = caches[0].current_seq_len
    got = greedy_decode(loop, torch.from_numpy(ids[:, -1:]), past, 10)
    tok = torch.from_numpy(ids[:, -1:])
    ref = []
    for i in range(10):
        tok = forward_chunk(
            pm.params, caches[1], tok, past + i, None,
            attend_len=attend_len or pm._attend_len(past + i + 1),
            last_token_only=True, preprocess_only=False,
            heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.head_dim, eps=cfg.rms_norm_eps, head_mode="argmax",
            qkv_fuse=True, commit_impl="pallas")
        ref.append(tok)
    caches[1].current_seq_len = past + 10
    assert torch.equal(got, torch.cat(ref, dim=1))
    _caches_equal(caches[0], caches[1])


def test_graphs_are_dropped_when_the_settings_change(pair):
    """The loop's epoch holds what the JAX package makes static: the same
    settings keep the graphs, and so do new sampler values (top-k,
    temperature, top-p, typical while it stays on: device operands), a new
    set of disallowed or constrained tokens and gen_begin; setting a bias
    where there was none, turning typical sampling on, a change of the
    penalty's sustain or of the mask's presence start a new epoch (no graph
    kept), and so does reset. (The CPU runs the step eagerly and captures
    nothing; a held entry stands in for a graph.)"""
    pm = _port_model(pair[1])
    g = _gen(pm, top_k=1)
    g.gen_begin(_ids(20))
    g.gen_tokens(1)
    g._loop.graphs[32] = "held"
    g.gen_tokens(1)
    assert g._loop.graphs == {32: "held"}
    for keep in (lambda: setattr(g.settings, "top_k", 2),
                 lambda: setattr(g.settings, "temperature", 0.5),
                 lambda: setattr(g.settings, "top_p", 0.9),
                 lambda: g.gen_begin(_ids(20))):
        keep()
        g.gen_tokens(1)
        assert g._loop.graphs == {32: "held"}
    for drop in (lambda: g.disallow_tokens([5]),
                 lambda: setattr(g.settings, "typical", 0.2)):
        drop()
        g.gen_tokens(1)
        assert g._loop.graphs == {}
        g._loop.graphs[32] = "held"
    for keep in (lambda: g.disallow_tokens([6]),
                 lambda: g.gen_single_token(constraints=[7, 9]),
                 lambda: setattr(g.settings, "typical", 0.3),
                 lambda: g.gen_begin(_ids(20))):
        keep()
        g.gen_tokens(1)
        assert g._loop.graphs == {32: "held"}
    g.settings.token_repetition_penalty_sustain = 64
    g.gen_tokens(1)
    assert g._loop.graphs == {}
    g._loop.graphs[32] = "held"
    g._mask = torch.ones((1, 96), dtype=torch.bool)
    g.gen_tokens(1)
    assert g._loop.graphs == {}
    loop = g._loop
    g.reset()
    assert g._loop is not loop and g._loop.hist is g._seq_buf
    with pytest.raises(ValueError):           # logits head, no sampler
        g._loop.run(1, torch.zeros((1, 1)), 95, 96, sampler=None)
    with pytest.raises(ValueError):           # past the cache's end
        g._loop.run(2, torch.zeros((1, 1)), 95, 96,
                    sampler=(g.settings, 1))
