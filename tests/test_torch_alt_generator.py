"""The port's streaming generator (``alt_generator.ExLlamaAltGenerator``),
its stop-string split (``utils.streaming``) and ``globals`` against the JAX
package on the CPU, at tests/test_alt_generator.py's shapes (hidden 256, 2
layers, vocab 260, max_seq_len 96).

The cases of tests/test_alt_generator.py run on the port; its greedy text
is held against the JAX package's where the margin is clear (each JAX
token within 3% of the logit scale of the port's best on the port's own
teacher-forced logits, the two packages' spread on this model,
tests/test_torch_beams.py). The split and the affinity parsing are pure
Python: equal to the JAX functions' results.
"""

import os

import jax
import numpy as np
import pytest
import torch

from exllama_tpu import globals as jax_globals
from exllama_tpu.alt_generator import ExLlamaAltGenerator as JaxAltGenerator
from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.lora import ExLlamaLora as JaxLora
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.tokenizer import FakeTokenizer as JaxTokenizer
from exllama_tpu.utils.streaming import (
    split_on_stop_strings as jax_split,
)

import exllama_tpu_torch as port
from exllama_tpu_torch import globals as port_globals
from exllama_tpu_torch.alt_generator import ExLlamaAltGenerator
from exllama_tpu_torch.ops.sampling import apply_rep_penalty
from exllama_tpu_torch.utils.fabricate import fabricate_lora
from exllama_tpu_torch.utils.streaming import split_on_stop_strings

MARGIN = 0.03


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
    jp = jax_synth(jc, 128, False, seed=9)
    pc = _tiny(port.ExLlamaConfig())
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")


@pytest.fixture(scope="module")
def agen(pair):
    pm = pair[1]
    return ExLlamaAltGenerator(pm, port.FakeTokenizer(),
                               port.ExLlamaCache(pm))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the shapes are tiny and the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _greedy():
    return ExLlamaAltGenerator.Settings(temperature=1.0, top_k=1)


# ------------------------------------ tests/test_alt_generator.py, ported

def test_generate_respects_max_new_tokens(agen):
    out = agen.generate("hello ", stop_conditions=[], max_new_tokens=6,
                        gen_settings=_greedy())
    # byte tokenizer: 1 token = 1 byte (modulo replacement chars)
    assert 0 < len(out) <= 6 * 3
    assert agen.sequence_ids.shape[1] == port.FakeTokenizer().encode(
        "hello ").shape[1] + 6


def test_stop_string_never_leaks(agen):
    """A substring of the greedy text as a stop string: the text before
    it, and nothing of it."""
    s = _greedy()
    full = agen.generate("abc", stop_conditions=[], max_new_tokens=12,
                         gen_settings=s)
    assert len(full) >= 4
    stop = full[2:4]
    out = agen.generate("abc", stop_conditions=[stop], max_new_tokens=12,
                        gen_settings=s)
    assert stop not in out
    assert out == full.split(stop)[0]


def test_stop_token(agen):
    s = _greedy()
    agen.generate("xyz", stop_conditions=[], max_new_tokens=8,
                  gen_settings=s)
    first_id = int(agen.sequence_ids[0, -8])
    out = agen.generate("xyz", stop_conditions=[first_id], max_new_tokens=8,
                        gen_settings=s)
    assert out == ""


def test_streaming_matches_generate(agen):
    s = _greedy()
    full = agen.generate("stream me", stop_conditions=[" q"],
                         max_new_tokens=8, gen_settings=s)
    agen.begin_stream("stream me", [" q"], 8, s)
    chunks = []
    while True:
        c, eos = agen.stream()
        chunks.append(c)
        if eos:
            break
    assert "".join(chunks) == full


def test_prompt_truncation(agen):
    s = _greedy()
    agen.generate("a" * 200, [], max_new_tokens=4, gen_settings=s)
    assert agen.sequence_ids.shape[1] <= agen.model.config.max_seq_len
    # the prompt kept is its last max_seq_len - max_new_tokens tokens
    assert agen.sequence_ids.shape[1] == agen.model.config.max_seq_len


# ------------------------------------------------------- against the JAX

def _forced_gaps(pm, lora, ids, toks, sustain=-1, decay=0):
    """Teacher-forced on the port after ``ids``: how far below the best of
    the penalized (the alt generator's defaults: the whole context at
    1.15), BOS-banned logits each of ``toks`` lies, over the logits'
    scale."""
    cache = port.ExLlamaCache(pm)
    pm.forward(ids[:, :-1], cache, preprocess_only=True, lora=lora)
    seq = ids.copy()
    gaps = []
    for t in toks:
        logits = pm.forward(seq[:, -1:], cache, lora=lora)[:, -1].float()
        hist = torch.from_numpy(seq.astype(np.int32))
        row = apply_rep_penalty(logits, hist, seq.shape[1], 1.15, sustain,
                                decay)[0]
        row[port.FakeTokenizer.bos_token_id] -= 10000.0
        gaps.append(float(row.max() - row[int(t)])
                    / float(logits.abs().max()))
        seq = np.concatenate([seq, [[int(t)]]], axis=1).astype(np.int32)
    return np.array(gaps)


@pytest.mark.parametrize("adapter", [False, True])
def test_greedy_generate_matches_jax(pair, tmp_path, adapter):
    """``generate`` at top-k 1, with and without adapter Q in
    ``Settings.lora``: the JAX generator's tokens lie within the margin of
    the port's best, and the port's equal them up to the first step where
    the margin is not clear."""
    jm, pm = pair
    jl = pl = None
    if adapter:
        files = fabricate_lora(str(tmp_path), pm.config, ("q", "v"), r=8,
                               scale=0.5)
        jl, pl = JaxLora(jm, *files), port.ExLlamaLora(pm, *files)
    runs = {}
    for name, cls, model, cache, lora in (
            ("jax", JaxAltGenerator, jm, JaxCache, jl),
            ("port", ExLlamaAltGenerator, pm, port.ExLlamaCache, pl)):
        tok = JaxTokenizer() if name == "jax" else port.FakeTokenizer()
        g = cls(model, tok, cache(model))
        s = cls.Settings(temperature=1.0, top_k=1)
        s.lora = lora
        text = g.generate("the prompt", [], max_new_tokens=10,
                          gen_settings=s)
        runs[name] = (text, np.asarray(g.sequence_ids))
    jtoks, ptoks = runs["jax"][1][0, -10:], runs["port"][1][0, -10:]
    ids = port.FakeTokenizer().encode("the prompt")
    gaps = _forced_gaps(pm, pl, ids, jtoks)
    assert gaps.max() <= MARGIN, (gaps, jtoks, ptoks)
    first = np.nonzero(jtoks != ptoks)[0]
    assert first.size == 0 or gaps[first[0]] > 0.0
    if first.size == 0:
        assert runs["jax"][0] == runs["port"][0]


def test_disallowed_tokens_are_never_drawn(agen):
    """The settings' disallowed tokens get -inf in the sampler's bias: at
    top-k 1 the greedy token of the first step, disallowed, is never
    drawn, and sampling at temperature 1 avoids the whole set."""
    s = _greedy()
    agen.generate("ban", [], max_new_tokens=1, gen_settings=s)
    first = int(agen.sequence_ids[0, -1])
    s.disallowed_tokens = [first]
    agen.generate("ban", [], max_new_tokens=4, gen_settings=s)
    assert first not in agen.sequence_ids[0, -4:].tolist()
    wide = ExLlamaAltGenerator.Settings(temperature=1.0, top_k=0, top_p=0.0)
    wide.disallowed_tokens = list(range(0, 260, 2))
    agen.generate("ban", [], max_new_tokens=8, gen_settings=wide)
    assert all(t % 2 for t in agen.sequence_ids[0, -8:].tolist())


def test_reuse_feeds_only_the_new_tokens(agen):
    """A second prompt extending the first reuses the cache: the cache
    holds the shared prefix before the new tokens are fed."""
    s = _greedy()
    agen.begin_stream("shared prefix", [], 4, s)
    fed = []
    forward = agen.model.forward

    def spy(ids, cache, **kw):
        fed.append(np.asarray(ids).shape[1])
        return forward(ids, cache, **kw)

    agen.model.forward = spy
    try:
        agen.begin_stream("shared prefix and more", [], 4, s)
    finally:
        del agen.model.forward
    assert fed == [len(" and more")]
    assert agen.cache.current_seq_len == len("shared prefix and more") - 1


def test_tokenizer_cache_is_bounded(agen, monkeypatch):
    from exllama_tpu_torch import alt_generator

    monkeypatch.setattr(alt_generator, "MAX_CACHED_STRINGS", 3)
    agen.tokenizer_cache.clear()
    for text in ("a", "b", "c", "d"):
        agen.cached_tokenize(text)
    assert list(agen.tokenizer_cache) == ["b", "c", "d"]
    assert agen.get_num_tokens("b") == 1 and len(agen.tokenizer_cache) == 3


# ----------------------------------------- utils.streaming and globals

SPLITS = [
    ("hello world", [], False),
    ("hello world", ["world"], False),
    ("hello wor", ["world"], False),
    ("hello wor", ["word", "wormhole"], False),
    ("abcabc", ["ca"], False),
    ("abc", ["abcd"], False),
    ("Hello WORLD", ["world"], True),
    ("Hello WOR", ["world"], True),
    ("Hello WOR", ["world"], False),
    ("x</s", ["</s>", "\n\n"], False),
    ("x\n", ["</s>", "\n\n"], False),
    ("", ["a"], False),
    ("stop stop", ["stop"], False),
    ("ab", ["b", "ab"], False),
]


@pytest.mark.parametrize("text,stops,fold", SPLITS)
def test_split_on_stop_strings_matches_jax(text, stops, fold):
    got = split_on_stop_strings(text, stops, fold_case=fold)
    assert got == jax_split(text, stops, fold_case=fold)
    safe, held, matched = got
    if not matched:
        assert safe + held == text


@pytest.mark.parametrize("spec", ["0,1,2", "3", "", None, "2,2,0"])
def test_set_affinity_str_matches_jax(monkeypatch, spec):
    calls = {}
    for mod in (port_globals, jax_globals):
        seen = []
        monkeypatch.setattr(os, "sched_setaffinity",
                            lambda pid, mask: seen.append((pid, set(mask))),
                            raising=False)
        mod.affinity_mask = None
        mod.set_affinity_str(spec)
        calls[mod.__name__] = (seen, mod.affinity_mask)
        mod.affinity_mask = None
    assert calls["exllama_tpu_torch.globals"] == calls["exllama_tpu.globals"]
