"""The port's speculative decoding (``speculative.SpeculativeGenerator``,
``NgramProposer``, ``DraftModelProposer``) on the CPU, at
tests/test_speculative.py's shapes (hidden 256, 2 layers, vocab 128,
max_seq_len 128, groupsize 32).

Held bit for bit: the n-gram lookup against the JAX proposer's, and the
tokens of speculative greedy against the port's own one-token greedy (the
verify forward's T = k + 1 rows sit within 1e-4 of the logit scale of the
one-token steps' logits: the plain products sum in another order at
another row count). Against the JAX package's greedy where the margin is
clear: each JAX token within 3% of the logit scale of the port's best on
the port's own teacher-forced logits (tests/test_torch_beams.py).
"""

import jax
import numpy as np
import pytest
import torch

from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.speculative import NgramProposer as JaxNgram
from exllama_tpu.cache import ExLlamaCache as JaxCache

import exllama_tpu_torch as port
from exllama_tpu_torch.speculative import (
    DraftModelProposer,
    NgramProposer,
    SpeculativeGenerator,
)

MARGIN = 0.03
VOCAB = 128


def _tiny(cfg):
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 4
    cfg.head_dim = 64
    cfg.num_hidden_layers = 2
    cfg.vocab_size = VOCAB
    cfg.max_seq_len = 128
    cfg.max_input_len = 128
    cfg.max_attention_size = 128 * 128
    cfg.tuning.attn_len_bucket = 16
    return cfg


def _pair(seed):
    jc = _tiny(JaxConfig())
    jc.tuning.matmul_impl = "xla"
    jp = jax_synth(jc, 32, False, seed=seed)
    pc = _tiny(port.ExLlamaConfig())
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the shapes are tiny and the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _pair(0)


def greedy_reference(model, ids, n, jax_side=False):
    """One-token-at-a-time greedy continuation (the port's, or the JAX
    package's)."""
    cache = (JaxCache if jax_side else port.ExLlamaCache)(model)
    seq = list(map(int, ids))
    if len(seq) > 1:
        model.forward(np.asarray(seq[:-1], np.int32)[None], cache,
                      preprocess_only=True)
    for _ in range(n):
        lg = model.forward(np.asarray(seq[-1:], np.int32)[None], cache)
        seq.append(int(np.argmax(np.asarray(lg[0, -1], np.float32))))
    return np.asarray(seq, np.int32)


IDS = (np.arange(8, dtype=np.int32) * 5 + 2) % VOCAB


@pytest.fixture(scope="module")
def ref16(pair):
    """The port's greedy continuation of IDS, 16 tokens."""
    return greedy_reference(pair[1], IDS, 16)


def _gaps(model, ids, toks):
    """Teacher-forced one token at a time on the port after ``ids``: how
    far below the best logit each of ``toks`` lies, over the scale."""
    cache = port.ExLlamaCache(model)
    model.forward(np.asarray(ids[:-1], np.int32)[None], cache,
                  preprocess_only=True)
    last, gaps = int(ids[-1]), []
    for t in toks:
        lg = model.forward(np.array([[last]], np.int32), cache)[0, -1]
        gaps.append(float(lg.max() - lg[int(t)]) / float(lg.abs().max()))
        last = int(t)
    return np.array(gaps)


def _sgen(model, proposer, seed=0, **settings):
    g = SpeculativeGenerator(model, port.FakeTokenizer(),
                             port.ExLlamaCache(model), proposer, seed=seed)
    g.settings.top_k = 1
    for k, v in settings.items():
        setattr(g.settings, k, v)
    return g


# -------------------------------------------------------------- proposer

@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 1),
                                       ("repetitive", 2), ("repetitive", 3),
                                       ("short", 4)])
def test_ngram_lookup_equals_jax(kind, seed):
    """The vectorized lookup against the JAX proposer's, bit for bit, for
    every prefix length of a sequence and every draft length."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        seq = rng.integers(0, 6, size=80).astype(np.int32)
    elif kind == "repetitive":
        pat = rng.integers(0, 50, size=7)
        seq = np.concatenate([np.tile(pat, 9), rng.integers(0, 50, size=5)])
        seq = seq.astype(np.int32)
    else:
        seq = rng.integers(0, 3, size=6).astype(np.int32)
    for max_ngram, max_draft in ((3, 8), (2, 4), (1, 3)):
        p = NgramProposer(max_ngram=max_ngram, max_draft=max_draft)
        j = JaxNgram(max_ngram=max_ngram, max_draft=max_draft)
        for t in range(1, len(seq) + 1):
            for k in (0, 1, 5, 8):
                got, ref = p.propose(seq[:t], k), j.propose(seq[:t], k)
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, ref)


def test_ngram_proposer_matches_history():
    p = NgramProposer(max_ngram=2, max_draft=4)
    seq = np.asarray([5, 6, 7, 8, 9, 5, 6], np.int32)
    np.testing.assert_array_equal(p.propose(seq, 4), [7, 8, 9, 5])
    assert len(p.propose(np.asarray([1, 2, 3], np.int32), 4)) == 0


# ------------------------------------------------------------- generator

def test_speculative_greedy_equals_plain_greedy_and_jax(pair):
    """On a prompt that repeats (the n-gram proposer drafts): the port's
    speculative greedy tokens are its one-token greedy tokens bit for bit,
    in no more forwards than tokens; the JAX package's greedy tokens (which
    its speculative greedy equals, tests/test_speculative.py) lie within
    the margin of the port's best."""
    jm, pm = pair
    ids = np.tile((np.arange(10, dtype=np.int32) * 7 + 3) % VOCAB, 3)
    ref = greedy_reference(pm, ids, 16)
    gen = _sgen(pm, NgramProposer())
    got = gen.generate_tokens(ids, 16)
    np.testing.assert_array_equal(got, ref)
    assert gen.stats["tokens"] == 16 and gen.stats["forwards"] <= 16
    assert gen.stats["drafted"] > 0
    jtoks = greedy_reference(jm, ids, 16, jax_side=True)[len(ids):]
    gaps = _gaps(pm, ids, jtoks)
    assert gaps.max() <= MARGIN
    first = np.nonzero(jtoks != got[len(ids):])[0]
    assert first.size == 0 or gaps[first[0]] > 0.0


def test_verify_forward_rows_equal_one_token_steps(pair):
    """The verify forward's k + 1 rows at a nonzero cursor give the logits
    of k + 1 one-token steps over the same tokens (the property the
    exact-match acceptance rests on), within 1e-4 of the logit scale on
    the CPU's plain path: f32 sums in another order, no bf16 step."""
    _, pm = pair
    ids = (np.arange(20, dtype=np.int32) * 5 + 2) % VOCAB
    a, b = port.ExLlamaCache(pm), port.ExLlamaCache(pm)
    for c in (a, b):
        pm.forward(ids[None, :14], c, preprocess_only=True)
    rows = pm.forward(ids[None, 14:20], a, last_id_only=False)
    steps = torch.cat([pm.forward(ids[None, i:i + 1], b)
                       for i in range(14, 20)], dim=1)
    assert rows.shape == steps.shape == (1, 6, VOCAB)
    assert (rows - steps).abs().max() <= 1e-4 * steps.abs().max()


def test_draft_model_proposer_self_draft_accepts_everything(pair, ref16):
    _, pm = pair
    gen = _sgen(pm, DraftModelProposer(pm, max_draft=4))
    got = gen.generate_tokens(IDS, 16)
    np.testing.assert_array_equal(got, ref16)
    assert gen.acceptance_rate == 1.0
    assert gen.stats["forwards"] < 16


def test_draft_model_of_another_seed_keeps_the_output(pair, ref16):
    """A draft model that is not the target (other weights) changes the
    acceptance, never the greedy tokens."""
    _, pm = pair
    cfg = _tiny(port.ExLlamaConfig())
    draft = port.ExLlama(cfg, params=port.make_synthetic_params(
        cfg, 32, False, seed=5, device="cpu"), device="cpu")
    gen = _sgen(pm, DraftModelProposer(draft, max_draft=3))
    np.testing.assert_array_equal(gen.generate_tokens(IDS, 16), ref16)
    assert gen.stats["drafted"] > 0 and gen.acceptance_rate < 1.0


def test_speculative_stop_token(pair, ref16):
    _, pm = pair
    stop_tok = int(ref16[len(IDS) + 5])
    gen = _sgen(pm, NgramProposer())
    got = gen.generate_tokens(IDS, 30, stop_tokens=(stop_tok,))
    assert int(got[-1]) == stop_tok
    assert stop_tok not in got[len(IDS):-1].tolist()
    np.testing.assert_array_equal(got, ref16[:len(got)])


def test_speculative_sampled_runs(pair):
    """Sampled (temperature 1, top-k off): the right length, tokens in the
    vocabulary, and one seed's run repeats bit for bit."""
    _, pm = pair
    ids = (np.arange(8, dtype=np.int32) * 3 + 1) % VOCAB
    runs = []
    for _ in range(2):
        gen = _sgen(pm, NgramProposer(), seed=7, temperature=1.0, top_k=0)
        runs.append(gen.generate_tokens(ids, 12))
    got = runs[0]
    assert len(got) == len(ids) + 12
    assert np.all((got >= 0) & (got < VOCAB))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_generate_simple_decodes_text(pair):
    _, pm = pair
    gen = _sgen(pm, NgramProposer())
    text = gen.generate_simple("abcabcabc", max_new_tokens=8)
    assert isinstance(text, str) and text.startswith("abcabcabc")
    assert gen.stats["tokens"] <= 8
