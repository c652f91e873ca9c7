"""The rest of the port's generator against the JAX package on the CPU: beam
search (beams as the batch of a second cache, its rows gathered by
parent), classifier-free guidance, constraints, ``sample_current`` and the
host-side bookkeeping (prunes, ``gen_num_tokens``, ``replace_last_token``,
``sequence_ends_with``, ``gen_begin_empty``). These mirror
tests/test_beam_search.py, at its shapes (hidden 256, 2 layers, vocab 260,
max_seq_len 96, attn_len_bucket 32).

Tolerances: bit-equal where both packages compute integers or copy bytes
(the cache's row gather and cut, the logit bias, the bookkeeping); tokens
where the margin is clear -- each JAX token within 3% of the logit scale
of the port's best on the port's own teacher-forced scores, the two
packages' spread on this model (tests/test_torch_model.py) -- and equal
to the port's own greedy tokens, bit for bit, where the port decides
both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.cache import KVCacheState, _map_state
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.generator import ExLlamaGenerator as JaxGenerator
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.tokenizer import FakeTokenizer as JaxTokenizer

import exllama_tpu_torch as port
from exllama_tpu_torch.ops.sampling import apply_rep_penalty

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
    jp = jax_synth(jc, 128, False, seed=21)
    pc = _tiny(port.ExLlamaConfig())
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")


def _jgen(jm, seed=0, batch=1, **settings):
    g = JaxGenerator(jm, JaxTokenizer(), JaxCache(jm, batch_size=batch),
                     seed=seed)
    for k, v in settings.items():
        setattr(g.settings, k, v)
    return g


def _pgen(pm, seed=0, batch=1, **settings):
    g = port.ExLlamaGenerator(pm, port.FakeTokenizer(),
                              port.ExLlamaCache(pm, batch_size=batch),
                              seed=seed)
    for k, v in settings.items():
        setattr(g.settings, k, v)
    return g


def _ids(text):
    return port.FakeTokenizer().encode(text)


def _gaps(pm, ids, toks, score=None):
    """Teacher-forced after ``ids``, one token of ``toks`` at a time: how
    far below the port's best each lies, over the raw logits' scale, on
    ``score(logits, generator)`` (default: the penalized, BOS-banned
    logits of row 0)."""
    g = _pgen(pm)
    g.gen_begin(ids)
    s = g.settings
    gaps = []
    for t in toks:
        logits = pm.forward(g.sequence[:, -1:], g.cache,
                            input_mask=g._mask)[:, -1].float()
        if score is None:
            row = apply_rep_penalty(
                logits, g._seq_buf, g.sequence.shape[1],
                s.token_repetition_penalty_max,
                s.token_repetition_penalty_sustain,
                s.token_repetition_penalty_decay)[0]
            row[g.tokenizer.bos_token_id] -= 10000.0
        else:
            row = score(logits, g)
        gaps.append(float(row.max() - row[int(t)])
                    / float(logits.abs().max()))
        g.gen_accept_token([[int(t)]])
        g._sync_seq_buf()
    return np.array(gaps)


# ---------------------------------------------------- the beam cache's rows

def _cache_pair(kind, batch=3, seed=0, s_max=16):
    """A JAX cache and a port cache (2 layers, 2 kv heads, head_dim 64)
    holding the same random bytes."""
    jdtype = {"bf16": jnp.bfloat16, "int8": jnp.int8, "int4": "int4"}[kind]
    jc = JaxCache(shape=(2, batch, s_max, 2, 64), dtype=jdtype)
    cfg = port.ExLlamaConfig()
    cfg.num_hidden_layers, cfg.num_key_value_heads = 2, 2
    cfg.head_dim, cfg.max_seq_len = 64, s_max
    cfg.tuning.kv_cache_dtype = kind

    class _Model:
        config = cfg
        device = torch.device("cpu")

    pc = port.ExLlamaCache(_Model(), batch_size=batch)
    rng = np.random.default_rng(seed)
    state = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        held = getattr(pc, name)
        if held is None:
            state[name] = None
            continue
        arrays = []
        for t in held:
            if t.dtype == torch.int8:
                a = rng.integers(-128, 128, size=tuple(t.shape)).astype(np.int8)
            else:
                a = rng.normal(size=tuple(t.shape)).astype(np.float32)
            t.copy_(torch.from_numpy(a))
            # a copy: jnp.asarray may alias an f32 numpy buffer on the CPU,
            # and the port's take_rows writes its storage in place
            arrays.append(jnp.asarray(t.float().numpy().copy(), _jdtype(t)))
        state[name] = tuple(arrays)
    jc.state = KVCacheState(**state)
    return jc, pc


def _jdtype(t):
    return {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8,
            torch.float32: jnp.float32}[t.dtype]


def _same(pc, jstate):
    for name in ("k", "v", "k_scale", "v_scale"):
        held, ref = getattr(pc, name), getattr(jstate, name)
        assert (held is None) == (ref is None)
        for t, r in zip(held or (), ref or ()):
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(r, np.float32))


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cache_row_gather_and_cut_match_jax_map_state(kind):
    """take_rows (parents with a repeat) and keep_rows against the JAX
    _map_state take / slice: every member bit-equal; batch_size, shape,
    the staged rows and the K8 pointer array follow."""
    jc, pc = _cache_pair(kind, batch=3, seed=7)
    parents = np.array([2, 0, 2])
    pc.take_rows(torch.from_numpy(parents))
    st = _map_state(lambda x: jnp.take(x, jnp.asarray(parents), axis=0),
                    jc.state)
    _same(pc, st)
    pc.keep_rows(2)
    st = _map_state(lambda x: x[:2], st)
    _same(pc, st)
    assert pc.batch_size == 2 and pc.shape[1] == 2
    assert pc.rows.shape[2] == 2 and pc.rows.is_contiguous()
    assert pc.kv_ptrs.tolist() == [t.data_ptr() for ts in pc._tensor_lists()
                                   for t in ts]


# ----------------------------------------------------------- beam search

@pytest.fixture(scope="module")
def greedy_ref(pair):
    """Greedy tokens (top-k 1) of both packages after "beam test prompt"."""
    jm, pm = pair
    ids = _ids("beam test prompt")
    jg, pg = _jgen(jm, top_k=1), _pgen(pm, top_k=1)
    jg.gen_begin(ids)
    pg.gen_begin(ids)
    return (ids, [int(jg.gen_single_token()[0, 0]) for _ in range(7)],
            [int(pg.gen_single_token()[0, 0]) for _ in range(7)])


@pytest.mark.parametrize("beams,length", [(3, 4), (2, 3), (2, 2)])
def test_beam_search_topk1_equals_greedy_and_jax(pair, greedy_ref, beams,
                                                 length):
    """At top-k 1 the filtered distribution is one token: beam search is
    greedy decoding, bit for bit in the port (7 commits: (2, 2) rolls the
    window over and re-expands off a stale main cache), and the JAX beam
    search's tokens where the margin is clear."""
    jm, pm = pair
    ids, jgreedy, pgreedy = greedy_ref
    pg = _pgen(pm, top_k=1, beams=beams, beam_length=length)
    pg.gen_begin(ids)
    pg.begin_beam_search()
    got = [int(pg.beam_search()[0, 0]) for _ in range(7)]
    pg.end_beam_search()
    assert got == pgreedy
    if (beams, length) == (3, 4):
        jg = _jgen(jm, top_k=1, beams=beams, beam_length=length)
        jg.gen_begin(ids)
        jg.begin_beam_search()
        jtoks = [int(jg.beam_search()[0, 0]) for _ in range(7)]
        assert jtoks == jgreedy
        assert _gaps(pm, ids, jtoks).max() <= MARGIN


def test_cache_consistent_after_end_beam_search(pair):
    """After beam search the main cache continues as a fresh prefill of the
    same sequence does: the next greedy logits within 2e-2 of the logit
    scale (prefill and decode round at other places), the same token."""
    _, pm = pair
    g = _pgen(pm, top_k=1, beams=2, beam_length=3)
    g.gen_begin(_ids("consistency"))
    g.begin_beam_search()
    for _ in range(5):
        g.beam_search()
    g.end_beam_search()
    seq = g.sequence.copy()
    assert g.cache.current_seq_len == seq.shape[1] - 1
    nxt = pm.forward(seq[:, -1:], g.cache)[0, -1]
    g2 = _pgen(pm, top_k=1)
    g2.gen_begin(seq)
    ref = pm.forward(seq[:, -1:], g2.cache)[0, -1]
    assert (nxt - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert int(nxt.argmax()) == int(ref.argmax())


@pytest.mark.parametrize("beams,length,top_k", [(3, 3, 40), (3, 1, 20)])
def test_stochastic_beams_keep_the_cache_honest(pair, beams, length, top_k):
    """Sampled initial beams (Gumbel top-k): tokens in range, the cursor one
    behind the sequence; beam length 1 re-expands on every call off a
    pruned beam cache whose batch_size tracks its rows."""
    _, pm = pair
    g = _pgen(pm, seed=3, beams=beams, beam_length=length, top_k=top_k,
              top_p=0.9, temperature=1.0)
    g.gen_begin(_ids("stochastic"))
    g.begin_beam_search()
    toks = []
    for _ in range(6):
        toks.append(int(g.beam_search()[0, 0]))
        if g._beam_cache is not None:
            assert g._beam_cache.batch_size == g._beam_cache.k[0].shape[0]
            assert g._beam_cache.rows.shape[2] == g._beam_cache.batch_size
    g.end_beam_search()
    assert all(0 <= t < 260 for t in toks)
    assert g.sequence.shape[1] == g.cache.current_seq_len + 1
    assert g._beam_cache is None and not g.in_beam_search


def test_beam_host_traffic_is_small(pair, monkeypatch):
    """Each lookahead step fetches 3 x beams numbers, never [n, V]
    probabilities (the JAX package's contract, generator.py:774-777)."""
    _, pm = pair
    g = _pgen(pm, seed=3, beams=3, beam_length=4, top_k=20)
    g.gen_begin(_ids("beam traffic"))
    big = []
    orig = torch.Tensor.cpu

    def spy(t, *a, **kw):
        if t.numel() >= 260:
            big.append(tuple(t.shape))
        return orig(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    g.begin_beam_search()
    for _ in range(6):
        g.beam_search()
    g.end_beam_search()
    monkeypatch.undo()
    assert big == []


# ------------------------------------------- CFG, constraints, sampling

def test_generate_cfg_topk1_matches_jax(pair):
    """CFG at alpha 0.3, top-k 1: the JAX tokens, each within the margin of
    the port's best teacher-forced mixed log-softmax (the port's own
    tokens equal where the margin is clear)."""
    jm, pm = pair
    prompts = ["a cheerful story", "a sad one"]
    jg, pg = _jgen(jm, batch=2, top_k=1), _pgen(pm, batch=2, top_k=1)
    jtext = jg.generate_cfg(prompts, 0.3, 8)
    ptext = pg.generate_cfg(prompts, 0.3, 8)
    jtoks = jg.sequence[0, -8:]
    ptoks = pg.sequence[0, -8:]
    assert isinstance(ptext, str) and isinstance(jtext, str)
    assert pg.sequence.shape == jg.sequence.shape

    s = pg.settings
    ids, mask = port.FakeTokenizer().encode(prompts, return_mask=True)
    g = _pgen(pm, batch=2, top_k=1)
    full = np.zeros((2, 96), bool)
    full[:, :ids.shape[1]] = mask
    g.gen_begin(ids, mask=full)
    gaps = []
    for t in jtoks:
        logits = pm.forward(g.sequence[:, -1:], g.cache,
                            input_mask=g._mask)[:, -1].float()
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


@pytest.mark.parametrize("disallowed", [None, [7, 9]])
def test_logit_bias_bit_equal_to_jax(pair, disallowed):
    jm, pm = pair
    jg, pg = _jgen(jm), _pgen(pm)
    jg.disallow_tokens(disallowed)
    pg.disallow_tokens(disallowed)
    for constraints in ([5, 70, 71], [200]):
        np.testing.assert_array_equal(
            pg._logit_bias(constraints).numpy(),
            np.asarray(jg._logit_bias(constraints)))
    got = pg._logit_bias()
    ref = np.asarray(jg._logit_bias())
    if disallowed is None:
        assert got is None and not ref.any()     # JAX adds zeros
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_constraints_force_the_token_and_match_jax(pair):
    """An empty sequence takes constraints[0]; after a prompt the token lies
    in the allowed set, is the JAX token where the margin is clear, and a
    disallowed token never wins."""
    jm, pm = pair
    allowed = [70, 71, 72, 110]
    for g in (_jgen(jm), _pgen(pm)):
        g.gen_begin_empty()
        assert int(g.gen_single_token(constraints=allowed)[0, 0]) == 70
    ids = _ids("constrained")
    jg, pg = _jgen(jm, top_k=1), _pgen(pm, top_k=1)
    jg.gen_begin(ids)
    pg.gen_begin(ids)
    jt = int(jg.gen_single_token(constraints=allowed)[0, 0])
    pt = int(pg.gen_single_token(constraints=allowed)[0, 0])
    assert jt in allowed and pt in allowed

    def constrained(logits, g):
        s = g.settings
        row = apply_rep_penalty(logits, g._seq_buf, g.sequence.shape[1],
                                s.token_repetition_penalty_max,
                                s.token_repetition_penalty_sustain,
                                s.token_repetition_penalty_decay)[0]
        return row + g._logit_bias(allowed)

    gap = _gaps(pm, ids, [jt], score=constrained)[0]
    assert gap <= MARGIN and (jt == pt or gap > 0.0)
    pg2 = _pgen(pm, top_k=1)
    pg2.gen_begin(ids)
    pg2.disallow_tokens([pt])
    assert int(pg2.gen_single_token(constraints=allowed)[0, 0]) != pt


def test_sample_current_topk1_is_the_argmax(pair):
    _, pm = pair
    g = _pgen(pm, top_k=1)
    row = torch.from_numpy(np.random.default_rng(2).normal(
        size=260).astype(np.float32))
    tok, p = g.sample_current(row)
    assert tok.shape == (1, 1) and int(tok[0, 0]) == int(row.argmax())
    assert float(p) == pytest.approx(1.0)


# -------------------------------------------------- host-side bookkeeping

def _prune_right(g):
    g.gen_prune_right(3)


def _prune_left(g):
    g.gen_prune_left(4)


def _prune_to(g):
    g.gen_prune_to(6, int(_ids("a")[0, 0]))


def _replace(g):
    g.replace_last_token(77)
    g.replace_last_token(78, seq=True)


def _empty(g):
    g.gen_begin_empty()
    g.gen_single_token()


@pytest.mark.parametrize("op", [_prune_right, _prune_left, _prune_to,
                                _replace, _empty])
def test_bookkeeping_matches_jax(pair, op):
    """The same calls leave the same sequence, sequence_actual, cursor and
    token counts in both packages (integers: bit-equal)."""
    jm, pm = pair
    ids = _ids("a b a cab a dab")
    states = []
    for g in (_jgen(jm, top_k=1), _pgen(pm, top_k=1)):
        g.gen_begin(ids)
        op(g)
        states.append((
            None if g.sequence is None else g.sequence.tolist(),
            None if g.sequence_actual is None else g.sequence_actual.tolist(),
            g.cache.current_seq_len,
            g.gen_num_tokens() if g.sequence_actual is not None else None,
            g.sequence_ends_with(ids[0, -2:]) if g.sequence_actual is not None
            else None,
        ))
    assert states[0] == states[1]
