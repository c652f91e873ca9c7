"""The port's compiled steps on the CPU, where the card's CUDA graphs run as
the same step functions, eagerly, held against the JAX package's jits:

  * ``ExLlama.forward``'s chunk step (the position read from
    ``cache.cursor``, the counterpart of the jitted ``forward_chunk``)
    against the JAX ``ExLlama.forward`` on its "xla" paths at T = 1, 5, 12
    (padded to 16 rows) and 64, B = 1 and 2, with a left-pad mask and with
    a LoRA adapter, within tests/test_torch_model.py's tolerances (2% of
    the logit scale for a chunk, 3% for a decode step), and bit for bit
    against the port's own int-cursor route over the same rows;
  * the sampler on a device operand (``ops.sampling.sample_operands``, the
    counterpart of ``_sample_step``'s traced settings) against the JAX
    ``apply_rep_penalty`` + ``filter_probs`` within 1e-5, top-k 1 the
    argmax;
  * ``generator.DecodeLoop``'s epoch: only what the JAX package makes
    static (``_decode_loop_n``'s static argnames) starts a new one, and it
    survives ``gen_begin``;
  * the engine's speculative step on its static buffers against the JAX
    engine's greedy tokens (each JAX token within 3% of the logit scale of
    the port's best, teacher-forced; equal up to the first step where that
    margin is not clear: tests/test_torch_serve.py's rule), with drafts of
    different lengths in one step;
  * ``ExLlamaCache.take_rows`` / ``keep_rows`` reorder in place (the
    storage, ``kv_ptrs`` and the graph table stay) up to the cache's
    capacity, and grow it beyond (a new, empty table).

Shapes: hidden 256, 2 layers, 4 heads of 64 over 2 kv heads, vocab 256,
max_seq_len 128.
"""

import jax
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.lora import ExLlamaLora as JaxLora
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.ops import sampling as jsampling
from exllama_tpu.ops.sampling import SamplerSettings as JaxSettings
from exllama_tpu.serve import ContinuousBatchingEngine as JaxEngine
from exllama_tpu.speculative import NgramProposer as JaxNgram
from exllama_tpu.tokenizer import FakeTokenizer as JaxTokenizer

import exllama_tpu_torch as port
from exllama_tpu_torch.generator import _sample_step
from exllama_tpu_torch.models.llama import (GRAPH_MAX_T, forward_chunk,
                                            graph_rows)
from exllama_tpu_torch.ops.sampling import (
    SamplerSettings,
    apply_rep_penalty,
    filter_operands,
    sample_operands,
    settings_operand,
)
from exllama_tpu_torch.serve import ContinuousBatchingEngine
from exllama_tpu_torch.speculative import NgramProposer
from exllama_tpu_torch.utils.fabricate import fabricate_lora

VOCAB = 256
S_MAX = 128
PREFIX = 20
MARGIN = 0.03


def _tiny(cfg):
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 2
    cfg.head_dim = 64
    cfg.num_hidden_layers = 2
    cfg.vocab_size = VOCAB
    cfg.max_seq_len = S_MAX
    cfg.max_input_len = 2 * S_MAX
    cfg.max_attention_size = S_MAX * S_MAX
    cfg.tuning.attn_len_bucket = 32
    return cfg


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
    jc = _tiny(JaxConfig())
    jc.tuning.matmul_impl = "xla"
    jc.tuning.attn_impl = "xla"
    jp = jax_synth(jc, 128, False, seed=17)
    pc = _tiny(port.ExLlamaConfig())
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")


@pytest.fixture(scope="module")
def adapter(pair, tmp_path_factory):
    """One adapter (q, v, o, down; r 8), loaded by both packages."""
    root = tmp_path_factory.mktemp("graph_adapter")
    files = fabricate_lora(str(root), pair[1].config, ("q", "v", "o", "down"),
                           r=8, alpha=16, scale=0.5, seed=4)
    return JaxLora(pair[0], *files), port.ExLlamaLora(pair[1], *files)


def _caches_equal(a, b):
    for x, y in zip(a._tensor_lists(), b._tensor_lists()):
        for s, t in zip(x, y):
            assert torch.equal(s, t)


def _ids(n, salt=0):
    return ((np.arange(n, dtype=np.int32)[None, :] * 37 + 11 + salt) % 250
            + 4).astype(np.int32)


# ------------------------------------------------ the forward's chunk step

CHUNKS = {f"T{t} {v}": (t, v) for t in (1, 5, 12, GRAPH_MAX_T)
          for v in ("B1", "B2 mask", "B1 adapter")}
CHUNKS["T5 B2 mask adapter"] = (5, "B2 mask adapter")
CHUNKS["T12 B2 mask last"] = (12, "B2 mask last")


@pytest.mark.parametrize("case", list(CHUNKS))
def test_chunk_step_equals_jax_forward_chunk_and_the_int_route(pair, adapter,
                                                               case):
    """A chunk of T rows after a 20-token prefix: the port's forward (the
    step at ``cache.cursor``, T = 12 padded to ``graph_rows`` 16) within
    the tolerance of the JAX forward's logits, and bit-equal (logits and
    caches) to ``forward_chunk`` at the int cursor over the same padded
    tokens from the same prefilled state; the pad rows write nothing. With ``last`` only the last real
    row's logits, within the tolerance of the JAX forward's."""
    t, variant = CHUNKS[case]
    rows = graph_rows(t)
    last = "last" in variant
    jm, pm = pair
    b = 2 if "B2" in variant else 1
    rng = np.random.default_rng(7 * t + b)
    ids = rng.integers(4, VOCAB, size=(b, PREFIX + t)).astype(np.int32)
    mask = None
    if "mask" in variant:
        ids[1, :3] = 0
        mask = np.zeros((b, S_MAX), bool)
        mask[:, :PREFIX + t] = True
        mask[1, :3] = False
    jl, pl = adapter if "adapter" in variant else (None, None)

    jc = JaxCache(jm, batch_size=b)
    jm.forward(ids[:, :PREFIX], jc, preprocess_only=True, input_mask=mask,
               lora=jl)
    ref = np.asarray(jm.forward(ids[:, PREFIX:], jc, last_id_only=False,
                                input_mask=mask, lora=jl))

    pc = port.ExLlamaCache(pm, batch_size=b)
    pm.forward(ids[:, :PREFIX], pc, preprocess_only=True, input_mask=mask,
               lora=pl)
    ic = pc.clone()
    got = pm.forward(ids[:, PREFIX:], pc, last_id_only=last,
                     input_mask=mask, lora=pl)
    assert int(pc.cursor[0]) == PREFIX and pc.current_seq_len == PREFIX + t
    kw = pm._chunk_kwargs(lora=None if pl is None else pl.stacked,
                          attend_len=pm._attend_len(PREFIX + rows),
                          last_token_only=False, preprocess_only=False)
    padded = np.zeros((b, rows), np.int32)
    padded[:, :t] = ids[:, PREFIX:]
    by_int = forward_chunk(pm.params, ic, torch.from_numpy(padded), PREFIX,
                           None if mask is None else torch.from_numpy(mask),
                           valid_rows=torch.tensor([t]) if rows > t else None,
                           **kw)[:, :t]
    _caches_equal(pc, ic)
    # the pad rows wrote nothing
    assert all(not x[:, :, PREFIX + t:].any()
               for ts in pc._tensor_lists() for x in ts)
    tol = 0.03 if t == 1 else 0.02
    if last:
        ref, by_int = ref[:, -1:], by_int[:, -1:]
        assert np.abs((got - by_int).numpy()).max() <= tol * np.abs(ref).max()
    else:
        assert torch.equal(got, by_int)
    assert got.shape == ref.shape == (b, 1 if last else t, VOCAB)
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("t,past", [(1, S_MAX), (5, S_MAX - 4), (64, 70)])
def test_chunk_outside_the_cache_raises_on_the_host(pair, t, past):
    """The host checks the position the step reads on the device: a chunk
    that would not fit the cache raises before anything runs."""
    pm = pair[1]
    c = port.ExLlamaCache(pm)
    c.current_seq_len = past
    with pytest.raises(ValueError, match="outside"):
        pm.forward(_ids(t), c)
    assert c.current_seq_len == past


# ------------------------------------------ the sampler on device operands

SAMPLERS = {
    "top-k 0": dict(top_k=0, top_p=0.0),
    "top-k 1": dict(top_k=1),
    "top-k 40": dict(top_k=40, top_p=0.0),
    "top-p": dict(top_k=0, top_p=0.65),
    "min-p": dict(top_k=0, top_p=0.9, min_p=0.02),
    "typical": dict(top_k=0, top_p=0.0, typical=0.4),
    "penalty": dict(top_k=40, token_repetition_penalty_max=1.3),
    "defaults": {},
}


@pytest.mark.parametrize("case", list(SAMPLERS))
def test_sampler_on_device_operands_matches_jax(case):
    """Penalty (its maximum read from the operand) and filter against the
    JAX apply_rep_penalty + filter_probs within 1e-5; every draw on a kept
    token; at top-k 1 the argmax of the penalized logits, also where two
    logits one ulp apart may round to one probability."""
    s = SamplerSettings(temperature=0.9, **SAMPLERS[case])
    rng = np.random.default_rng(sum(map(ord, case)))
    lg = (rng.standard_normal((3, VOCAB)) * 3).astype(np.float32)
    lg[0, 10] = 8.0
    lg[0, 3] = np.nextafter(np.float32(8.0), np.float32(0.0))
    hist = rng.integers(0, VOCAB, (3, 64)).astype(np.int32)
    ops = settings_operand(s, "cpu")
    pen = apply_rep_penalty(torch.from_numpy(lg), torch.from_numpy(hist),
                            torch.tensor([40], dtype=torch.int32), ops[5:6],
                            s.token_repetition_penalty_sustain,
                            s.token_repetition_penalty_decay)
    got = filter_operands(pen, ops, s.typical > 0).numpy()
    jl = jsampling.apply_rep_penalty(
        lg, hist, np.int32(40), s.token_repetition_penalty_max,
        s.token_repetition_penalty_sustain, s.token_repetition_penalty_decay)
    want = np.asarray(jsampling.filter_probs(jl, s.temperature, s.top_k,
                                             s.top_p, s.min_p, s.typical))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    toks = sample_operands(pen, torch.Generator().manual_seed(2), ops,
                           typical=s.typical > 0).numpy()
    assert toks.dtype == np.int32
    assert np.all(want[np.arange(3), toks] > 0)
    if s.top_k == 1:
        np.testing.assert_array_equal(toks, pen.argmax(dim=-1).numpy())
        assert toks[0] == 10


@pytest.mark.parametrize("constraints", [None, [7, 9, 200]])
@pytest.mark.parametrize("settings", ["greedy", "sampled"])
def test_gen_single_token_is_one_loop_step(pair, settings, constraints):
    """gen_single_token (one DecodeLoop step: forward and sampler in one
    graph on the card) against model.forward + the sampler on the operand,
    from one generator seed: tokens and histories bit-equal; with
    constraints every token is one of them."""
    pm = pair[1]
    gens = []
    for _ in range(2):
        g = port.ExLlamaGenerator(pm, port.FakeTokenizer(),
                                  port.ExLlamaCache(pm), seed=3)
        if settings == "greedy":
            g.settings.top_k = 1
        g.gen_begin(_ids(30))
        gens.append(g)
    a, b = gens
    got = np.concatenate([a.gen_single_token(constraints=constraints)
                          for _ in range(6)], axis=1)
    ref = []
    for _ in range(6):
        s = b.settings
        if constraints is not None:
            s = SamplerSettings(**{**s.__dict__, "min_p": s.min_p + 0.01})
        logits = pm.forward(b.sequence[:, -1:], b.cache)
        tok = _sample_step(logits, b._seq_buf, b.sequence.shape[1],
                           b.generator, s, b.tokenizer.bos_token_id,
                           b._loop_bias(constraints),
                           ops=settings_operand(s, "cpu"))
        b.gen_accept_token(tok.numpy().reshape(-1, 1))
        ref.append(tok.numpy().reshape(-1, 1))
    np.testing.assert_array_equal(got, np.concatenate(ref, axis=1))
    assert torch.equal(a._seq_buf, b._seq_buf)
    _caches_equal(a.cache, b.cache)
    if constraints is not None:
        assert set(got.reshape(-1).tolist()) <= set(constraints)


# ------------------------------------------------- the decode loop's epoch

def _knob(g):
    g.model.config.tuning.fuse_qkv = True


EPOCHS = {
    # change -> the epoch stays (JAX: a traced operand or a host call)
    "temperature": (lambda g, pl: setattr(g.settings, "temperature", 0.5),
                    True),
    "top_k": (lambda g, pl: setattr(g.settings, "top_k", 7), True),
    "top_p": (lambda g, pl: setattr(g.settings, "top_p", 0.9), True),
    "min_p": (lambda g, pl: setattr(g.settings, "min_p", 0.05), True),
    "typical": (lambda g, pl: setattr(g.settings, "typical", 0.3), True),
    "penalty": (lambda g, pl: setattr(
        g.settings, "token_repetition_penalty_max", 1.3), True),
    "gen_begin": (lambda g, pl: g.gen_begin(_ids(25, salt=1)), True),
    # JAX static argnames: sustain, decay, the forward knobs; the mask's
    # shape, the adapter and the batch are the traced operands' shapes
    "typical off": (lambda g, pl: setattr(g.settings, "typical", 0.0),
                    False),
    "sustain": (lambda g, pl: setattr(
        g.settings, "token_repetition_penalty_sustain", 64), False),
    "decay": (lambda g, pl: setattr(
        g.settings, "token_repetition_penalty_decay", 32), False),
    "mask shape": (lambda g, pl: setattr(
        g, "_mask", torch.ones((1, S_MAX), dtype=torch.bool)), False),
    "adapter": (lambda g, pl: setattr(g, "lora", pl), False),
    "knobs": (lambda g, pl: _knob(g), False),
}


@pytest.mark.parametrize("change", list(EPOCHS))
def test_decode_loop_epoch_holds_only_the_static_choices(pair, adapter,
                                                         change):
    """The loop's epoch before and after a change (a held entry stands in
    for a graph, which the CPU does not capture), from a generator with
    typical sampling on: the settings' values and gen_begin keep it and the
    graphs; typical turned off, sustain, decay, the mask's shape, the
    adapter and the forward knobs start a new one."""
    pm = pair[1]
    model = port.ExLlama(_tiny(port.ExLlamaConfig()), params=pm.params,
                         device="cpu")
    g = port.ExLlamaGenerator(model, port.FakeTokenizer(),
                              port.ExLlamaCache(model), seed=1)
    g.settings.typical = 0.2
    g.gen_begin(_ids(20))
    g.gen_tokens(1)
    before = g._loop._epoch
    loop = g._loop
    held = [t.data_ptr() for t in (loop.hist, loop.tok, loop.pos, loop.ops,
                                   g.cache.cursor)]
    g._loop.graphs[32] = "held"
    fn, kept = EPOCHS[change]
    fn(g, adapter[1])
    g.gen_tokens(1)
    assert (g._loop._epoch == before) == kept
    assert (g._loop.graphs == {32: "held"}) == kept
    # nothing a graph reads was reallocated (gen_begin included)
    assert g._loop is loop and held == [
        t.data_ptr() for t in (loop.hist, loop.tok, loop.pos, loop.ops,
                               g.cache.cursor)]


def test_decode_loop_epoch_follows_the_batch(pair):
    """Two generators of B = 1 and 2 on one model differ in epoch only by
    the batch."""
    pm = pair[1]
    epochs = []
    for b in (1, 2):
        g = port.ExLlamaGenerator(pm, port.FakeTokenizer(),
                                  port.ExLlamaCache(pm, batch_size=b))
        g.gen_begin(np.repeat(_ids(20), b, axis=0))
        g.gen_tokens(1)
        epochs.append(g._loop._epoch)
    assert epochs[0][0] == 1 and epochs[1][0] == 2
    assert epochs[0][1:] == epochs[1][1:]


# ----------------------------------------- the engine's speculative step

def _forced_gaps(pm, ids, toks):
    """Teacher-forced on the port after ``ids`` (penalty 1.0): how far below
    the best of the BOS-banned logits each of ``toks`` lies, over the
    logits' scale."""
    cache = port.ExLlamaCache(pm)
    pm.forward(ids[None, :-1], cache, preprocess_only=True)
    seq = ids[None].astype(np.int32)
    gaps = []
    for t in toks:
        logits = pm.forward(seq[:, -1:], cache)[0, -1].float()
        row = logits.clone()
        row[port.FakeTokenizer.bos_token_id] -= 10000.0
        gaps.append(float(row.max() - row[int(t)]) / float(logits.abs().max()))
        seq = np.concatenate([seq, [[int(t)]]], axis=1).astype(np.int32)
    return np.array(gaps)


def test_engine_spec_step_on_static_buffers_matches_jax_engine(pair):
    """Three greedy requests whose prompts repeat with periods 3, 5 and 7
    through both engines' speculative step (n-gram proposer, lookahead 4):
    at least one step drafts different lengths for different slots; the
    port's step reads its tokens, drafts and draft lengths from its static
    buffer (no graph on the CPU); every JAX token within the margin of the
    port's best, the two engines equal up to the first step where the
    margin is not clear."""
    jm, pm = pair
    rng = np.random.default_rng(5)
    prompts = [np.tile(rng.integers(4, VOCAB, size=p), 24 // p + 1)[:24]
               .astype(np.int32) for p in (3, 5, 7)]
    lengths = []

    class Recorded(NgramProposer):
        def propose(self, seq, k):
            d = super().propose(seq, k)
            lengths[-1].append(len(d))
            return d

    got = {}
    for name in ("jax", "port"):
        if name == "jax":
            eng = JaxEngine(jm, JaxTokenizer(), max_slots=4,
                            spec_proposer=JaxNgram(), spec_lookahead=4)
            st = JaxSettings(temperature=1.0, top_k=1, top_p=0.0,
                             token_repetition_penalty_max=1.0)
        else:
            eng = ContinuousBatchingEngine(pm, port.FakeTokenizer(),
                                           max_slots=4,
                                           spec_proposer=Recorded(),
                                           spec_lookahead=4)
            st = SamplerSettings(temperature=1.0, top_k=1, top_p=0.0,
                                 token_repetition_penalty_max=1.0)
            real = eng._step_spec

            def step_spec(*a):
                lengths.append([])
                return real(*a)

            eng._step_spec = step_spec
        reqs = [eng.submit(p, max_new_tokens=12, settings=st,
                           stop_tokens=(-1,)) for p in prompts]
        eng.run()
        got[name] = [list(r.new_tokens) for r in reqs]
        if name == "port":
            assert eng.graphs == {} and list(eng._spec_bufs) == [5]
            assert eng.spec_stats["steps"] > 0
    assert any(len(set(x)) > 1 for x in lengths if len(x) > 1), lengths
    for ids, jt, pt in zip(prompts, got["jax"], got["port"]):
        assert len(jt) == len(pt) == 12
        gaps = _forced_gaps(pm, ids, jt)
        assert gaps.max() <= MARGIN, (gaps, jt, pt)
        diff = np.nonzero(np.asarray(jt) != np.asarray(pt))[0]
        assert diff.size == 0 or gaps[diff[0]] > 0.0, (jt, pt)


# ---------------------------------------------- the cache's rows in place

def _stub_cache(kind, batch):
    cfg = port.ExLlamaConfig()
    cfg.num_hidden_layers, cfg.num_key_value_heads = 2, 2
    cfg.head_dim, cfg.max_seq_len = 64, 16
    cfg.tuning.kv_cache_dtype = kind

    class _Model:
        config = cfg
        device = torch.device("cpu")

    c = port.ExLlamaCache(_Model(), batch_size=batch)
    gen = torch.Generator().manual_seed(11)
    for ts in c._tensor_lists():
        for t in ts:
            t.copy_(torch.randint(-100, 100, t.shape, generator=gen)
                    .to(t.dtype))
    c.rows.copy_(torch.randn(c.rows.shape, generator=gen))
    return c


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_take_rows_and_keep_rows_reorder_in_place(kind):
    """Within the capacity a gather by parent and a cut keep every member's
    storage, ``kv_ptrs`` (the tensor and its pointers) and the graph
    table, so the graphs on the cache stay; a gather to more rows than the
    capacity allocates anew, with a new, empty table."""
    c = _stub_cache(kind, 3)
    before = [[t.clone() for t in ts] for ts in c._tensor_lists()]
    rows = c.rows.clone()
    ptrs = [t.data_ptr() for ts in c._tensor_lists() for t in ts]
    kvp, table = c.kv_ptrs, c.graphs
    c.graphs["key"] = "held"

    def check(index):
        for ts, old in zip(c._tensor_lists(), before):
            for t, o in zip(ts, old):
                assert torch.equal(t, o[index])
        assert torch.equal(c.rows, rows[:, :, index])
        assert c.rows.is_contiguous() and c.batch_size == len(index)

    c.take_rows(torch.tensor([2, 0, 2]))
    check([2, 0, 2])
    before = [[t.clone() for t in ts] for ts in c._tensor_lists()]
    rows = c.rows.clone()
    c.keep_rows(2)
    check([0, 1])
    c.take_rows([1])
    check([1])
    assert [t.data_ptr() for ts in c._tensor_lists() for t in ts] == ptrs
    assert c.rows.data_ptr() == c._rows_flat.data_ptr()
    assert c.kv_ptrs is kvp and c.kv_ptrs.tolist() == ptrs
    assert c.graphs is table and c.graphs == {"key": "held"}
    with pytest.raises(ValueError):
        c.keep_rows(4)

    c.keep_rows(3)                  # widened within the capacity
    before = [[t.clone() for t in ts] for ts in c._tensor_lists()]
    rows = c.rows.clone()
    c.take_rows([0, 2, 1, 0])
    check([0, 2, 1, 0])
    assert c.capacity == 4 and c.graphs is not table and c.graphs == {}
    assert c.kv_ptrs.tolist() == [t.data_ptr() for ts in c._tensor_lists()
                                  for t in ts]
