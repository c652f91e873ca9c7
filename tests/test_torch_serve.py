"""The port's continuous-batching engine (``serve.engine``) and its per-row
samplers (``ops.sampling.filter_rows`` / ``filter_sample_rows`` /
``rep_mask_windowed``) against the JAX package on the CPU, at
tests/test_serve.py's shapes (hidden 256, 2 layers, GQA 4 / 2, vocab 260,
max_seq_len 128; the JAX side on its "xla" path, the port from the same
parameters through ``params_from_jax``).

The cases of tests/test_serve.py run on the port's engine; their oracle is
the port's own single-sequence generator, token for token. One
multi-request greedy scenario is held against the JAX engine under the
margin rule of tests/test_torch_alt_generator.py: each JAX token within 3%
of the logit scale of the port's best on the port's teacher-forced logits,
and the two engines equal up to the first step where that margin is not
clear. The per-row filter matches ``jax.vmap`` of the JAX ``_filter_row``
within 1e-5 per row, the windowed penalty mask ``_rep_mask_windowed``
within 1e-6.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.ops.sampling import SamplerSettings as JaxSettings
from exllama_tpu.ops.sampling import _filter_row as jax_filter_row
from exllama_tpu.serve import ContinuousBatchingEngine as JaxEngine
from exllama_tpu.serve.engine import _rep_mask_windowed
from exllama_tpu.tokenizer import FakeTokenizer as JaxTokenizer

import exllama_tpu_torch as port
from exllama_tpu_torch.lora import _PROJ_NAMES, LayerLora
from exllama_tpu_torch.ops.sampling import (
    SamplerSettings,
    filter_rows,
    filter_sample_rows,
    rep_mask_windowed,
)
from exllama_tpu_torch.serve import ContinuousBatchingEngine
from exllama_tpu_torch.speculative import NgramProposer

MARGIN = 0.03
GREEDY = SamplerSettings(temperature=1.0, top_k=1, top_p=0.0,
                         token_repetition_penalty_max=1.0)


def _tiny(cfg, kv_dtype="bf16"):
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 2
    cfg.head_dim = 64
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 260
    cfg.max_seq_len = 128
    cfg.tuning.attn_len_bucket = 32
    cfg.tuning.kv_cache_dtype = kv_dtype
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
    jp = jax_synth(jc, 128, False, seed=31)
    pc = _tiny(port.ExLlamaConfig())
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def oracle_tokens(model, prompt_ids, n, lora=None):
    gen = port.ExLlamaGenerator(model, port.FakeTokenizer(),
                                port.ExLlamaCache(model), seed=0)
    gen.settings = SamplerSettings(**GREEDY.__dict__)
    gen.lora = lora
    gen.gen_begin(np.asarray(prompt_ids)[None, :])
    return [int(gen.gen_single_token()[0, 0]) for _ in range(n)]


# ---------------------------------------- tests/test_serve.py, ported

def test_single_request_matches_generator(model):
    eng = ContinuousBatchingEngine(model, port.FakeTokenizer(), max_slots=4)
    ids = port.FakeTokenizer().encode("continuous batching!")[0]
    req = eng.submit(ids, max_new_tokens=8, settings=GREEDY,
                     stop_tokens=(-1,))
    eng.run()
    assert req.new_tokens == oracle_tokens(model, ids, 8)


def test_concurrent_requests_are_independent(model):
    tok = port.FakeTokenizer()
    eng = ContinuousBatchingEngine(model, tok, max_slots=4)
    idss = [tok.encode(p)[0] for p in
            ("alpha prompt", "tiny", "a different longer prompt here")]
    reqs = [eng.submit(ids, max_new_tokens=6, settings=GREEDY,
                       stop_tokens=(-1,)) for ids in idss]
    eng.run()
    for ids, req in zip(idss, reqs):
        assert req.new_tokens == oracle_tokens(model, ids, 6), ids


def test_late_admission_and_slot_reuse(model):
    """More requests than slots: later requests wait for free slots and
    still decode correctly on reused slots."""
    tok = port.FakeTokenizer()
    eng = ContinuousBatchingEngine(model, tok, max_slots=2)
    idss = [tok.encode(f"prompt number {i}")[0] for i in range(5)]
    reqs = [eng.submit(ids, max_new_tokens=4, settings=GREEDY,
                       stop_tokens=(-1,)) for ids in idss]
    assert len(eng.queue) == 5
    eng.run()
    for ids, req in zip(idss, reqs):
        assert req.state == "done"
        assert req.new_tokens == oracle_tokens(model, ids, 4)


def test_mid_flight_admission(model):
    tok = port.FakeTokenizer()
    eng = ContinuousBatchingEngine(model, tok, max_slots=4)
    a = eng.submit(tok.encode("first")[0], max_new_tokens=10,
                   settings=GREEDY, stop_tokens=(-1,))
    for _ in range(3):
        eng.step()
    b = eng.submit(tok.encode("second, later")[0], max_new_tokens=5,
                   settings=GREEDY, stop_tokens=(-1,))
    eng.run()
    assert a.new_tokens == oracle_tokens(model, tok.encode("first")[0], 10)
    assert b.new_tokens == oracle_tokens(
        model, tok.encode("second, later")[0], 5)


def test_stop_token_frees_slot(model):
    tok = port.FakeTokenizer()
    eng = ContinuousBatchingEngine(model, tok, max_slots=2)
    ids = tok.encode("stop early")[0]
    want = oracle_tokens(model, ids, 8)
    req = eng.submit(ids, max_new_tokens=8, settings=GREEDY,
                     stop_tokens=(want[2],))
    eng.run()
    assert req.new_tokens == want[:3]       # includes the stop token
    assert len(eng.free) == 2


def test_streaming_callback(model):
    tok = port.FakeTokenizer()
    eng = ContinuousBatchingEngine(model, tok, max_slots=2)
    seen = []
    eng.submit(tok.encode("cb")[0], max_new_tokens=4, settings=GREEDY,
               stop_tokens=(-1,), on_token=lambda r, t: seen.append(t))
    eng.run()
    assert len(seen) == 4


def test_chunked_admission_decode_never_stalls(model):
    """While a long prompt prefills in chunks, a running request gets one
    token every step()."""
    tok = port.FakeTokenizer()
    eng = ContinuousBatchingEngine(model, tok, max_slots=4,
                                   prefill_bucket=16)
    a_ids = tok.encode("short")[0]
    a = eng.submit(a_ids, max_new_tokens=40, settings=GREEDY,
                   stop_tokens=(-1,))
    for _ in range(2):
        eng.step()
    b_ids = (np.arange(100, dtype=np.int32) * 7 + 5) % 250   # 7 chunks
    b = eng.submit(b_ids, max_new_tokens=4, settings=GREEDY,
                   stop_tokens=(-1,))
    stall_steps = 0
    while b.state in ("queued", "prefill"):
        before = len(a.new_tokens)
        eng.step()
        stall_steps += len(a.new_tokens) == before
    assert stall_steps == 0, "decode stalled during chunked admission"
    eng.run()
    assert a.new_tokens == oracle_tokens(model, a_ids, 40)
    assert b.new_tokens == oracle_tokens(model, b_ids, 4)


class _InjectiveDetok(port.FakeTokenizer):
    """A decode that is injective per token (``<id>`` pieces)."""

    def decode(self, ids, **kw):
        return "".join(f"<{int(t)}>" for t in np.asarray(ids).reshape(-1))


def test_engine_stop_strings_and_text_streaming(model):
    """A stop string ends the request without leaking; on_text receives
    the released stream."""
    tok = _InjectiveDetok()
    eng = ContinuousBatchingEngine(model, tok, max_slots=2)
    ids = port.FakeTokenizer().encode("stream me")[0]
    want = np.asarray(oracle_tokens(model, ids, 12), np.int32)
    full_text = tok.decode(want)
    prefix = tok.decode(want[:5])
    stop = tok.decode(want[:8])[len(prefix):]
    assert stop and full_text.index(stop) == len(prefix)
    chunks = []
    req = eng.submit(ids, max_new_tokens=12, settings=GREEDY,
                     stop_tokens=(-1,), stop_strings=(stop,),
                     on_text=lambda r, t: chunks.append(t))
    eng.run()
    assert req.state == "done"
    assert stop not in req.text
    assert req.text == "".join(chunks)
    assert full_text.startswith(req.text)
    assert len(req.new_tokens) < 12


def test_engine_per_request_lora(model):
    """Slots with different adapters (ranks 4 and 2, padded to 4) and none
    decode as if each ran alone with its adapter."""
    tok = port.FakeTokenizer()
    cfg = model.config
    rng = np.random.default_rng(17)

    def make_adapter(scale, r):
        layers = []
        for _ in range(cfg.num_hidden_layers):
            a = rng.standard_normal((cfg.hidden_size, r)) * 0.05
            b = rng.standard_normal((r, cfg.hidden_size)) * scale
            fields = {p: None for p in _PROJ_NAMES}
            fields["o"] = (torch.tensor(a, dtype=torch.bfloat16),
                           torch.tensor(b, dtype=torch.bfloat16))
            layers.append(LayerLora(**fields))
        return layers

    class FakeLora:
        def __init__(self, stacked):
            self.stacked = stacked

    ad1, ad2 = FakeLora(make_adapter(0.3, 4)), FakeLora(make_adapter(-0.25, 2))
    ids = tok.encode("lora slots")[0]
    base = oracle_tokens(model, ids, 6)
    w1 = oracle_tokens(model, ids, 6, ad1)
    w2 = oracle_tokens(model, ids, 6, ad2)
    assert w1 != base and w2 != base       # the adapters change the output

    eng = ContinuousBatchingEngine(model, tok, max_slots=4)
    id1, id2 = eng.register_lora(ad1), eng.register_lora(ad2)
    r0 = eng.submit(ids, 6, settings=GREEDY, stop_tokens=(-1,))
    r1 = eng.submit(ids, 6, settings=GREEDY, stop_tokens=(-1,), lora_id=id1)
    r2 = eng.submit(ids, 6, settings=GREEDY, stop_tokens=(-1,), lora_id=id2)
    eng.run()
    assert (r0.new_tokens, r1.new_tokens, r2.new_tokens) == (base, w1, w2)
    assert eng._lora_rank == 4


def test_spec_mode_matches_plain_engine(model):
    """Greedy speculative mode emits exactly the plain engine's tokens."""
    tok = port.FakeTokenizer()
    idss = [tok.encode(f"spec prompt {i} spec prompt {i}")[0]
            for i in range(3)]
    plain = ContinuousBatchingEngine(model, tok, max_slots=4)
    want = [plain.submit(ids, max_new_tokens=10, settings=GREEDY,
                         stop_tokens=(-1,)) for ids in idss]
    plain.run()
    eng = ContinuousBatchingEngine(model, tok, max_slots=4,
                                   spec_proposer=NgramProposer(),
                                   spec_lookahead=4)
    reqs = [eng.submit(ids, max_new_tokens=10, settings=GREEDY,
                       stop_tokens=(-1,)) for ids in idss]
    eng.run()
    for w, r in zip(want, reqs):
        assert r.new_tokens == w.new_tokens
    assert eng.spec_stats["steps"] > 0
    assert eng.spec_stats["drafted"] > 0


def test_spec_mode_stop_token_mid_draft(model):
    """A stop token inside an accepted draft ends the request there."""
    tok = port.FakeTokenizer()
    ids = tok.encode("halt on token")[0]
    plain = ContinuousBatchingEngine(model, tok, max_slots=2)
    probe = plain.submit(ids, max_new_tokens=8, settings=GREEDY,
                         stop_tokens=(-1,))
    plain.run()
    stop = probe.new_tokens[2]
    eng = ContinuousBatchingEngine(model, tok, max_slots=2,
                                   spec_proposer=NgramProposer(),
                                   spec_lookahead=4)
    req = eng.submit(ids, max_new_tokens=8, settings=GREEDY,
                     stop_tokens=(stop,))
    eng.run()
    first = req.new_tokens.index(stop)
    assert req.new_tokens[-1] == stop       # nothing emitted past the stop
    assert req.new_tokens == probe.new_tokens[: first + 1]


def test_spec_mode_max_new_tokens_exact(model):
    tok = port.FakeTokenizer()
    eng = ContinuousBatchingEngine(model, tok, max_slots=2,
                                   spec_proposer=NgramProposer(),
                                   spec_lookahead=4)
    ids = tok.encode("count limit test count limit test")[0]
    req = eng.submit(ids, max_new_tokens=5, settings=GREEDY,
                     stop_tokens=(-1,))
    eng.run()
    assert len(req.new_tokens) == 5


def test_spec_mode_after_a_request_ends_at_the_window_end(model):
    """A request cut to the window (it ends at position max_seq_len - 2)
    frees its slot while a short one keeps decoding speculatively: the
    freed slot's K+1-row verify writes must stay inside the rope tables
    and the cache, and both requests keep the plain engine's tokens."""
    tok = port.FakeTokenizer()
    long_ids = (np.arange(200, dtype=np.int32) * 7) % 250 + 4
    short_ids = tok.encode("short one short one")[0]

    def run(**kw):
        eng = ContinuousBatchingEngine(model, tok, max_slots=2,
                                       prefill_bucket=32, **kw)
        a = eng.submit(long_ids, max_new_tokens=4, settings=GREEDY,
                       stop_tokens=(-1,))
        b = eng.submit(short_ids, max_new_tokens=40, settings=GREEDY,
                       stop_tokens=(-1,))
        eng.run()
        return eng, a, b

    _, pa, pb = run()
    eng, a, b = run(spec_proposer=NgramProposer(), spec_lookahead=4)
    assert len(a.prompt_ids) == model.config.max_seq_len - 4 - 1
    assert (a.new_tokens, b.new_tokens) == (pa.new_tokens, pb.new_tokens)
    assert len(b.new_tokens) == 40
    assert eng.spec_stats["steps"] > 0
    assert eng.num_active == 0 and len(eng.free) == 2


def test_engine_int4_kv_with_spec_mode():
    """Continuous batching over an int4 KV cache in speculative mode: the
    masked K+1 rows and the decode commits write packed D/2 bytes."""
    cfg = _tiny(port.ExLlamaConfig(), "int4")
    m = port.ExLlama(cfg, params=port.make_synthetic_params(
        cfg, 128, False, seed=31, device="cpu"), device="cpu")
    eng = ContinuousBatchingEngine(
        m, port.FakeTokenizer(), max_slots=3, prefill_bucket=16,
        spec_proposer=NgramProposer(max_ngram=3, max_draft=4))
    assert eng.cache.k[0].shape[-1] == cfg.head_dim // 2
    prompt = np.asarray([5, 9, 5, 9, 5, 9, 5, 9], np.int32)
    reqs = [eng.submit(prompt + i, max_new_tokens=8, settings=GREEDY,
                       stop_tokens=(-1,)) for i in range(3)]
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 80
    for r in reqs:
        assert len(r.new_tokens) == 8
        assert all(0 <= t < cfg.vocab_size for t in r.new_tokens)


def test_engine_candidate_cap_greedy_identical(model):
    """A candidate cap leaves greedy decoding bit-identical; a sampled run
    under it draws valid tokens."""
    tok = port.FakeTokenizer()
    ids = tok.encode("candidate cap!")[0]
    runs = []
    for cap in (0, 64):
        eng = ContinuousBatchingEngine(model, tok, max_slots=2,
                                       sampler_candidate_cap=cap)
        runs.append(eng.submit(ids, max_new_tokens=6, settings=GREEDY,
                               stop_tokens=(-1,)))
        eng.run()
    assert runs[1].new_tokens == runs[0].new_tokens
    sampled = SamplerSettings(temperature=0.9, top_k=40, top_p=0.9,
                              token_repetition_penalty_max=1.1)
    eng = ContinuousBatchingEngine(model, tok, max_slots=2,
                                   sampler_candidate_cap=64)
    r = eng.submit(ids, max_new_tokens=6, settings=sampled, stop_tokens=(-1,))
    eng.run()
    assert len(r.new_tokens) == 6
    assert all(0 <= t < model.config.vocab_size for t in r.new_tokens)


# -------------------------------------------------- against the JAX

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


def test_greedy_scenario_matches_jax_engine(pair):
    """Four requests through two slots (queueing, slot reuse, a mid-flight
    admission) in both engines, greedy: every JAX token within the margin
    of the port's best, and the two engines' tokens equal up to the first
    step where the margin is not clear."""
    jm, pm = pair
    tok = port.FakeTokenizer()
    prompts = ["alpha prompt", "tiny", "a different longer prompt here",
               "late arrival"]
    idss = [tok.encode(p)[0] for p in prompts]
    got = {}
    for name in ("jax", "port"):
        if name == "jax":
            eng = JaxEngine(jm, JaxTokenizer(), max_slots=2)
            st = JaxSettings(temperature=1.0, top_k=1, top_p=0.0,
                             token_repetition_penalty_max=1.0)
        else:
            eng = ContinuousBatchingEngine(pm, tok, max_slots=2)
            st = GREEDY
        reqs = [eng.submit(ids, max_new_tokens=8, settings=st,
                           stop_tokens=(-1,)) for ids in idss[:3]]
        eng.step()
        reqs.append(eng.submit(idss[3], max_new_tokens=8, settings=st,
                               stop_tokens=(-1,)))
        eng.run()
        got[name] = [list(r.new_tokens) for r in reqs]
    for ids, jt, pt in zip(idss, got["jax"], got["port"]):
        gaps = _forced_gaps(pm, ids, jt)
        assert gaps.max() <= MARGIN, (gaps, jt, pt)
        diff = np.nonzero(np.asarray(jt) != np.asarray(pt))[0]
        assert diff.size == 0 or gaps[diff[0]] > 0.0, (jt, pt)


def test_every_module_leaves_out_jax():
    """Every module of the port, the serving slice's, the web UI's and the
    examples' included, imports nothing of JAX or of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import exllama_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'exllama_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert {'exllama_tpu_torch.serve.engine', 'exllama_tpu_torch.serve.ws',"
        " 'exllama_tpu_torch.webui.app',"
        " 'exllama_tpu_torch.examples.example_chatbot'} <= set(mods)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'exllama_tpu' or m.startswith('exllama_tpu.')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_mesh_is_not_ported(model):
    with pytest.raises(NotImplementedError, match="item 8"):
        ContinuousBatchingEngine(model, port.FakeTokenizer(), mesh=object())


# ------------------------------------------------ the per-row samplers

ROWS = 8
SAMPLER_CASES = {
    # (temperature, top_k, top_p, min_p, typical) per row
    "greedy": [(1.0, 1, 0.0, 0.0, 0.0)] * 4 + [(0.7, 1, 0.65, 0.0, 0.0),
                                               (1.3, 1, 0.0, 0.0, 0.4)] * 2,
    "top_k": [(t, k, 0.0, 0.0, 0.0) for t, k in
              ((1.0, 40), (0.8, 5), (1.2, 0), (0.95, 2), (1.0, 260),
               (0.6, 17), (1.5, 0), (1.0, 100))],
    "top_p_min_p": [(t, k, p, mp, 0.0) for t, k, p, mp in
                    ((0.95, 40, 0.65, 0.0), (0.8, 0, 0.9, 0.02),
                     (1.0, 0, 0.5, 0.05), (1.2, 10, 0.75, 0.01),
                     (1.0, 1, 0.65, 0.0), (0.7, 0, 0.0, 0.3),
                     (1.0, 0, 0.95, 0.001), (1.3, 50, 0.3, 0.0))],
    "typical": [(t, k, p, 0.0, ty) for t, k, p, ty in
                ((1.0, 0, 0.0, 0.25), (0.9, 40, 0.65, 0.5),
                 (1.1, 0, 0.9, 0.9), (1.0, 0, 0.0, 0.0),
                 (0.8, 20, 0.0, 0.3), (1.0, 0, 0.75, 0.1),
                 (1.4, 0, 0.0, 0.6), (1.0, 5, 0.0, 0.2))],
}


def _settings(rows):
    cols = list(zip(*rows))
    dtypes = (np.float32, np.int32, np.float32, np.float32, np.float32)
    return [np.asarray(c, d) for c, d in zip(cols, dtypes)]


def _logits(seed, width=260):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ROWS, width)) * 3).astype(np.float32)


@pytest.mark.parametrize("case", [*SAMPLER_CASES, "candidate_cap"])
def test_filter_rows_match_jax(case):
    """Per row with mixed settings: the port's batched filter against
    ``jax.vmap(_filter_row)`` within 1e-5, and a draw under a generator
    lands only on kept tokens. ``candidate_cap``: both filter the top-C
    logits (C = 64) of each row, the typical and top-p rows included."""
    rows = SAMPLER_CASES.get(case, SAMPLER_CASES["typical"])
    sets = _settings(rows)
    lg = _logits(sum(map(ord, case)))
    width = lg.shape[1]
    if case == "candidate_cap":
        vals, idx = jax.lax.top_k(jnp.asarray(lg), 64)
        want = np.asarray(jax.vmap(jax_filter_row)(vals, *sets))
        tv, ti = torch.topk(torch.from_numpy(lg), 64, dim=-1)
        assert np.array_equal(ti.numpy(), np.asarray(idx))
        got = filter_rows(tv, *(torch.from_numpy(s) for s in sets)).numpy()
        width = 64
    else:
        want = np.asarray(jax.vmap(jax_filter_row)(lg, *sets))
        got = filter_rows(torch.from_numpy(lg),
                          *(torch.from_numpy(s) for s in sets)).numpy()
    assert got.shape == (ROWS, width)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    gen = torch.Generator().manual_seed(3)
    cap = 64 if case == "candidate_cap" else 0
    drawn = filter_sample_rows(torch.from_numpy(lg), gen,
                               *(torch.from_numpy(s) for s in sets),
                               candidate_cap=cap).numpy()
    assert drawn.dtype == np.int32
    if cap:
        for r in range(ROWS):
            assert drawn[r] in np.asarray(idx)[r][want[r] > 0]
    else:
        assert np.all(want[np.arange(ROWS), drawn] > 0)
    if case == "greedy":
        assert np.array_equal(drawn, lg.argmax(axis=1))


@pytest.mark.parametrize("sustain,decay", [(256, 128), (20, 10), (-1, 0)])
def test_rep_mask_windowed_matches_jax(sustain, decay):
    """Per-row penalties over each slot's history window, rows at penalty
    1.0 included, against the JAX engine's ``_rep_mask_windowed``."""
    rng = np.random.default_rng(sustain + 1000)
    hist = rng.integers(0, 260, (5, 128)).astype(np.int32)
    lens = np.array([0, 5, 128, 77, 40], np.int32)
    pen = np.array([1.0, 1.15, 1.3, 1.1, 1.0], np.float32)
    want = np.asarray(_rep_mask_windowed(jnp.asarray(hist), jnp.asarray(lens),
                                         jnp.asarray(pen), 260, sustain,
                                         decay))
    got = rep_mask_windowed(torch.from_numpy(hist), torch.from_numpy(lens),
                            torch.from_numpy(pen), 260, sustain, decay)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert torch.all(got[[0, 4]] == 1.0)
