"""Tensor and data parallelism of the port (``parallel.mesh``,
``parallel.multihost``, ``parallel.launch``) against the JAX package on the
CPU.

One gloo world of four ranks (``parallel.launch.run_world``, spawned once
for the module) runs every scenario of ``parallel.worlds``: a tp = 2 x
dp = 2 model (per-rank fused projections, an intermediate of 13 groups that
tp = 2 does not split into whole groups, an int8 KV cache, batch 2), a
tp = 4 act-order model (o's gather over tp, down folded at load), the pod
mesh (dcn 1 x dp 2 x tp 2), the continuous-batching engine at dp = 2 x
tp = 2, the refusals, and ``benchmark --synthetic tiny --tp 2 --dp 2``. The
JAX references run here, in the parent, on the 8-device CPU mesh of
tests/conftest.py with ``matmul_impl="xla"``: ``forward`` on
``make_mesh(tp, dp)`` / ``make_pod_mesh`` over params from the same seed
(``shard_params``), held at the JAX package's own tolerance for its
sharded forward, rtol = atol = 4e-2 (tests/test_sharding.py:98-101). The
engine is held against the port's unsharded engine (itself held against
the JAX engine in tests/test_torch_serve.py): the JAX engine over a mesh
crashes XLA:CPU late in a suite (tests/test_sharding.py:282-293).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.parallel import multihost as jax_multihost
from exllama_tpu.parallel.mesh import make_mesh as jax_make_mesh
from exllama_tpu.parallel.mesh import shard_cache as jax_shard_cache
from exllama_tpu.parallel.mesh import shard_params as jax_shard_params

import exllama_tpu_torch as port
from exllama_tpu_torch.formats.gptq import (
    dequantize,
    load_quant_tensor,
    quantize_matrix,
    slice_in_rows,
    slice_out_columns,
    tp_chunk,
)
from exllama_tpu_torch.ops.sampling import SamplerSettings
from exllama_tpu_torch.parallel import make_mesh, shard_params, validate_tp
from exllama_tpu_torch.parallel.launch import run_world
from exllama_tpu_torch.parallel.multihost import initialize, local_batch_slice
from exllama_tpu_torch.serve import ContinuousBatchingEngine

TOL = 4e-2          # tests/test_sharding.py's sharded-forward tolerance
MARGIN = 0.03       # the engine's greedy tokens on the teacher-forced logits
FIELDS = dict(hidden_size=256, intermediate_size=416, num_attention_heads=8,
              num_key_value_heads=4, head_dim=32, num_hidden_layers=2,
              vocab_size=128, max_seq_len=32, max_input_len=32,
              max_attention_size=32 * 32)
TUNING = dict(attn_len_bucket=0)
CPU = dict(device="cpu")             # the rank programs default to the card
RNG = np.random.default_rng(15)
PROMPT2 = RNG.integers(4, 128, (2, 8)).astype(np.int32)
FORCED2 = RNG.integers(4, 128, (2, 3)).astype(np.int32)
PROMPT1 = RNG.integers(4, 128, (1, 8)).astype(np.int32)
FORCED1 = RNG.integers(4, 128, (1, 3)).astype(np.int32)
ENGINE_PROMPTS = [RNG.integers(4, 128, n).astype(np.int32)
                  for n in (5, 11, 3, 8)]
ENGINE_NEW = 5
ARGMAX_TOKEN = 77

# the scenarios: name -> (worlds function, spec); JAX mesh for each
SCENARIOS = {
    # tp 2 x dp 2: fused on each rank; 416 = 13 groups of 32 -> chunk 224
    "tp2dp2": dict(CPU, cfg=FIELDS, tuning=dict(TUNING, kv_cache_dtype="int8"),
                   tp=2, dp=2, gs=32, seed=3, prompt=PROMPT2,
                   forced=FORCED2, argmax_token=ARGMAX_TOKEN),
    # tp 4: act-order (o's x_map gathered over tp; down folded at load)
    "tp4_act": dict(CPU, cfg=FIELDS, tuning=TUNING, tp=4, dp=1, gs=32, seed=5,
                    act_order=True, prompt=PROMPT1, forced=FORCED1),
    "pod": dict(CPU, cfg=FIELDS, tuning=TUNING, tp=2, dp=2, gs=32, seed=7,
                mesh="pod", prompt=PROMPT2, forced=FORCED2[:, :0]),
}
ENGINE = dict(CPU, cfg=dict(FIELDS, max_seq_len=64, max_input_len=64,
                       max_attention_size=64 * 64),
              tuning=dict(attn_len_bucket=16), tp=2, dp=2, gs=32, seed=9,
              slots=4, bucket=8, attn_bucket=16, prompts=ENGINE_PROMPTS,
              new=ENGINE_NEW)
BENCH_ARGV = ["--synthetic", "tiny", "--cpu", "--tp", "2", "--dp", "2",
              "--backend", "gloo", "-l", "64"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RUNS = ([(name, "tp_forward", spec) for name, spec in SCENARIOS.items()]
        + [("refusals", "refusals", SCENARIOS["tp4_act"]),
           ("engine", "engine_tokens", ENGINE),
           ("benchmark", "benchmark_build", BENCH_ARGV)])


@pytest.fixture(scope="module")
def _world_job():
    """Every scenario on one gloo world of four ranks, started in the
    background so that the JAX references compute meanwhile."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        yield pool.submit(run_world,
                          "exllama_tpu_torch.parallel.worlds:run_all", 4,
                          (RUNS,), backend="gloo", timeout=600)


@pytest.fixture(scope="module")
def world(_world_job):
    """{name: [rank 0's result, ..., rank 3's]}."""
    ranks = _world_job.result()
    return {name: [r[name] for r in ranks] for name, _, _ in RUNS}


def _jax_config(spec, fuse=False):
    c = JaxConfig()
    for k, v in spec["cfg"].items():
        setattr(c, k, v)
    for k, v in spec["tuning"].items():
        setattr(c.tuning, k, v)
    c.tuning.matmul_impl = "xla"
    c.tuning.fuse_projections = fuse
    return c


def _jax_run(spec, mesh):
    """The JAX forward on ``mesh``: the prefill's last logits and each
    teacher-forced step's."""
    cfg = _jax_config(spec)
    params = jax_synth(cfg, spec["gs"], spec.get("act_order", False),
                       seed=spec["seed"])
    sharded = jax_shard_params(params, mesh, fuse=True)
    model = JaxModel(cfg, params=sharded, mesh=mesh)
    b = spec["prompt"].shape[0]
    cache = JaxCache(model, batch_size=b)
    cache = (jax_multihost.shard_cache_pod(cache, mesh)
             if spec.get("mesh") == "pod" else jax_shard_cache(cache, mesh))
    out = [np.asarray(model.forward(spec["prompt"], cache), np.float32)[:, -1]]
    forced = spec["forced"]
    if "argmax_token" in spec:
        forced = np.concatenate([forced, np.full((b, 1), spec["argmax_token"],
                                                 np.int32)], axis=1)
    for j in range(forced.shape[1]):
        out.append(np.asarray(model.forward(forced[:, j:j + 1], cache),
                              np.float32)[:, -1])
    return out


@pytest.fixture(scope="module")
def jax_refs(_world_job):
    devs = jax.devices()
    meshes = {
        "tp2dp2": jax_make_mesh(tp=2, dp=2),
        "tp4_act": jax_make_mesh(tp=4, dp=1),
        "pod": jax_multihost.make_pod_mesh(tp=2, dp_per_host=2,
                                           devices=devs[:4]),
    }
    return {name: _jax_run(SCENARIOS[name], mesh)
            for name, mesh in meshes.items()}


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,step", [("tp2dp2", s) for s in range(4)]
                         + [("tp4_act", s) for s in range(4)]
                         + [("pod", 0)])
def test_forward_matches_jax_shard_map(jax_refs, world, name, step):
    """Prefill (step 0) and three teacher-forced decode steps of each rank's
    forward against the JAX forward on the same mesh shape."""
    res = world[name][0]
    got = res["prefill"] if step == 0 else res["steps"][step - 1]
    _close(got, jax_refs[name][step])


def test_greedy_head_over_tp_dp(jax_refs, world):
    """One more step through forward_chunk(head_mode="argmax") (the greedy
    head on each rank's rows, the ids gathered over dp): every rank picks
    the same ids, each within the tolerance of the JAX step's best logit."""
    ids = [r["argmax"] for r in world["tp2dp2"]]
    assert all(i == ids[0] for i in ids) and len(ids[0]) == 2
    ref = jax_refs["tp2dp2"][-1]
    for row, pick in enumerate(ids[0]):
        gap = ref[row].max() - ref[row, pick]
        assert gap <= TOL * np.abs(ref[row]).max(), (row, pick, gap)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_every_rank_holds_the_same_logits(world, name):
    """The head runs on every rank over the all-reduced residual: every
    rank's logits (and so its greedy tokens) are the same bits."""
    ranks = world[name]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["prefill"], ranks[0]["prefill"])
        if r["steps"] is not None:
            np.testing.assert_array_equal(r["steps"], ranks[0]["steps"])
            assert r["tokens"] == ranks[0]["tokens"]


@pytest.mark.parametrize("name,want", [
    # fused on each rank: qkv (256 + 2 * 128) / 2, gate|up 2 x 224 (the
    # 13-group intermediate padded to 7 groups a rank), o 256 / 2 rows
    ("tp2dp2", {"qkv": [256, 256], "o": [128, 256], "gateup": [256, 448],
                "down": [224, 256]}),
    # act-order: unfused; 416 / 4 = 3.25 groups -> 4 (the last rank 1 true)
    ("tp4_act", {"q": [256, 64], "o": [64, 256], "gate": [256, 128],
                 "down": [128, 256]}),
])
def test_rank_shapes(world, name, want):
    assert all(r["shapes"] == want for r in world[name])


def test_pod_mesh_ranks(world):
    """dcn 1 x dp 2 x tp 2: every rank agrees (the batch over dcn and dp)."""
    assert [r["rank"] for r in world["pod"]] == [0, 1, 2, 3]


@pytest.mark.parametrize("case", ["lora", "beams"])
def test_tp_refuses_what_the_jax_package_refuses(world, case):
    for r in world["refusals"]:
        assert r[case] is not None and r[case].startswith(
            "NotImplementedError"), r[case]


# ------------------------------------------------------------ the engine

def _unsharded_engine_and_model():
    from exllama_tpu_torch.parallel.worlds import make_config

    cfg = make_config(ENGINE["cfg"], ENGINE["tuning"])
    params = port.make_synthetic_params(cfg, ENGINE["gs"], seed=ENGINE["seed"],
                                        device="cpu")
    model = port.ExLlama(cfg, params=params, device="cpu")
    eng = ContinuousBatchingEngine(model, port.FakeTokenizer(),
                                   max_slots=ENGINE["slots"],
                                   prefill_bucket=ENGINE["bucket"],
                                   attn_bucket=ENGINE["attn_bucket"])
    greedy = SamplerSettings(
        temperature=1.0, top_k=1, top_p=0.0, token_repetition_penalty_max=1.0)
    reqs = [eng.submit(p, ENGINE_NEW, settings=greedy, stop_tokens=(-1,))
            for p in ENGINE_PROMPTS]
    eng.run()
    return [list(r.new_tokens) for r in reqs], model


@pytest.fixture(scope="module")
def unsharded():
    return _unsharded_engine_and_model()


@pytest.mark.parametrize("i", range(len(ENGINE_PROMPTS)))
def test_engine_over_dp_tp_matches_unsharded(world, unsharded, i):
    """dp = 2 x tp = 2, 4 slots: every rank emits the same tokens; each
    token lies within 3% of the logit scale of the unsharded model's best,
    teacher-forced, and the tokens equal the unsharded engine's up to the
    first step where that margin is not clear (random weights)."""
    toks = [r["tokens"][i] for r in world["engine"]]
    assert all(t == toks[0] for t in toks)
    got = toks[0]
    ref, model = unsharded
    assert len(got) == ENGINE_NEW
    cache = port.ExLlamaCache(model)
    prompt = ENGINE_PROMPTS[i]
    if len(prompt) > 1:
        model.forward(prompt[None, :-1], cache, preprocess_only=True)
    last = prompt[-1]
    for j, tok in enumerate(got):
        row = model.forward(np.array([[last]], np.int32), cache)[0, -1]
        row = row.float().clone()
        row[port.FakeTokenizer().bos_token_id] -= 10000.0
        scale = row.abs().max()
        gap = (row.max() - row[tok]) / scale
        assert gap <= MARGIN, (j, float(gap))
        top2 = torch.topk(row, 2).values
        if (top2[0] - top2[1]) / scale > MARGIN:
            assert tok == ref[i][j], (j, got, ref[i])
        else:
            break
        last = tok


def test_engine_slots_split_over_dp(world):
    """Each replica's slot cache holds its 2 of the 4 slots (its rows of
    local_batch_slice); every slot is free at the end."""
    rows = [r["rows"] for r in world["engine"]]
    assert rows == [[0, 2], [0, 2], [2, 4], [2, 4]]
    assert all(r["cache_rows"] == 2 and r["free"] == 4
               for r in world["engine"])


def test_benchmark_tp_dp_builds(world):
    """``benchmark --synthetic tiny --cpu --tp 2 --dp 2 --backend gloo``
    builds each rank's shard (model_init.mesh_from_args) and its forward
    agrees with the unsharded model's."""
    from exllama_tpu_torch import benchmark

    ref_model, _ = benchmark.load(benchmark.parse_args(
        ["--synthetic", "tiny", "--cpu", "-l", "64"]))
    ids = np.arange(1, 9, dtype=np.int32)[None] * 7
    ref = ref_model.forward(ids, port.ExLlamaCache(ref_model))[:, -1].float()
    for r in world["benchmark"]:
        assert (r["tp_size"], r["dp_size"]) == (2, 2)
        assert r["o"] == [128, 256]
        _close(r["logits"], ref.numpy())


# ------------------------------------------------- one rank, no world

def test_single_rank_semantics():
    """Without a world: local_batch_slice is the whole batch, initialize
    joins nothing, a 1 x 1 mesh needs no world and shard_params on it only
    attaches the mesh; a larger mesh is refused."""
    assert local_batch_slice(8) == slice(0, 8)
    assert initialize() is False
    mesh = make_mesh(1, 1)
    assert (mesh.tp, mesh.dp, mesh.sp) == (1, 1, 1)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(tp=2)
    cfg = port.ExLlamaConfig()
    for k, v in FIELDS.items():
        setattr(cfg, k, v)
    params = port.make_synthetic_params(cfg, 32, device="cpu")
    sharded = shard_params(params, mesh)
    assert sharded.mesh is mesh and sharded.layers is params.layers


@pytest.mark.parametrize("heads,kv", [(6, 4), (8, 2)])
def test_validate_tp_rejects_heads_that_do_not_split(heads, kv):
    cfg = port.ExLlamaConfig()
    cfg.num_attention_heads, cfg.num_key_value_heads = heads, kv
    with pytest.raises(ValueError, match="shardable"):
        validate_tp(cfg, 4)
    validate_tp(cfg, 2)


def _qt(k, n, gs, seed, act_order=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n), dtype=np.float32) * 0.1
    t = quantize_matrix(w, gs, act_order, rng)
    return load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                             t.get("g_idx"))


@pytest.mark.parametrize("tp,chunk", [(4, None), (4, 384), (3, 448)])
def test_column_slices_round_trip(tp, chunk):
    """Each rank's columns dequantize to the whole tensor's, and the padded
    tail to exactly 0 (tests/test_sharding.py:182's round trip)."""
    qt = _qt(512, 1280, 128, 7)
    ref = dequantize(qt)
    c = chunk or 1280 // tp
    for r in range(tp):
        got = dequantize(slice_out_columns(qt, tp, r, chunk))
        lo, hi = min(r * c, 1280), min((r + 1) * c, 1280)
        assert got.shape == (512, c)
        np.testing.assert_array_equal(got[:, :hi - lo], ref[:, lo:hi])
        np.testing.assert_array_equal(got[:, hi - lo:], 0.0)


@pytest.mark.parametrize("k,gs,tp", [(512, 128, 4), (320, 32, 5),
                                     (11008, 128, 4), (416, 32, 2)])
def test_row_slices_round_trip(k, gs, tp):
    """Each rank's rows at the uniform chunk (the port's K step: whole
    groups) dequantize to the whole tensor's rows and the padding to 0;
    11008 / 4 = 21.5 groups of 128 -> 2816 (Llama-7B's down at tp = 4)."""
    qt = _qt(k, 256, gs, 11)
    ref = dequantize(qt)
    c = tp_chunk(k, tp, gs)
    if (k, tp) == (11008, 4):
        assert c == 2816
    for r in range(tp):
        got = dequantize(slice_in_rows(qt, tp, r))
        lo, hi = min(r * c, k), min((r + 1) * c, k)
        assert got.shape == (c, 256)
        np.testing.assert_array_equal(got[:hi - lo], ref[lo:hi])
        np.testing.assert_array_equal(got[hi - lo:], 0.0)


def test_act_order_rows_carry_their_x_map():
    """An act-order o's rows keep their slice of x_map (global indices);
    gathered whole, the ranks' partial products sum to the whole one."""
    qt = _qt(256, 64, 32, 13, act_order=True)
    x = torch.randn(3, 256, dtype=torch.float32)
    w = torch.from_numpy(dequantize(qt))
    ref = x[:, qt.x_map.long()] @ w
    total = 0
    for r in range(4):
        s = slice_in_rows(qt, 4, r)
        ws = torch.from_numpy(dequantize(dataclasses.replace(s, x_map=None)))
        total = total + x[:, s.x_map.long()] @ ws
    torch.testing.assert_close(total, ref, rtol=1e-5, atol=1e-5)


def test_unfolded_act_order_down_is_refused():
    """Act-order down under tp needs the load-time fold (mesh.py:94-100)."""
    from exllama_tpu_torch.parallel.mesh import shard_layer

    cfg = port.ExLlamaConfig()
    for k, v in FIELDS.items():
        setattr(cfg, k, v)
    cfg.tuning.fold_act_order = False
    cfg.tuning.fuse_projections = False
    params = port.make_synthetic_params(cfg, 32, act_order=True, device="cpu")
    with pytest.raises(ValueError, match="fold"):
        shard_layer(params.layers[0], 2, 0)
    cfg.tuning.fuse_projections = True
    fused = port.make_synthetic_params(cfg, 32, device="cpu")
    with pytest.raises(ValueError, match="unfused"):
        shard_layer(fused.layers[0], 2, 0)


def test_per_row_adapters_split_over_dp():
    """Under dp a per-slot stacked adapter ([B, in, r] pairs) keeps the
    replica's rows; a whole-batch adapter ([in, r]) passes whole."""
    from exllama_tpu_torch.lora import LayerLora
    from exllama_tpu_torch.models.llama import _split_lora

    a3, b3 = torch.randn(4, 8, 2), torch.randn(4, 2, 6)
    a2, b2 = torch.randn(8, 2), torch.randn(2, 6)
    stack = [LayerLora(q=(a3, b3), k=None, v=(a2, b2), o=None, gate=None,
                       up=None, down=None)]
    got = _split_lora(stack, slice(2, 4), 4)[0]
    assert torch.equal(got.q[0], a3[2:4]) and torch.equal(got.q[1], b3[2:4])
    assert got.v[0] is a2 and got.v[1] is b2 and got.k is None
