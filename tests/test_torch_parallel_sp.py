"""Sequence parallelism of the port (``parallel.sequence``) against the JAX
package's sequence functions inside ``shard_map`` on the CPU.

One gloo world of two ranks (``parallel.launch.run_world``) runs every
case of ``parallel.worlds.sp_ops`` and ``sp_decode``; the JAX references
run here, in the parent, on ``make_sp_mesh(sp=2)`` of the 8-device CPU mesh
(tests/conftest.py), on the same inputs, at tests/test_sequence_parallel.py's
shapes and tolerances: ``sp_attend`` at scalar and ``[B]`` cursors over
bf16 (the inputs f32, as there), int8 and int4 caches within 2e-3; the
owner-masked write over each cache format bit for bit (int8 / int4
scales within two f32 steps of the jitted JAX write's); ring prefill
attention within 3e-3; the whole-model decode step against
``make_sp_decode_fn`` (and against the port's unsharded step) within that
file's 3e-2 for its model-level check.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from exllama_tpu.ops.attention import quantize_kv_rows as jax_quant8
from exllama_tpu.ops.attention import quantize_kv_rows4 as jax_quant4
from exllama_tpu.parallel.sequence import (
    make_sp_mesh,
    ring_attend_prefill,
    sp_attend,
    sp_update_kv_cache,
)

from exllama_tpu_torch.parallel.launch import run_world

SP = 2
B, H, HKV, D, S = 2, 8, 4, 64, 64
ATOL, RING_TOL, MODEL_TOL = 2e-3, 3e-3, 3e-2
RNG = np.random.default_rng(21)


def _f32(*shape, scale=0.5):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


Q1 = _f32(B, 1, H, D)
KC, VC = _f32(B, HKV, S, D), _f32(B, HKV, S, D)


def _quantized(kind):
    """The whole cache quantized per (token, head) by the JAX functions:
    (k, v, k_scale, v_scale) as numpy, [B, Hkv, S, D(/2)] and [B, Hkv, S]."""
    fn = jax_quant8 if kind == "int8" else jax_quant4
    qk, sk = fn(jnp.swapaxes(jnp.asarray(KC), 1, 2))
    qv, sv = fn(jnp.swapaxes(jnp.asarray(VC), 1, 2))
    sw = lambda x: np.asarray(jnp.swapaxes(x, 1, 2))   # noqa: E731
    return sw(qk), sw(qv), sw(sk), sw(sv)


QUANT = {kind: _quantized(kind) for kind in ("int8", "int4")}
CURSORS = np.asarray([9, 33], np.int32)
ATTEND = ([("bf16", p) for p in (0, 17, 40, 63)] + [("bf16", "cursors")]
          + [(k, p) for k in ("int8", "int4") for p in (0, 17, 63)])
WRITES = ([("bf16", p, t) for p, t in ((0, 1), (13, 1), (30, 4), (62, 1))]
          + [("int8", p, t) for p, t in ((0, 1), (13, 1), (30, 4))]
          + [("int4", 21, 1)])
NEW = {t: (_f32(B, t, HKV, D, scale=1.0), _f32(B, t, HKV, D, scale=1.0))
       for t in (1, 4)}
RING = {t: (_f32(B, t, H, D, scale=0.4), _f32(B, t, HKV, D, scale=0.4),
            _f32(B, t, HKV, D, scale=0.4)) for t in (64, 128)}
MODEL = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
             num_key_value_heads=2, head_dim=64, num_hidden_layers=2,
             vocab_size=128, max_seq_len=64, max_input_len=64,
             max_attention_size=64 * 64)
IDS = ((np.arange(10, dtype=np.int32)[None] * 7 + 3) % 128)
FORCED = np.asarray([[IDS[0, -1], 17, 90, 44]], np.int32)


def _attend_case(kind, past):
    p = CURSORS if past == "cursors" else past
    if kind == "bf16":
        return ("attend", Q1, KC, VC, p, None, None)
    k, v, ks, vs = QUANT[kind]
    return ("attend", Q1, k, v, p, ks, vs)


def _write_case(kind, past, t):
    nk, nv = NEW[t]
    if kind == "bf16":
        z = np.zeros((B, HKV, S, D), np.float32)
        return ("write", z, z.copy(), nk, nv, past, None, None)
    width = D if kind == "int8" else D // 2
    z = np.zeros((B, HKV, S, width), np.int8)
    zs = np.zeros((B, HKV, S), np.float32)
    return ("write", z, z.copy(), nk, nv, past, zs, zs.copy())


def _cases():
    cases = {f"attend-{k}-{p}": _attend_case(k, p) for k, p in ATTEND}
    cases.update({f"write-{k}-{p}-{t}": _write_case(k, p, t)
                  for k, p, t in WRITES})
    cases.update({f"ring-{t}": ("ring",) + RING[t] for t in RING})
    return cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_sp_mesh(sp=SP)


@pytest.fixture(scope="module")
def world(mesh):
    """The cases and the decode steps on one gloo world of two ranks (32
    positions a rank: the 4-row write at 30 crosses from one to the other),
    started in the background while the JAX references compile and run
    (their functions cache per shape)."""
    runs = [("ops", "sp_ops", dict(device="cpu", cases=_cases()))]
    runs += [(f"decode-{kv}", "sp_decode",
              dict(device="cpu", cfg=MODEL,
                   tuning=dict(attn_len_bucket=0, kv_cache_dtype=kv),
                   gs=32, seed=9, prompt=IDS[:, :-1], forced=FORCED,
                   reference=True))
             for kv in ("bf16", "int8")]
    with ThreadPoolExecutor(max_workers=1) as pool:
        job = pool.submit(run_world,
                          "exllama_tpu_torch.parallel.worlds:run_all", SP,
                          (runs,), backend="gloo", timeout=600)
        for kind, past in ATTEND:
            _jax_attend(mesh, _attend_case(kind, past))
        for kind, past, t in WRITES:
            _jax_write(mesh, _write_case(kind, past, t))
        for t in RING:
            _jax_ring(mesh, t)
        for kv in ("bf16", "int8"):
            _jax_decode(kv, mesh)
        ranks = job.result()
    return {name: [r[name] for r in ranks] for name, _, _ in runs}


KV = P(None, None, "sp", None)
SC = P(None, None, "sp")


@functools.lru_cache(maxsize=None)
def _attend_fn(mesh, cursors: bool, quantized: bool):
    """The JAX sp_attend in shard_map, jitted: one compile a cache format
    and cursor shape, the cursor's value traced."""
    pspec = P(None) if cursors else P()
    if not quantized:
        return jax.jit(shard_map(
            functools.partial(sp_attend, axis="sp"), mesh=mesh,
            in_specs=(P(None), KV, KV, pspec), out_specs=P(None)))
    return jax.jit(shard_map(
        lambda q, k, v, p, ks, vs: sp_attend(q, k, v, p, axis="sp",
                                             k_scale=ks, v_scale=vs),
        mesh=mesh, in_specs=(P(None), KV, KV, pspec, SC, SC),
        out_specs=P(None)))


def _jax_attend(mesh, case):
    _, q, k, v, past, ks, vs = case
    past = jnp.asarray(past, jnp.int32)
    fn = _attend_fn(mesh, past.ndim == 1, ks is not None)
    return fn(q, k, v, past) if ks is None else fn(q, k, v, past, ks, vs)


@pytest.mark.parametrize("kind,past", ATTEND)
def test_sp_attend_matches_jax(world, mesh, kind, past):
    """Distributed flash decoding: each rank's output against the JAX
    sp_attend on the same cache (int8 / int4: the same bytes and scales)."""
    case = _attend_case(kind, past)
    ref = np.asarray(_jax_attend(mesh, case))
    for r in world["ops"]:
        got = r[f"attend-{kind}-{past}"]
        np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _write_fn(mesh, quantized: bool):
    """The JAX owner-masked write in shard_map, jitted (the cursor traced)."""
    if not quantized:
        return jax.jit(shard_map(
            functools.partial(sp_update_kv_cache, axis="sp"), mesh=mesh,
            in_specs=(KV, KV, P(None), P(None), P()), out_specs=(KV, KV)))
    return jax.jit(shard_map(
        lambda k, v, nk, nv, p, ks, vs: sp_update_kv_cache(
            k, v, nk, nv, p, axis="sp", k_scale=ks, v_scale=vs),
        mesh=mesh, in_specs=(KV, KV, P(None), P(None), P(), SC, SC),
        out_specs=(KV, KV, SC, SC)))


def _jax_write(mesh, case):
    _, k, v, nk, nv, past, ks, vs = case
    fn = _write_fn(mesh, ks is not None)
    past = jnp.int32(past)
    if ks is None:
        return fn(k, v, nk, nv, past)
    return fn(k, v, nk, nv, past, ks, vs)


@pytest.mark.parametrize("kind,past,t", WRITES)
def test_owner_masked_write_matches_jax(world, mesh, kind, past, t):
    """The owner-masked write: the ranks' positions, concatenated, equal the
    JAX write's rows bit for bit, and its int8 / int4 scales within two f32
    steps (under jit XLA turns the scale's division by 127 / 7 into a
    product with the reciprocal, a last-bit difference from the eager
    division the port matches: the port's scales equal the eager JAX
    ``quantize_kv_rows``' bit for bit, tests/test_torch_kvcache.py)."""
    ref = _jax_write(mesh, _write_case(kind, past, t))
    for i, want in enumerate(ref):
        got = np.concatenate([r[f"write-{kind}-{past}-{t}"][i]
                              for r in world["ops"]], axis=2)
        if i < 2:
            np.testing.assert_array_equal(got, np.asarray(want))
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=2.5e-7,
                                       atol=0)


@functools.lru_cache(maxsize=None)
def _jax_ring(mesh, t):
    spec = P(None, "sp", None, None)
    fn = jax.jit(shard_map(functools.partial(ring_attend_prefill, axis="sp",
                                             axis_size=SP),
                           mesh=mesh, in_specs=(spec, spec, spec),
                           out_specs=spec))
    return np.asarray(fn(*RING[t]))


@pytest.mark.parametrize("t", list(RING))
def test_ring_prefill_matches_jax(world, mesh, t):
    ref = _jax_ring(mesh, t)
    got = np.concatenate([r[f"ring-{t}"] for r in world["ops"]], axis=1)
    np.testing.assert_allclose(got, ref, rtol=RING_TOL, atol=RING_TOL)


@functools.lru_cache(maxsize=None)
def _jax_decode(kv_dtype, mesh):
    """make_sp_decode_fn after a token-by-token prefill through it (the JAX
    test's own procedure), then the teacher-forced steps."""
    from exllama_tpu.cache import ExLlamaCache
    from exllama_tpu.config import ExLlamaConfig
    from exllama_tpu.formats.loader import make_synthetic_params
    from exllama_tpu.models.llama import ExLlama
    from exllama_tpu.parallel.sequence import make_sp_decode_fn, shard_cache_sp

    cfg = ExLlamaConfig()
    for k, v in MODEL.items():
        setattr(cfg, k, v)
    cfg.tuning.matmul_impl = "xla"
    cfg.tuning.attn_len_bucket = 0
    cfg.tuning.kv_cache_dtype = kv_dtype
    model = ExLlama(cfg, params=make_synthetic_params(cfg, 32, False, seed=9))
    kv = shard_cache_sp(ExLlamaCache(model), mesh).state
    fn = make_sp_decode_fn(model, mesh)
    for i in range(IDS.shape[1] - 1):
        _, kv = fn(model.params, kv, IDS[:, i:i + 1], jnp.int32(i))
    rows = []
    for j in range(FORCED.shape[1]):
        lg, kv = fn(model.params, kv, FORCED[:, j:j + 1],
                    jnp.int32(IDS.shape[1] - 1 + j))
        rows.append(np.asarray(lg, np.float32)[:, -1])
    return np.stack(rows)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_sp_decode_step_matches_jax(world, mesh, kv_dtype):
    """The port's whole-model decode step over a cache split two ways:
    against the JAX make_sp_decode_fn and the port's unsharded step, every
    rank the same logits; each rank keeps 32 of the 64 positions."""
    ref = _jax_decode(kv_dtype, mesh)
    ranks = world[f"decode-{kv_dtype}"]
    for r in ranks:
        assert r["positions"] == S // SP
        np.testing.assert_array_equal(r["steps"], ranks[0]["steps"])
        np.testing.assert_allclose(r["steps"], ref, rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
        np.testing.assert_allclose(r["steps"], r["reference"],
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
