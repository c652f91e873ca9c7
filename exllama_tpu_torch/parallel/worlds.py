"""Per-rank programs that drive the parallel paths, for
``parallel.launch.run_world``: the CPU tests run them on gloo worlds at tiny
shapes and hold the results against the JAX package in the parent process;
chip_smoke's phase 14 runs them as ranks on the card at Llama-7B width and
holds them against the unsharded port. Each takes one ``spec`` dict (plain
values and numpy arrays) and returns plain values and numpy arrays.

  * :func:`tp_forward`: a model on a ``("dp", "tp")`` (or pod) mesh, a
    prefill, teacher-forced decode steps and a greedy-head step
    (:func:`forced_run`): the logits, the tokens, the kernel launches per
    prefill and per step, each step's ms on this rank;
  * :func:`sp_ops`: the sequence-parallel functions on the caller's
    inputs (``sp_attend`` at a scalar and a ``[B]`` cursor over bf16, int8
    and int4 rows, the owner-masked write, ring prefill attention);
  * :func:`sp_decode`: the whole-model sequence-parallel decode step over a
    cache whose positions split over the ranks;
  * :func:`engine_tokens`: the continuous-batching engine over a mesh;
  * :func:`collectives`: which collectives the backend runs on the
    device's tensors;
  * :func:`refusals` (LoRA and beams under tp), :func:`benchmark_build`
    (``benchmark --tp / --dp``), and :func:`run_all`, several of them in
    one world.

Each runs its tensors on the card unless its spec names another device
(``spec["device"]``; the CPU tests name ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist


def make_config(fields: dict, tuning: dict = None):
    """An ExLlamaConfig with ``fields`` set, then ``tuning``'s knobs."""
    from exllama_tpu_torch.config import ExLlamaConfig

    cfg = ExLlamaConfig()
    for k, v in fields.items():
        setattr(cfg, k, v)
    for k, v in (tuning or {}).items():
        setattr(cfg.tuning, k, v)
    return cfg


def _counts():
    """Every launch counter by chip_smoke's names: the wrapper's name (K3's
    ``attend``: ``flash_attn``) plus the counter's suffix (``_int8``,
    ``_f32``, ...)."""
    from exllama_tpu_torch import kernels

    return {{"attend": "flash_attn"}.get(fn.__name__, fn.__name__)
            + attr[len("launches"):]: n
            for (fn, attr), n in kernels.launch_counts().items()}


def _since(c0):
    c = _counts()
    return {k: c[k] - c0.get(k, 0) for k in c if c[k] != c0.get(k, 0)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def centered(params):
    """params with every 4-bit tensor's zero-point at its nibbles' mean
    (zscale = 7.5 * scales): zero-mean weights.
    ``make_synthetic_params(fast=True)`` puts it at 8, so every weight
    carries -s/2; through the layers at 7B width that common mode grows the
    residual stream by orders of magnitude and leaves the logits
    ill-conditioned, so no comparison of two implementations holds there.
    Per element, so it commutes with a rank's slicing (a zero-scale tail
    keeps zscale 0)."""
    from exllama_tpu_torch.formats.gptq import QuantTensor

    def c(qt):
        if not isinstance(qt, QuantTensor):
            return qt
        return dataclasses.replace(qt, zscale=(qt.scales.float() * 7.5).to(
            qt.scales.dtype))

    layers = [dataclasses.replace(lp, **{
        f.name: c(getattr(lp, f.name)) for f in dataclasses.fields(lp)
        if isinstance(getattr(lp, f.name), QuantTensor)})
        for lp in params.layers]
    return dataclasses.replace(params, layers=layers,
                               lm_head=c(params.lm_head))


def build_model(spec, mesh, device):
    """The model ``spec`` names (``cfg`` fields, ``tuning``, ``gs``,
    ``act_order``, ``seed``, ``fast``, ``centered``), this rank's shard of
    it on ``mesh`` (None: whole)."""
    from exllama_tpu_torch.formats.loader import make_synthetic_params
    from exllama_tpu_torch.models.llama import ExLlama

    cfg = make_config(spec["cfg"], spec.get("tuning"))
    params = make_synthetic_params(cfg, spec.get("gs", 128),
                                   spec.get("act_order", False),
                                   seed=spec.get("seed", 0), device=device,
                                   fast=spec.get("fast", False), mesh=mesh)
    if spec.get("centered"):
        params = centered(params)
    return ExLlama(cfg, params=params, device=device)


def _logit_rows(out):
    return out[:, -1, :].to(torch.float32).cpu().numpy()


def forced_run(model, prompt, forced, batch, argmax_token=None):
    """Prefill ``prompt`` [B, T], then one decode step per column of
    ``forced`` [B, n] (teacher-forced). Returns the logits of the prefill's
    last position and of each step, the greedy tokens of each step, the
    launches per prefill and per step and each step's ms (host clock, the
    device synchronised). ``argmax_token``: then one more step on it
    through the greedy head (``forward_chunk(head_mode="argmax")``), its
    ids and launches."""
    from exllama_tpu_torch.cache import ExLlamaCache

    device = model.device
    cache = ExLlamaCache(model, batch_size=batch)
    c0 = _counts()
    pre = model.forward(prompt, cache)
    _sync(device)
    res = {"prefill": _logit_rows(pre), "per_prefill": _since(c0),
           "steps": [], "tokens": [], "per_step": [], "ms": []}
    for j in range(forced.shape[1]):
        _sync(device)
        c0 = _counts()
        t0 = time.perf_counter()
        out = model.forward(forced[:, j:j + 1], cache)
        _sync(device)
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["per_step"].append(_since(c0))
        rows = _logit_rows(out)
        res["steps"].append(rows)
        res["tokens"].append(rows.argmax(axis=-1).tolist())
    res["steps"] = np.stack(res["steps"]) if res["steps"] else None
    if argmax_token is not None:
        from exllama_tpu_torch.models.llama import forward_chunk

        cfg, tune = model.config, model.config.tuning
        past = cache.current_seq_len
        tok = torch.full((batch, 1), argmax_token, dtype=torch.int32,
                         device=device)
        c0 = _counts()
        ids = forward_chunk(
            model.params, cache, tok, past, None,
            attend_len=model._attend_len(past + 1), last_token_only=True,
            preprocess_only=False, heads=cfg.num_attention_heads,
            kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
            eps=cfg.rms_norm_eps, head_mode="argmax", mlp_fuse=tune.fuse_mlp,
            attn_fuse=tune.fuse_attn, qkv_fuse=tune.fuse_qkv,
            commit_impl=tune.commit_impl, matmul_impl=tune.matmul_impl,
            attn_impl=tune.attn_impl)
        _sync(device)
        res["per_argmax"] = _since(c0)
        res["argmax"] = ids.reshape(-1).cpu().tolist()
    return res


def _mesh(spec):
    from exllama_tpu_torch.parallel.mesh import make_mesh
    from exllama_tpu_torch.parallel.multihost import make_pod_mesh

    if spec.get("mesh") == "pod":
        return make_pod_mesh(tp=spec["tp"], dp_per_host=spec.get("dp", 1))
    return make_mesh(tp=spec["tp"], dp=spec.get("dp", 1))


def tp_forward(spec: dict) -> dict:
    """``spec``: ``cfg`` (config fields), ``tuning``, ``tp``, ``dp``
    (``mesh="pod"``: the pod mesh, dp a host), ``gs``, ``act_order``,
    ``seed``, ``fast``, ``device``, ``prompt`` [B, T] and ``forced`` [B, n]
    int arrays, ``argmax_token``. ``forced_run`` on this rank's shard, plus
    the rank's shapes of layer 0."""
    device = torch.device(spec.get("device", "cuda"))
    prompt = np.asarray(spec["prompt"], np.int32)
    forced = np.asarray(spec["forced"], np.int32)
    model = build_model(spec, _mesh(spec), device)
    out = forced_run(model, prompt, forced, prompt.shape[0],
                     spec.get("argmax_token"))
    lp = model.params.layers[0]
    out["shapes"] = {name: [qt.in_features, qt.out_features]
                     for name in ("qkv", "q", "o", "gateup", "gate", "down")
                     if (qt := getattr(lp, name)) is not None}
    out["rank"] = dist.get_rank()
    return out


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------

def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _positions(a, mesh, dim=2):
    """This rank's share of the sequence axis ``dim`` of ``a``."""
    per = a.shape[dim] // mesh.sp
    return a.narrow(dim, mesh.sp_rank * per, per).contiguous()


def sp_ops(spec: dict) -> dict:
    """The sequence-parallel functions on the parent's inputs (``cases``:
    {name: case}), each rank on its positions. A case is ``("attend", q,
    k, v, past, k_scale, v_scale)`` (caches [B, Hkv, S, D(/2)]; scales or
    None), ``("write", k, v, new_k, new_v, past, k_scale, v_scale)`` or
    ``("ring", q, k, v)`` ([B, T, *, D]). Returns {name: the output}: an
    attention's whole; a write's cache tensors and a ring's output block,
    this rank's positions only."""
    from exllama_tpu_torch.parallel.sequence import (
        make_sp_mesh,
        ring_attend_prefill,
        sp_attend,
        sp_update_kv_cache,
    )

    device = torch.device(spec.get("device", "cuda"))
    mesh = make_sp_mesh(sp=dist.get_world_size())
    out = {}
    for name, case in spec["cases"].items():
        kind, arrays = case[0], case[1:]
        if kind == "attend":
            q, k, v, past, ks, vs = arrays
            local = [_positions(_t(x, device), mesh) if x is not None
                     else None for x in (k, v, ks, vs)]
            past = past if isinstance(past, int) else _t(past, device)
            got = sp_attend(_t(q, device), local[0], local[1], past, mesh,
                            local[2], local[3])
            out[name] = got.to(torch.float32).cpu().numpy()
        elif kind == "write":
            k, v, nk, nv, past, ks, vs = arrays
            local = [_positions(_t(x, device), mesh) if x is not None
                     else None for x in (k, v, ks, vs)]
            res = sp_update_kv_cache(local[0], local[1], _t(nk, device),
                                     _t(nv, device), past, mesh,
                                     local[2], local[3])
            out[name] = [r.cpu().numpy() for r in res]
        elif kind == "ring":
            q, k, v = (_positions(_t(x, device), mesh, 1) for x in arrays)
            got = ring_attend_prefill(q, k, v, mesh)
            out[name] = got.to(torch.float32).cpu().numpy()
        else:
            raise ValueError(f"sp_ops: case kind {kind!r}")
    return out


def sp_decode(spec: dict) -> dict:
    """``spec`` as :func:`tp_forward`'s (no tp / dp): the model whole on
    every rank; ``prompt`` [B, T] prefilled through ``ExLlama.forward`` into
    a whole cache, which each rank then cuts to its positions
    (``shard_cache_sp``); then the decode steps of ``forced`` [B, n]
    through ``make_sp_decode_fn``. With ``reference`` (and ``separate``),
    the same steps through ``ExLlama.forward`` on the whole cache first (and
    again with the fusions off). Returns the steps' logits, the launches
    per sp step and its ms."""
    from exllama_tpu_torch.cache import ExLlamaCache
    from exllama_tpu_torch.parallel.sequence import (
        make_sp_decode_fn,
        make_sp_mesh,
        shard_cache_sp,
    )

    device = torch.device(spec.get("device", "cuda"))
    prompt = np.asarray(spec["prompt"], np.int32)
    forced = np.asarray(spec["forced"], np.int32)
    b, t = prompt.shape
    model = build_model(spec, None, device)
    mesh = make_sp_mesh(sp=dist.get_world_size())
    cache = ExLlamaCache(model, batch_size=b)
    model.forward(prompt, cache, preprocess_only=True)
    out = {}
    tune = model.config.tuning
    for key, fuse in (("reference", True), ("separate", False)):
        if not spec.get(key):
            continue
        # the whole cache's one-token steps: the default route, or the
        # fusions off (a second correct route, for the spread of the two)
        tune.fuse_mlp = tune.fuse_attn = fuse
        ref = cache.clone()
        rows = []
        for j in range(forced.shape[1]):
            rows.append(_logit_rows(model.forward(forced[:, j:j + 1], ref)))
        out[key] = np.stack(rows)
        del ref
    tune.fuse_mlp = tune.fuse_attn = True
    shard_cache_sp(cache, mesh)
    fn = make_sp_decode_fn(model, mesh)
    rows, per_step, ms = [], [], []
    for j in range(forced.shape[1]):
        _sync(device)
        c0 = _counts()
        t0 = time.perf_counter()
        logits, cache = fn(model.params, cache, forced[:, j:j + 1], t + j)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(_since(c0))
        rows.append(_logit_rows(logits))
    out.update(steps=np.stack(rows), per_step=per_step, ms=ms,
               positions=cache.k[0].shape[2])
    return out


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def engine_tokens(spec: dict) -> dict:
    """The continuous-batching engine over a ``("dp", "tp")`` mesh
    (``spec``: a model as :func:`tp_forward`'s, ``slots``, ``prompts`` (a
    list of int arrays), ``new`` tokens each, greedy; ``capture``). Every
    rank submits the same requests and runs ``step()`` in lockstep.
    Returns each request's tokens, the launches of each decode step and of
    each admission chunk, and the scenario's seconds."""
    from exllama_tpu_torch.ops.sampling import SamplerSettings
    from exllama_tpu_torch.serve.engine import ContinuousBatchingEngine
    from exllama_tpu_torch.tokenizer import FakeTokenizer

    device = torch.device(spec.get("device", "cuda"))
    model = build_model(spec, _mesh(spec), device)
    eng = ContinuousBatchingEngine(model, FakeTokenizer(),
                                   max_slots=spec["slots"],
                                   prefill_bucket=spec.get("bucket", 64),
                                   attn_bucket=spec.get("attn_bucket", 256))
    greedy = SamplerSettings(temperature=1.0, top_k=1, top_p=0.0,
                             token_repetition_penalty_max=1.0)
    counted = {"chunk": [], "step": []}

    def wrap(kind, fn):
        def call(*a):
            c0 = _counts()
            r = fn(*a)
            counted[kind].append(_since(c0))
            return r
        return call

    eng._prefill_chunk = wrap("chunk", eng._prefill_chunk)
    eng._run_decode = wrap("step", eng._run_decode)
    _sync(device)
    t0 = time.perf_counter()
    reqs = [eng.submit(np.asarray(p, np.int32), spec["new"], settings=greedy,
                       stop_tokens=(-1,)) for p in spec["prompts"]]
    eng.run()
    _sync(device)
    secs = time.perf_counter() - t0
    return dict(tokens=[list(r.new_tokens) for r in reqs], seconds=secs,
                per_step=counted["step"], per_chunk=counted["chunk"],
                free=len(eng.free), rows=[eng._rows.start, eng._rows.stop],
                cache_rows=eng.cache.batch_size, rank=dist.get_rank())


# ---------------------------------------------------------------------------
# What the backend carries
# ---------------------------------------------------------------------------

PROBES = ("all_reduce_sum_f32", "all_reduce_sum_bf16", "all_reduce_max_f32",
          "all_reduce_sum_int32", "broadcast", "all_gather",
          "all_gather_into_tensor", "all_gather_into_tensor_bf16",
          "batch_isend_irecv")


def collectives(spec: dict) -> dict:
    """Each collective of ``spec["probes"]`` (default: all of ``PROBES``)
    on ``spec["device"]`` tensors of this world: {name: "ok", or the
    error's first line, or "wrong result"}. An op the backend cannot do may
    abort the process instead of raising (gloo's TCP transport writing from
    a device pointer): rank 0 appends each probe's name before it runs and
    its result after to the file ``spec["log"]`` (if given), so the caller
    can tell which one it was."""
    device = torch.device(spec.get("device", "cuda"))
    rank, n = dist.get_rank(), dist.get_world_size()
    res = {}

    def note(line):
        if rank == 0 and spec.get("log"):
            with open(spec["log"], "a") as f:
                f.write(line + "\n")

    def reduce(dtype, op, want):
        x = torch.full((4,), rank + 1, dtype=dtype, device=device)
        dist.all_reduce(x, op=op)
        return bool((x == want).all())

    def gather():
        parts = [torch.empty(2, device=device) for _ in range(n)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=device))
        return all(bool((p == i).all()) for i, p in enumerate(parts))

    def gather_tensor(dtype):
        out = torch.empty(2 * n, dtype=dtype, device=device)
        dist.all_gather_into_tensor(
            out, torch.full((2,), float(rank), dtype=dtype, device=device))
        return bool((out == torch.arange(n, device=device)
                     .repeat_interleave(2)).all())

    def broadcast():
        x = torch.full((3,), float(rank + 5), device=device)
        dist.broadcast(x, src=0)
        return bool((x == 5).all())

    def ring():
        x = torch.full((3,), float(rank), device=device)
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % n),
               dist.P2POp(dist.irecv, y, (rank - 1) % n)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return bool((y == (rank - 1) % n).all())

    tri = n * (n + 1) // 2
    fns = {
        "all_reduce_sum_f32":
            lambda: reduce(torch.float32, dist.ReduceOp.SUM, tri),
        "all_reduce_sum_bf16":
            lambda: reduce(torch.bfloat16, dist.ReduceOp.SUM, tri),
        "all_reduce_max_f32":
            lambda: reduce(torch.float32, dist.ReduceOp.MAX, n),
        "all_reduce_sum_int32":
            lambda: reduce(torch.int32, dist.ReduceOp.SUM, tri),
        "broadcast": broadcast, "all_gather": gather,
        "all_gather_into_tensor": lambda: gather_tensor(torch.float32),
        "all_gather_into_tensor_bf16": lambda: gather_tensor(torch.bfloat16),
        "batch_isend_irecv": ring,
    }
    for name in spec.get("probes", PROBES):
        note(f"start {name}")
        try:
            res[name] = "ok" if fns[name]() else "wrong result"
        except Exception as e:          # noqa: BLE001 - reported, not raised
            res[name] = (str(e).strip().splitlines() or [type(e).__name__])[0]
        note(f"{name}: {res[name]}")
        dist.barrier()
    return res


def refusals(spec: dict) -> dict:
    """What a tp mesh refuses, as the JAX package does: a LoRA adapter in
    the forward (llama.py:707-710) and beam search (generator.py:635-641).
    {case: the exception's type and message}."""
    from exllama_tpu_torch.cache import ExLlamaCache
    from exllama_tpu_torch.generator import ExLlamaGenerator
    from exllama_tpu_torch.lora import LayerLora
    from exllama_tpu_torch.tokenizer import FakeTokenizer

    device = torch.device(spec.get("device", "cuda"))
    model = build_model(spec, _mesh(spec), device)
    cfg = model.config
    out = {}

    def caught(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:          # noqa: BLE001 - the refusal itself
            out[name] = f"{type(e).__name__}: {e}"

    import types

    a = torch.zeros((cfg.hidden_size, 4), dtype=torch.bfloat16)
    b = torch.zeros((4, cfg.num_attention_heads * cfg.head_dim),
                    dtype=torch.bfloat16)
    adapter = types.SimpleNamespace(stacked=[     # what forward reads of one
        LayerLora(q=(a, b), k=None, v=None, o=None, gate=None, up=None,
                  down=None) for _ in range(cfg.num_hidden_layers)])
    caught("lora", lambda: model.forward(np.array([[5, 6]], np.int32),
                                         ExLlamaCache(model), lora=adapter))
    gen = ExLlamaGenerator(model, FakeTokenizer(), ExLlamaCache(model))
    gen.settings.beams, gen.settings.beam_length = 2, 2
    caught("beams", gen.begin_beam_search)
    return out


def run_all(scenarios: list) -> dict:
    """Several of this module's programs in one world, in order: each
    ``(name, function name, spec)``; every rank runs each. {name: its
    result}."""
    out = {}
    for name, fn, spec in scenarios:
        out[name] = globals()[fn](spec)
        dist.barrier()
    return out


def benchmark_build(argv: list) -> dict:
    """``benchmark.load`` on ``argv`` (``--tp`` / ``--dp`` flags: this
    world's ranks), then one prefill; the logits of its last position, the
    mesh and the rank's layer-0 shapes."""
    from exllama_tpu_torch import benchmark
    from exllama_tpu_torch.cache import ExLlamaCache

    args = benchmark.parse_args(argv)
    model, _ = benchmark.load(args)
    ids = np.arange(1, 9, dtype=np.int32)[None] * 7
    logits = model.forward(ids, ExLlamaCache(model))
    lp = model.params.layers[0]
    return dict(logits=_logit_rows(logits), mesh=repr(model.mesh),
                tp_size=model.config.tp_size, dp_size=model.config.dp_size,
                o=[lp.o.in_features, lp.o.out_features])
