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
  * :func:`front_ends`: ``serve.api``, ``serve.ws`` and the web UI over a
    mesh through ``parallel.relay`` (rank 0 serves, the other ranks
    follow), each against the same requests or calls made directly on
    every rank, and the beam-search refusal through the relay;
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
import json
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
            out.setdefault("timing", {})[name] = _ring_times(q, k, v, mesh)
        else:
            raise ValueError(f"sp_ops: case kind {kind!r}")
    return out


def _ring_times(q, k, v, mesh) -> dict:
    """This rank's ms for the whole ring prefill (a second run) and for
    one pass of its two K / V blocks ([B, Hkv, T/sp, D], the median of
    three), host clock, the device synchronised; the bytes a pass sends."""
    from exllama_tpu_torch.parallel.sequence import (
        _ring_pass,
        ring_attend_prefill,
    )

    ranks, idx = mesh.ranks("sp"), mesh.sp_rank
    nxt, prv = ranks[(idx + 1) % mesh.sp], ranks[(idx - 1) % mesh.sp]
    blocks = [x.transpose(1, 2).contiguous() for x in (k, v)]

    def ms(fn):
        _sync(q.device)
        t0 = time.perf_counter()
        fn()
        _sync(q.device)
        return (time.perf_counter() - t0) * 1e3

    ring = ms(lambda: ring_attend_prefill(q, k, v, mesh))
    passes = [ms(lambda: _ring_pass(blocks, nxt, prv, mesh.group("sp")))
              for _ in range(3)]
    return dict(ring_ms=ring, pass_ms=float(np.median(passes)),
                pass_bytes=sum(b.numel() * b.element_size() for b in blocks))


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
# The front ends over a mesh
# ---------------------------------------------------------------------------

# the clients' sampler: greedy (the HTTP fields of serve.api)
API_GREEDY = dict(top_k=1, temperature=1.0, repetition_penalty=1.0)


def tag_tokenizer():
    """The byte tokenizer with a decode that is injective per token
    (``<id>`` pieces): every token of any vocabulary shows in the text."""
    from exllama_tpu_torch.tokenizer import FakeTokenizer

    class TagTokenizer(FakeTokenizer):
        def decode(self, ids, **kw):
            ids = np.asarray(ids)
            if ids.ndim == 2:
                return [self.decode(r) for r in ids]
            return "".join(f"<{int(t)}>" for t in ids.reshape(-1))

    return TagTokenizer()


def _counted_engine(eng) -> dict:
    """Wrap ``eng``'s submit, step, decode and admission chunk: the
    requests in submission order, the steps, and the launches of each
    decode step and each admission chunk."""
    rec = {"reqs": [], "steps": 0, "step": [], "chunk": []}
    submit, step = eng.submit, eng.step

    def counted(kind, fn):
        def call(*a):
            c0 = _counts()
            r = fn(*a)
            rec[kind].append(_since(c0))
            return r
        return call

    def submit_(*a, **kw):
        req = submit(*a, **kw)
        rec["reqs"].append(req)
        return req

    def step_():
        rec["steps"] += 1
        return step()

    eng.submit, eng.step = submit_, step_
    eng._run_decode = counted("step", eng._run_decode)
    eng._prefill_chunk = counted("chunk", eng._prefill_chunk)
    return rec


def http_call(address, method, path, body=None):
    """One request to the server at ``address`` (``body`` sent as JSON):
    (status, the body's text)."""
    import http.client
    conn = http.client.HTTPConnection(*address, timeout=600)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read().decode()
    conn.close()
    return r.status, data


def api_clients(address, clients: int, new: int) -> dict:
    """``clients`` JSON and as many SSE clients at once, greedy, ``new``
    tokens each, client i's two the same prompt: {(i, stream): (status,
    body)}."""
    import threading

    out = {}

    def client(i, stream):
        out[(i, stream)] = http_call(
            address, "POST", "/v1/completions",
            dict(API_GREEDY, prompt=f"client {i} asks the engine something",
                 max_tokens=new, stream=stream))

    threads = [threading.Thread(target=client, args=(i, st))
               for i in range(clients) for st in (False, True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out


def sse_text(body: str) -> tuple:
    """(the joined text of an SSE body's deltas, whether it ended in
    [DONE])."""
    lines = [x[len("data: "):] for x in body.splitlines()
             if x.startswith("data: ")]
    done = bool(lines) and lines[-1] == "[DONE]"
    return "".join(json.loads(x)["choices"][0]["text"]
                   for x in lines[:-1]), done


def _front_api(model, tok, spec) -> dict:
    """``serve.api`` over the mesh: rank 0's server on 127.0.0.1:0 with
    its clients (:func:`api_clients`), the other ranks ``follow``; then the
    same requests, in rank 0's order, submitted directly to a fresh engine
    on every rank. Each request's tokens both ways, the steps and launches,
    and (rank 0) the answers and the relay's messages and seconds."""
    from exllama_tpu_torch.parallel.relay import Relay
    from exllama_tpu_torch.serve import api as serve_api
    from exllama_tpu_torch.serve.engine import ContinuousBatchingEngine

    relay = Relay(timeout=spec.get("relay_timeout", 300.0))
    slots = spec["slots"]
    out = {}
    t0 = time.perf_counter()
    if relay.leader:
        api, httpd, _ = serve_api.make_server(model, tok, max_slots=slots,
                                              relay=relay)
        rec = _counted_engine(api.engine)
        try:
            answers = api_clients(httpd.server_address, spec["clients"],
                                   spec["new"])
            health = http_call(httpd.server_address, "GET", "/health")
        finally:
            httpd.shutdown()
            api.shutdown()
        texts = []
        for i in range(spec["clients"]):
            (s1, body), (s2, sse) = answers[(i, False)], answers[(i, True)]
            joined, done = sse_text(sse)
            texts.append(dict(status=[s1, s2], done=done, stream=joined,
                              json=json.loads(body)["choices"][0]["text"]
                              if s1 == 200 else body))
        out.update(texts=texts, health=[health[0], json.loads(health[1])],
                   messages=relay.messages, relay_s=relay.seconds)
    else:
        eng = ContinuousBatchingEngine(model, tok, max_slots=slots)
        rec = _counted_engine(eng)
        out["follow_steps"] = serve_api.follow(eng, relay)
        out.update(messages=relay.messages, relay_s=relay.seconds)
    out["seconds"] = time.perf_counter() - t0
    reqs = rec["reqs"]
    direct = ContinuousBatchingEngine(model, tok, max_slots=slots)
    again = [direct.submit(r.prompt_ids, r.max_new_tokens,
                           settings=r.settings, stop_tokens=r.stop_tokens,
                           stop_strings=r.stop_strings, lora_id=r.lora_id)
             for r in reqs]
    direct.run()
    out.update(prompts=[r.prompt_ids.tolist() for r in reqs],
               req_ids=[r.req_id for r in reqs],
               tokens=[list(r.new_tokens) for r in reqs],
               direct=[list(r.new_tokens) for r in again],
               steps=rec["steps"], per_step=rec["step"],
               per_chunk=rec["chunk"])
    return out


class WsConn:
    """A websocket connection in process: an async iterator of ``msgs``
    (JSON-encoded), the frames sent kept in ``sent``."""

    def __init__(self, msgs):
        self.msgs, self.sent = msgs, []

    def __aiter__(self):
        async def gen():
            for m in self.msgs:
                yield json.dumps(m)
        return gen()

    async def send(self, frame):
        self.sent.append(json.loads(frame))


def _ws_msgs(new: int) -> list:
    """estimateToken, a greedy oneShotInfer and streamInfer of one prompt,
    and a sampled streamInfer."""
    greedy = dict(maxNew=new, top_k=1, temperature=1.0, rep_pen=1.0)
    return [dict(action="estimateToken", request_id="a",
                 text="count these tokens"),
            dict(action="oneShotInfer", request_id="b", text="one shot",
                 **greedy),
            dict(action="streamInfer", request_id="c", text="one shot",
                 **greedy),
            dict(action="streamInfer", request_id="d", text="sampled",
                 maxNew=new, top_k=20, temperature=0.8, rep_pen=1.1)]


def _ws_run(proto, new) -> list:
    import asyncio

    conn = WsConn(_ws_msgs(new))
    asyncio.run(proto.handle(conn))
    return conn.sent


def _front_ws(model, tok, spec) -> dict:
    """``serve.ws`` over the mesh: rank 0's protocol (a mirrored
    generator) through an in-process connection, the other ranks
    ``follow_calls``; then the same messages through a plain protocol on
    every rank. Rank 0's frames both ways; every rank's sequence after the
    mirrored run."""
    from exllama_tpu_torch.alt_generator import ExLlamaAltGenerator
    from exllama_tpu_torch.cache import ExLlamaCache
    from exllama_tpu_torch.parallel.relay import Relay, follow_calls
    from exllama_tpu_torch.serve.ws import WsProtocol

    relay = Relay(timeout=spec.get("relay_timeout", 300.0))
    out = {}
    t0 = time.perf_counter()
    new = spec.get("gen_new", spec["new"])
    if relay.leader:
        proto = WsProtocol(model, tok, ExLlamaCache(model), relay)
        try:
            out["frames"] = _ws_run(proto, new)
        finally:
            relay.stop()
        gen = proto.generator
    else:
        gen = ExLlamaAltGenerator(model, tok, ExLlamaCache(model))
        out["follow"] = follow_calls(gen, relay)
    out.update(seconds=time.perf_counter() - t0, messages=relay.messages,
               relay_s=relay.seconds, sequence=gen.sequence_ids.tolist())
    out["direct"] = _ws_run(WsProtocol(model, tok, ExLlamaCache(model)), new)
    return out


def _webui_text(body: str) -> str:
    return "".join(p.get("text", "") for p in map(json.loads, filter(
        str.strip, body.splitlines())) if p["cmd"] == "append")


def _front_webui(model, tok, spec) -> dict:
    """The web UI over the mesh: rank 0's server (a temporary sessions
    directory) with two streamed /api/userinput turns (the session's
    sampled settings, ``new`` response tokens), the other ranks
    ``follow``; then the same two turns through a fresh session on every
    rank, directly. The texts both ways; every rank's sequence after the
    mirrored run."""
    import tempfile

    from exllama_tpu_torch.cache import ExLlamaCache
    from exllama_tpu_torch.generator import ExLlamaGenerator
    from exllama_tpu_torch.parallel.relay import Relay, follow_calls
    from exllama_tpu_torch.webui import app as webui_app
    from exllama_tpu_torch.webui import session as webui_session

    turns = ("hi there", "and again")
    new = spec.get("gen_new", spec["new"])
    relay = Relay(timeout=spec.get("relay_timeout", 300.0))
    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as sdir:
        if relay.leader:
            httpd, _ = webui_app.make_server(model, tok, s_dir=sdir,
                                             relay=relay)
            webui_app.session.max_response_tokens = new
            try:
                answers = [http_call(httpd.server_address, "POST",
                                 "/api/userinput", {"user_input": t})
                           for t in turns]
            finally:
                httpd.shutdown()
                with webui_app.generate_lock:
                    relay.stop()
            out.update(status=[a[0] for a in answers],
                       texts=[_webui_text(a[1]) for a in answers])
            gen = webui_session.generator
        else:
            gen = ExLlamaGenerator(model, tok, ExLlamaCache(model))
            out["follow"] = follow_calls(gen, relay)
        out.update(seconds=time.perf_counter() - t0,
                   messages=relay.messages, relay_s=relay.seconds,
                   sequence=gen.sequence.tolist())
    with tempfile.TemporaryDirectory() as sdir:
        webui_session.prepare_sessions(model, tok, sdir)
        sess = webui_session.new_session()
        sess.max_response_tokens = new
        out["direct"] = ["".join(sess.respond_multi(t)) for t in turns]
    out["direct"] = [_webui_text(d) for d in out["direct"]]
    return out


def _beam_refusal(model, tok, spec) -> dict:
    """Beam search through a mirrored generator on a tp mesh: rank 0's
    call raises (as the JAX package refuses it), the followers note the
    same error and stop at rank 0's stop message."""
    from exllama_tpu_torch.cache import ExLlamaCache
    from exllama_tpu_torch.generator import ExLlamaGenerator
    from exllama_tpu_torch.parallel.relay import (
        Mirrored,
        Relay,
        follow_calls,
    )

    relay = Relay(timeout=spec.get("relay_timeout", 300.0))
    gen = ExLlamaGenerator(model, tok, ExLlamaCache(model))
    if not relay.leader:
        return follow_calls(gen, relay)
    gen = Mirrored(gen, relay)
    gen.settings.beams, gen.settings.beam_length = 2, 2
    try:
        gen.begin_beam_search()
        raised = None
    except NotImplementedError as e:
        raised = f"{type(e).__name__}: {e}"
    finally:
        relay.stop()
    return {"raised": raised}


def front_ends(spec: dict) -> dict:
    """The front ends over a mesh, SPMD (``spec``: a model as
    :func:`tp_forward`'s with ``vocab_size`` >= 260 for the byte-level
    encoding; ``slots``, ``clients``, ``new`` tokens a request,
    ``gen_new`` a generation of ws and the web UI (default ``new``),
    ``relay_timeout`` seconds): ``serve.api`` (:func:`_front_api`),
    ``serve.ws`` (:func:`_front_ws`), the web UI (:func:`_front_webui`) and
    the beam-search refusal under tp (:func:`_beam_refusal`), each on a
    relay of its own, rank 0 serving and the other ranks following; text
    through :func:`tag_tokenizer`."""
    device = torch.device(spec.get("device", "cuda"))
    model = build_model(spec, _mesh(spec), device)
    tok = tag_tokenizer()
    out = {"rank": dist.get_rank()}
    for name, fn in (("api", _front_api), ("ws", _front_ws),
                     ("webui", _front_webui), ("beams", _beam_refusal)):
        out[name] = fn(model, tok, spec)
        dist.barrier()
    return out


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
