"""Benchmark / validation harness of the port (port of the repo root's
benchmark.py, same flags):

    python -m exllama_tpu_torch.benchmark --synthetic 7b -p -ppl -v [--cpu]

  -p        perf: a prompt of (length - 128) tokens, warmed twice at the
            timed shape, then 128-token decodes at the best (1-token) and
            worst (full) context, each as the two-length fit
            (t128 - t32) / 96 beside the raw rate of one 128-token call
            (below -l 256 the decodes are length / 2 and a quarter of that
            tokens, the prompt length / 2);
            then the same fit for the greedy decode that the root's bench.py
            drives (forward_chunk(head_mode="argmax") with fuse_qkv and the
            K8 commit, each token fed back on the device); device memory in
            use and at its peak. Both decode paths run through
            ``generator.DecodeLoop``: on the card a captured CUDA graph a
            step (the warm-up calls capture them). Every timing is fenced by
            torch.cuda.synchronize() on the card.
  -ppl      perplexity on a jsonl / text dataset (-ds; the bundled
            datasets/wikitext2_val_sample.jsonl by default), --ppl_chunks
            chunks of at most -l tokens
  --ppl_turbo  perplexity of the W4A8 modes against the exact kernels on
            the same chunks: the a8t prefill over full chunks, a8 and a8x2
            token by token (a quarter of the chunks), printed as a
            certificate
  -v        validate: perplexity on the plain path (matmul_impl "xla") and
            on the kernels, held to |delta| < 0.01 + 0.01 * ppl (without a
            dataset: logits within 5% of their scale); then a greedy
            completion; -vv adds 4 identical batched rows that must decode
            alike
  -cs N     aggregate throughput of N streams through the continuous-
            batching engine (serve/engine.py, N slots): prompts of 32-127
            tokens drawn from seed 0, 64 new tokens each under the default
            sampler settings, one warm-up step, then tokens / seconds
  --scale_f32, --no_fold_act_order
            f32 scales; the act-order down projection's gather kept
            (TuningParams scale_dtype, fold_act_order)

Synthetic models (--synthetic, the root benchmark's SYNTH_SHAPES) draw their
weights from seed 0; every shape but "tiny" draws packed words and scales
directly on the device (``make_synthetic_params(fast=True)``: seconds at
7B instead of minutes of host-side quantization). A checkpoint on disk
(-d, e.g. one written by ``python -m exllama_tpu_torch.utils.fabricate``)
loads through ``model_init.build``. Runs on the card unless --cpu is given.
``main(argv)`` returns the numbers it printed, as a dict. ``--tp`` / ``--dp``
run it on a mesh, one process a rank under ``torchrun`` (only rank 0
prints):

    torchrun --nproc-per-node 2 -m exllama_tpu_torch.benchmark \
        --synthetic 7b --tp 2 -p
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from exllama_tpu_torch import model_init
from exllama_tpu_torch.cache import ExLlamaCache
from exllama_tpu_torch.config import ExLlamaConfig
from exllama_tpu_torch.generator import DecodeLoop, ExLlamaGenerator
from exllama_tpu_torch.perplexity import Perplexity

SYNTH_SHAPES = {
    "tiny": dict(hidden_size=256, intermediate_size=512,
                 num_attention_heads=4, num_key_value_heads=4, head_dim=64,
                 num_hidden_layers=2, vocab_size=32000),
    "3b": dict(hidden_size=3200, intermediate_size=8640,
               num_attention_heads=32, num_key_value_heads=32, head_dim=100,
               num_hidden_layers=26, vocab_size=32000),
    "7b": dict(hidden_size=4096, intermediate_size=11008,
               num_attention_heads=32, num_key_value_heads=32, head_dim=128,
               num_hidden_layers=32, vocab_size=32000),
    "13b": dict(hidden_size=5120, intermediate_size=13824,
                num_attention_heads=40, num_key_value_heads=40, head_dim=128,
                num_hidden_layers=40, vocab_size=32000),
}
DATASET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "datasets", "wikitext2_val_sample.jsonl")


def build_synthetic(name, args):
    """(config, model, tokenizer) of a synthetic model of shape ``name``."""
    from exllama_tpu_torch.formats.loader import make_synthetic_params
    from exllama_tpu_torch.models.llama import ExLlama
    from exllama_tpu_torch.tokenizer import FakeTokenizer

    device = model_init.device_of(args)
    cfg = ExLlamaConfig()
    for k, v in SYNTH_SHAPES[name].items():
        setattr(cfg, k, v)
    cfg.max_seq_len = args.length
    cfg.max_input_len = args.length
    cfg.max_attention_size = args.length ** 2
    cfg.tuning.matmul_impl = args.matmul_impl
    cfg.tuning.attn_len_bucket = args.attn_bucket
    if args.scale_f32:
        cfg.tuning.scale_dtype = "f32"
    cfg.tuning.fold_act_order = not args.no_fold_act_order
    cfg.tp_size, cfg.dp_size = args.tp, args.dp
    params = make_synthetic_params(
        cfg, groupsize=args.groupsize, act_order=args.act_order, seed=0,
        device=device, fast=name != "tiny",
        mesh=model_init.mesh_from_args(args),
    )
    model = ExLlama(cfg, params=params, device=device)
    tok = FakeTokenizer()
    tok.vocab_size = cfg.vocab_size
    return cfg, model, tok


def fence(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timer(fn, device):
    fence(device)
    t0 = time.perf_counter()
    r = fn()
    fence(device)
    return time.perf_counter() - t0, r


def mem_report(device):
    """(bytes in use, peak bytes since run_perf began) of the device's
    allocator (0 on the CPU)."""
    if device.type != "cuda":
        return 0, 0
    return (torch.cuda.memory_allocated(device),
            torch.cuda.max_memory_allocated(device))


def _dummy_tok(cfg):
    from exllama_tpu_torch.tokenizer import FakeTokenizer

    t = FakeTokenizer()
    t.vocab_size = cfg.vocab_size
    return t


def _fit(time_n, label, out, n_long: int = 128):
    """The two-length fit of a decode: (t_long - t_short) / (n_long -
    n_short) a token (n_short = n_long / 4: 128 and 32 tokens), the fastest
    of two runs each, beside the raw rate of one n_long-token call."""
    n_short = n_long // 4
    t_long = min(time_n(n_long) for _ in range(2))
    t_short = min(time_n(n_short) for _ in range(2))
    tps = ((n_long - n_short) / (t_long - t_short) if t_long > t_short
           else float("nan"))
    print(f" ** Speed: {tps:.2f} tokens/second ({label}) "
          f"[raw single-call {n_long / t_long:.2f}]", flush=True)
    out[label] = {"tps": tps, "raw_tps": n_long / t_long,
                  "t_long_s": t_long, "t_short_s": t_short,
                  "n_long": n_long, "n_short": n_short}


def greedy_loop(model, cache) -> DecodeLoop:
    """The greedy decode loop of the root bench.py:175-196, the counterpart
    of its loop under ``jax.jit``: forward_chunk(head_mode="argmax") with the
    whole layer in one K7 launch and every layer's K/V rows in one K8
    launch, at attend_len max_seq_len, each token fed back on the device --
    a ``DecodeLoop`` with no sampler, one captured graph replayed a step on
    the card (K7 x L, K5, K8)."""
    cfg = model.config
    hist = torch.zeros((cache.batch_size, cache.max_seq_len + 1),
                       dtype=torch.int32, device=model.device)
    return DecodeLoop(model, cache, hist, head_mode="argmax",
                      attend_len=cfg.max_seq_len, qkv_fuse=True,
                      commit_impl="pallas")


def greedy_decode(loop: DecodeLoop, tok, past: int, n: int):
    """n greedy tokens of ``loop`` (:func:`greedy_loop`) from token ``tok``
    [B, 1] at cache position ``past``; returns the tokens [B, n] on the
    device."""
    toks = loop.run(n, tok, past, past + 1)
    loop.cache.current_seq_len = past + n
    return toks


def run_perf(model, cache, args):
    cfg = model.config
    dev = model.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(0)
    n_long = min(128, args.length // 2)      # decode tokens of a timed call
    ids = rng.integers(0, cfg.vocab_size,
                       size=(1, args.length - n_long)).astype(np.int32)
    out = {}

    def prefill():
        cache.current_seq_len = 0
        model.forward(ids, cache, preprocess_only=True)

    print(f" -- warming prefill (T={ids.shape[1]})", flush=True)
    for _ in range(2):
        prefill()
    fence(dev)
    t, _ = timer(prefill, dev)
    out["prompt_tps"] = ids.shape[1] / t
    print(f" ** Speed: {out['prompt_tps']:.2f} prompt tokens/second",
          flush=True)

    gen = ExLlamaGenerator(model, _dummy_tok(cfg), cache)
    gen.settings.top_k = 1

    def gen_n(n):
        t, _ = timer(lambda: gen.gen_tokens(n), dev)
        gen.gen_rewind(n)
        return t

    for label, begin_len in (("best", 1), ("worst", ids.shape[1])):
        print(f" -- warming {label}-case decode", flush=True)
        gen.gen_begin(ids[:, :begin_len])
        for n in (n_long // 4, n_long):
            gen_n(n)
        _fit(gen_n, label, out, n_long)

    # the greedy path: the prompt, then tokens fed back on the device
    prefill()
    past = cache.current_seq_len
    tok = torch.as_tensor(ids[:, -1:]).to(dev)
    loop = greedy_loop(model, cache)

    def greedy_n(n):
        t, toks = timer(lambda: greedy_decode(loop, tok, past, n), dev)
        assert toks.shape == (1, n)
        return t

    print(" -- warming the greedy decode (fuse_qkv + K8 commit)", flush=True)
    for n in (n_long // 4, n_long):
        greedy_n(n)
    _fit(greedy_n, "greedy worst", out, n_long)

    used, peak = mem_report(dev)
    out["mem_in_use_bytes"], out["mem_peak_bytes"] = used, peak
    print(f" ** Device memory in use: {used / 1024**2:,.2f} MB, peak "
          f"{peak / 1024**2:,.2f} MB", flush=True)
    return out


def run_ppl(model, cache, tokenizer, args, impl=None, ppl_token=False,
            chunks=None):
    if impl is not None:
        model.config.tuning.matmul_impl = impl
    ppl = Perplexity(model, cache, tokenizer)
    ppl.load(args.dataset, chunk_truncate=args.length)
    value = ppl.test(chunk_limit=chunks or args.ppl_chunks,
                     ppl_token=ppl_token, silent=False)
    label = (impl or model.config.tuning.matmul_impl) + (
        ", token by token" if ppl_token else "")
    print(f" ** Perplexity ({label}): {value:.4f}", flush=True)
    return value


def _with_w8(model):
    """The model's params with turbo prefill's int8 images attached (every
    image off the card, where no memory budget is read)."""
    from exllama_tpu_torch.models.llama import _attach_prefill_w8

    cfg = model.config
    if model.device.type == "cuda":
        return _attach_prefill_w8(model.params, cfg)
    was = cfg.tuning.prefill_w8
    cfg.tuning.prefill_w8 = "on"
    try:
        return _attach_prefill_w8(model.params, cfg)
    finally:
        cfg.tuning.prefill_w8 = was


def run_ppl_turbo(model, cache, tokenizer, args):
    """Perplexity of the opt-in W4A8 modes against the exact kernels on the
    same checkpoint and chunks: "pallas_a8t" over full chunks (the prefill
    kernels the turbo prompt rides), "pallas_a8" and "pallas_a8x2" token by
    token (the decode kernels), each beside the exact path's own
    token-by-token value."""
    res = {"exact": run_ppl(model, cache, tokenizer, args, impl="pallas")}
    saved = model.params
    model.params = _with_w8(model)
    try:
        res["a8t"] = run_ppl(model, cache, tokenizer, args,
                             impl="pallas_a8t")
    finally:
        model.params = saved
    tk = max(1, args.ppl_chunks // 4)       # token by token is ~100x
    res["exact_token"] = run_ppl(model, cache, tokenizer, args,
                                 impl="pallas", ppl_token=True, chunks=tk)
    for impl in ("pallas_a8", "pallas_a8x2"):
        key = impl.replace("pallas_", "")
        res[key + "_token"] = run_ppl(model, cache, tokenizer, args,
                                      impl=impl, ppl_token=True, chunks=tk)
        print(f" ** Token ppl {impl}: {res[key + '_token']:.4f} (exact "
              f"{res['exact_token']:.4f}, delta "
              f"{res[key + '_token'] - res['exact_token']:+.4f})")
    model.config.tuning.matmul_impl = args.matmul_impl
    out = {
        "exact_ppl": res["exact"],
        "a8t_ppl": res["a8t"],
        "a8t_delta": res["a8t"] - res["exact"],
        "exact_token_ppl": res["exact_token"],
        "a8_token_delta": res["a8_token"] - res["exact_token"],
        "a8x2_token_delta": res["a8x2_token"] - res["exact_token"],
    }
    print(" ** turbo-ppl certificate: " + json.dumps(
        {k: round(v, 4) for k, v in out.items()}), flush=True)
    return out


def run_validate(model, cache, tokenizer, args, level):
    """The plain path against the kernels, then a greedy completion (and,
    at level 2, identical batched rows). Raises if a check fails."""
    out = {}
    impl = model.config.tuning.matmul_impl
    kernel_impl = "pallas" if impl == "xla" else impl
    if args.dataset:
        p_ref = run_ppl(model, cache, tokenizer, args, impl="xla")
        p_kernel = run_ppl(model, cache, tokenizer, args, impl=kernel_impl)
        delta = abs(p_ref - p_kernel)
        limit = 0.01 + 0.01 * p_ref
        print(f" ** Ppl delta xla<->{kernel_impl}: {delta:.5f} (limit "
              f"{limit:.5f})", flush=True)
        out.update(ppl_xla=p_ref, ppl_kernels=p_kernel, ppl_delta=delta,
                   ppl_limit=limit)
        if not delta < limit:
            raise AssertionError(f"kernel cross-check FAILED: |delta ppl| "
                                 f"{delta} >= {limit}")
    else:
        rng = np.random.default_rng(1)
        ids = rng.integers(0, model.config.vocab_size,
                           size=(1, 64)).astype(np.int32)
        logits = {}
        for name in ("xla", kernel_impl):
            cache.current_seq_len = 0
            model.config.tuning.matmul_impl = name
            logits[name] = model.forward(ids, cache).to(torch.float32)
        ref, got = logits["xla"], logits[kernel_impl]
        d = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
        print(f" ** Logit rel-delta xla<->{kernel_impl}: {d:.4f}", flush=True)
        out["logit_rel_delta"] = d
        if not d < 0.05:
            raise AssertionError(f"kernel cross-check FAILED: {d} >= 0.05")
    model.config.tuning.matmul_impl = impl

    gen = ExLlamaGenerator(model, tokenizer, cache)
    gen.settings.top_k = 1
    text = gen.generate_simple("To be or not to be, that is the",
                               max_new_tokens=24)
    print(f" ** Completion: {text!r}", flush=True)
    out["completion"] = text

    if level >= 2:
        bsz = 4
        cache_b = ExLlamaCache(model, batch_size=bsz)
        gen_b = ExLlamaGenerator(model, tokenizer, cache_b)
        gen_b.settings.top_k = 1
        texts = gen_b.generate_simple(["All your base"] * bsz,
                                      max_new_tokens=16)
        if not all(t == texts[0] for t in texts):
            raise AssertionError("batched rows diverged")
        print(f" ** Batched ({bsz} identical rows): consistent", flush=True)
        out["batched_rows"] = bsz
    print(" ** Validation passed", flush=True)
    return out


def add_model_args(parser: argparse.ArgumentParser):
    """``model_init``'s flags and the synthetic model's (``--synthetic``,
    ``--groupsize``, ``--act_order``, ``--no_fold_act_order``): what
    :func:`load` reads. The serving front ends and the examples take them
    too."""
    model_init.add_args(parser)
    parser.add_argument("--synthetic", type=str, choices=list(SYNTH_SHAPES),
                        help="use a synthetic model of this shape")
    parser.add_argument("--groupsize", type=int, default=128)
    parser.add_argument("--act_order", action="store_true")
    parser.add_argument("--no_fold_act_order", action="store_true",
                        help="keep the act-order down projection's gather "
                             "(fold_act_order=False)")


def run_streams(model, args) -> dict:
    """``-cs N``: N concurrent streams through the continuous-batching
    engine (the root benchmark's ``run_streams``): N slots, prompts of
    32-127 tokens from seed 0, 64 new tokens each, one warm-up step (it
    admits the first prompt and captures the first decode graph on the
    card), then the aggregate rate of the rest, fenced."""
    from exllama_tpu_torch.serve.engine import ContinuousBatchingEngine

    cfg = model.config
    n = args.streams
    eng = ContinuousBatchingEngine(model, tokenizer=_dummy_tok(cfg),
                                   max_slots=n, attn_bucket=256)
    rng = np.random.default_rng(0)
    new_tokens = 64
    for _ in range(n):
        plen = int(rng.integers(32, 128))
        prompt = rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int32)
        eng.submit(prompt, max_new_tokens=new_tokens, stop_tokens=(-1,))
    eng.step()
    device = model.device
    fence(device)
    t0 = time.perf_counter()
    produced = 0
    while eng.has_work():
        produced += len(eng.step())
    fence(device)
    dt = time.perf_counter() - t0
    print(f" ** Aggregate: {produced} tokens over {n} streams in {dt:.2f}s "
          f"= {produced / dt:.1f} tok/s")
    return dict(streams=n, tokens=produced, seconds=dt, tps=produced / dt)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="benchmark / validate the "
                                                 "PyTorch port")
    add_model_args(parser)
    parser.add_argument("-p", "--perf", action="store_true")
    parser.add_argument("-ppl", "--perplexity", action="store_true")
    parser.add_argument("-v", "--validate", action="count", default=0)
    parser.add_argument("-ds", "--dataset", type=str, default=None)
    parser.add_argument("--ppl_chunks", type=int, default=8)
    parser.add_argument("--ppl_turbo", action="store_true",
                        help="perplexity deltas of the opt-in W4A8 modes "
                             "(a8t prefill; a8 / a8x2 decode, token by "
                             "token) against the exact kernels")
    parser.add_argument("-cs", "--streams", type=int, default=0,
                        help="aggregate throughput over N streams through "
                             "the continuous-batching engine")
    args = parser.parse_args(argv)
    if args.dataset is None and (
            args.perplexity or args.validate or args.ppl_turbo):
        if os.path.exists(DATASET):
            args.dataset = DATASET
    return args


def load(args):
    """(model, tokenizer) that ``args`` name: synthetic, or from disk."""
    if args.synthetic:
        _, model, tokenizer = build_synthetic(args.synthetic, args)
        model_init.print_options(argparse.Namespace(
            **{**vars(args), "config": "synthetic",
               "model": args.synthetic}))
        return model, tokenizer
    _, model, tokenizer, _ = model_init.build(args)
    return model, tokenizer


def run(args, model, tokenizer) -> dict:
    """The modes ``args`` ask for, on ``model``; their numbers as a dict."""
    results = {}
    cache = ExLlamaCache(model)
    if args.perf:
        results["perf"] = run_perf(model, cache, args)
    if args.perplexity and args.dataset:
        results["ppl"] = run_ppl(model, cache, tokenizer, args)
    if args.ppl_turbo and args.dataset:
        results["ppl_turbo"] = run_ppl_turbo(model, cache, tokenizer, args)
    if args.validate:
        results["validate"] = run_validate(model, cache, tokenizer, args,
                                           args.validate)
    if args.streams:
        del cache
        results["streams"] = run_streams(model, args)
    return results


def main(argv=None) -> dict:
    """Parse, load, run. In a world of ranks (``torchrun --nproc-per-node N
    -m exllama_tpu_torch.benchmark --tp N``) every rank runs the same
    program on its shard and only rank 0 prints."""
    from exllama_tpu_torch.parallel.relay import quiet_follower

    args = parse_args(argv)
    with quiet_follower(args):
        model, tokenizer = load(args)
        return run(args, model, tokenizer)


if __name__ == "__main__":
    main()
