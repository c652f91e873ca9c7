#!/usr/bin/env python3
"""Smoke run of exllama_tpu_torch on one NVIDIA H100: build, check, measure.

    python3 chip_smoke.py

Phases, one line or block of output each; any failure exits non-zero:

  1. device: the card's name and its nvidia-smi name / power limit;
  2. build: every CUDA kernel under exllama_tpu_torch/csrc, compiled by nvcc
     in parallel (the build seconds are printed);
  3. each kernel against its plain PyTorch version on the card at the shapes
     of the Llama-7B main path, with its time beside the plain version, one
     PyTorch library call computing the same function (timed here only; the
     port never calls it) and the least time the card could take;
  4. a 2-layer model at full 7B width built from one seed on the card and on
     the CPU: teacher-forced prefill + decode logits compared;
  5. the main path at full width: a 32-layer Llama-7B-shape model (random
     weights from a seed) answering three generate_simple requests, with
     prompt and decode tokens/s, peak memory, and every kernel's launch
     count, which must have risen in this phase.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Needs exactly one visible CUDA device.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
SEED = 0
# kernel vs plain, max |difference| over max |plain| (reasons in kernel_cases)
TOL = {"q4_gemv": 1e-2, "q4_dequant_matmul": 1e-2, "flash_attn": 2e-2,
       "dense_gemv": 1e-4}


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing

class Timer:
    """Median over fenced runs, each preceded by an L2 flush (the decode path
    streams its weights cold: 3.5 GB per token against a 50 MB L2)."""

    def __init__(self, device):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters=15, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------ phase 3 cases

def random_qt(gen, k, n, gs, act_order, device):
    from exllama_tpu_torch.formats.gptq import QuantTensor

    words = torch.randint(-(2 ** 31), 2 ** 31 - 1, (k // 8, n), generator=gen,
                          device=device, dtype=torch.int64).to(torch.int32)
    sigma = 0.02 / math.sqrt(k / 4096)
    s = torch.full((k // gs, n), sigma / 4.6, device=device)
    s *= 1.0 + 0.05 * torch.randn(s.shape, generator=gen, device=device)
    z = s * torch.randint(6, 11, s.shape, generator=gen, device=device)
    xm = (torch.randperm(k, generator=gen, device=device).to(torch.int32)
          if act_order else None)
    return QuantTensor(words, s.bfloat16(), z.bfloat16(), xm, gs)


def check_close(name, got, ref, rel_tol):
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if err > rel_tol * scale:
        raise AssertionError(
            f"{name}: max|kernel-plain| {err:.3g} > {rel_tol} * {scale:.3g}")
    return err, err / scale if scale else 0.0


def kernel_cases(device, timer):
    """Hold each kernel against its plain version at main-path shapes and
    time kernel / plain / library. Returns {kernel: [case results]}."""
    from exllama_tpu_torch.formats.gptq import dequantize_t
    from exllama_tpu_torch.ops import attention, dense, quant

    gen = torch.Generator(device=device).manual_seed(SEED)
    res = {"q4_gemv": [], "q4_dequant_matmul": [], "flash_attn": [],
           "dense_gemv": []}

    def record(kernel, label, err, rel, k_fn, p_fn, l_fn, nbytes, flops,
               iters=15):
        kms = timer(k_fn, iters)
        pms = timer(p_fn, max(3, iters // 3))
        lms = None if l_fn is None else timer(l_fn, iters)
        b, by = bound_ms(nbytes, flops)
        r = dict(case=label, max_abs_err=err, rel_err=rel, ms=kms,
                 plain_ms=pms, library_ms=lms, bound_ms=b, bound_by=by)
        res[kernel].append(r)
        log(f"  {kernel:18s} {label:34s} err {err:.3g} (rel {rel:.2g} <= "
            f"{TOL[kernel]:g})  "
            f"kernel_ms {kms:.4f}  plain_ms {pms:.4f}  library_ms "
            f"{'n/a' if lms is None else f'{lms:.4f}'}  bound_ms {b:.4f} "
            f"({by})", )

    # Llama-7B projections: (name, K, N)
    shapes = [("qkv", 4096, 12288), ("o", 4096, 4096),
              ("gateup", 4096, 22016), ("down", 11008, 4096)]
    qcases = [(nm, k, n, 128, False) for nm, k, n in shapes]
    qcases += [("gateup-g32", 4096, 22016, 32, False),
               ("down-actorder", 11008, 4096, 128, True)]

    # K1: rel tol 1e-2 -- the kernel scales f32 group sums of exact nibbles,
    # the plain version rounds every dequantized weight to bf16 (2^-9
    # relative) first; both round the output to bf16 (2^-8)
    for nm, k, n, gs, act in qcases:
        qt = random_qt(gen, k, n, gs, act, device)
        w = dequantize_t(qt)
        nw = None
        if nm == "qkv":
            nw = (torch.rand(k, generator=gen, device=device) + 0.5).bfloat16()
        for m in ((1, 2) if gs == 128 and not act else (1,)):
            x = torch.randn((m, k), generator=gen, device=device).bfloat16()
            got = quant.q4_gemv(x, qt, nw, 1e-6)
            ref = quant.q4_gemv_plain(x, qt, nw, 1e-6)
            err, rel = check_close(f"q4_gemv {nm} M={m}", got, ref,
                                   TOL["q4_gemv"])
            nbytes = (k * n // 2 + 2 * (k // gs) * n * 2 + m * k * 2
                      + m * n * 2 + (k * 2 if nw is not None else 0)
                      + (k * 4 if act else 0))
            record("q4_gemv", f"{nm} g{gs} M={m}" + (" norm" if nw is not None
                                                     else ""),
                   err, rel, lambda: quant.q4_gemv(x, qt, nw, 1e-6),
                   lambda: quant.q4_gemv_plain(x, qt, nw, 1e-6),
                   lambda: torch.matmul(x, w), nbytes, 2 * m * k * n)
        del w

    # K2: rel tol 1e-2 -- same bf16 weights on both sides; f32 sums in
    # another order and the bf16 output rounding (2^-8)
    for nm, k, n, gs, act in qcases:
        qt = random_qt(gen, k, n, gs, act, device)
        w = dequantize_t(qt)
        for m in ((127, 1919) if gs == 128 and not act else (127,)):
            x = torch.randn((m, k), generator=gen, device=device).bfloat16()
            if act:       # the caller gathers act-order x (ops/quant.py)
                x = x.index_select(1, qt.x_map.long())
            got = quant.q4_dequant_matmul(x, qt)
            ref = quant._q4_matmul_plain(x, qt)
            err, rel = check_close(f"q4_dequant_matmul {nm} M={m}", got, ref,
                                   TOL["q4_dequant_matmul"])
            nbytes = k * n // 2 + 2 * (k // gs) * n * 2 + m * k * 2 + m * n * 2
            record("q4_dequant_matmul", f"{nm} g{gs} M={m}", err, rel,
                   lambda: quant.q4_dequant_matmul(x, qt),
                   lambda: quant._q4_matmul_plain(x, qt),
                   lambda: torch.matmul(x, w), nbytes, 2 * m * k * n)
        del w

    # K3: rel tol 2e-2 -- the kernel rounds p to bf16 inside the online
    # softmax (against a running max), the plain version once against the
    # final max; one bf16 rounding of p is 2^-8 relative
    acases = [
        # label, B, T, Hkv, past, attend_len, deferred, masked
        ("decode past=0", 1, 1, 32, 0, 256, True, False),
        ("decode past=100", 1, 1, 32, 100, 256, True, False),
        ("decode past=2000", 1, 1, 32, 2000, 2048, True, False),
        ("decode B=2 past=2000 gqa8", 2, 1, 8, 2000, 2048, True, False),
        ("prefill T=1919 past=0", 1, 1919, 32, 0, 2048, False, False),
        ("prefill B=2 T=64 past=[1000,1100]", 2, 64, 32, [1000, 1100], 1280,
         False, False),
        ("prefill B=2 T=64 left-pad mask", 2, 64, 32, 0, 256, False, True),
    ]
    h, d, s_max = 32, 128, 2048
    for label, b, t, hkv, past, alen, deferred, masked in acases:
        q = torch.randn((b, t, h, d), generator=gen, device=device).bfloat16()
        kc = torch.randn((b, hkv, s_max, d), generator=gen,
                         device=device).bfloat16()
        vc = torch.randn((b, hkv, s_max, d), generator=gen,
                         device=device).bfloat16()
        past_t = (past if isinstance(past, int)
                  else torch.tensor(past, dtype=torch.int32, device=device))
        pasts = [past] * b if isinstance(past, int) else past
        new_kv = None
        if deferred:
            new_kv = tuple(torch.randn((b, 1, hkv, d), generator=gen,
                                       device=device).bfloat16()
                           for _ in range(2))
        mask = None
        if masked:
            mask = torch.ones((b, s_max), dtype=torch.bool, device=device)
            mask[0, :17] = False          # row 0 left-padded by 17 tokens
        got = attention.attend(q, kc, vc, past_t, alen, mask, new_kv)
        ref = attention.attend_plain(q, kc, vc, past_t, alen, mask, new_kv)
        err, rel = check_close(f"flash_attn {label}", got, ref,
                               TOL["flash_attn"])

        # work this data needs: visible keys per query row, K/V rows read
        vis, kv_rows = 0, 0
        for bi in range(b):
            lim = [min(alen, pasts[bi] + ti + (0 if deferred else 1))
                   for ti in range(t)]
            hidden = 17 if (masked and bi == 0) else 0
            vis += sum(max(0, li - hidden) + (1 if deferred else 0)
                       for li in lim)
            kv_rows += max(lim)
        flops = 4 * d * h * vis
        nbytes = (2 * q.numel() * 2 + 2 * kv_rows * hkv * d * 2
                  + (2 * b * hkv * d * 2 if deferred else 0)
                  + (b * alen if masked else 0))

        # library yardstick: SDPA over the cache slice with the same
        # causal / padding mask (the in-flight row of a deferred step is
        # not folded in)
        pos = torch.arange(alen, device=device)
        tpos = (torch.tensor(pasts, device=device)[:, None]
                + torch.arange(t, device=device)[None, :])
        allow = (pos[None, None, :] < tpos[:, :, None] + (0 if deferred
                                                         else 1))
        if mask is not None:
            allow = allow & mask[:, None, :alen]
        allow = allow[:, None]                      # [B, 1, T, S]
        qh = q.transpose(1, 2)
        ks, vs = kc[:, :, :alen], vc[:, :, :alen]

        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, ks, vs, attn_mask=allow, enable_gqa=hkv != h)

        record("flash_attn", label, err, rel,
               lambda: attention.attend(q, kc, vc, past_t, alen, mask,
                                        new_kv),
               lambda: attention.attend_plain(q, kc, vc, past_t, alen, mask,
                                              new_kv),
               lib, nbytes, flops, iters=10)

    # K4: rel tol 1e-4 -- f32 output of the same bf16 inputs; only the
    # order of the f32 sums differs
    w = (torch.randn((4096, 32000), generator=gen, device=device)
         * 0.02).bfloat16()
    for m in (1, 2):
        x = torch.randn((m, 4096), generator=gen, device=device).bfloat16()
        got = dense.dense_gemv(x, w)
        ref = dense.dense_gemv_plain(x, w)
        err, rel = check_close(f"dense_gemv M={m}", got, ref,
                               TOL["dense_gemv"])
        record("dense_gemv", f"lm_head 4096->32000 M={m}", err, rel,
               lambda: dense.dense_gemv(x, w),
               lambda: dense.dense_gemv_plain(x, w),
               lambda: torch.matmul(x, w), 4096 * 32000 * 2 + m * 4096 * 2
               + m * 32000 * 4, 2 * m * 4096 * 32000)
    return res


# --------------------------------------------------------------- phase 4

def model_vs_cpu(device):
    """2 layers at full 7B width, one seed, on the card and on the CPU."""
    import exllama_tpu_torch as port

    cfg = port.ExLlamaConfig()
    cfg.num_hidden_layers = 2
    cfg.max_seq_len = 128
    cpu_params = port.make_synthetic_params(cfg, 128, False, seed=1,
                                            device="cpu", fast=True)
    cpu_model = port.ExLlama(cfg, params=cpu_params, device="cpu")
    gpu_model = port.ExLlama(cfg, params=cpu_params.to(device), device=device)
    c_cpu, c_gpu = port.ExLlamaCache(cpu_model), port.ExLlamaCache(gpu_model)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, size=(1, 64)).astype(np.int32)
    steps = [(ids, False)] + [
        (rng.integers(0, cfg.vocab_size, size=(1, 1)).astype(np.int32), True)
        for _ in range(8)]
    worst = 0.0
    # 3% of the logit scale: the kernels round at other places than the
    # CPU plain path (see tests/test_torch_model.py for the JAX package's
    # own 2.1% spread between its two paths)
    for i, (tok, _) in enumerate(steps):
        ref = cpu_model.forward(tok, c_cpu, last_id_only=i > 0)
        got = gpu_model.forward(tok, c_gpu, last_id_only=i > 0).cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        if not torch.isfinite(got).all() or rel > 0.03:
            raise AssertionError(f"step {i}: card vs CPU logits rel {rel:.4f}")
        worst = max(worst, rel)
    return worst


# --------------------------------------------------------------- phase 5

def main_path(device):
    import exllama_tpu_torch as port
    from exllama_tpu_torch.ops import attention, dense, quant

    counters = {"q4_gemv": quant.q4_gemv,
                "q4_dequant_matmul": quant.q4_dequant_matmul,
                "flash_attn": attention.attend,
                "dense_gemv": dense.dense_gemv}

    def counts():
        return {k: f.launches for k, f in counters.items()}

    cfg = port.ExLlamaConfig()        # Llama-7B shapes (benchmark.py:43-45)
    cfg.max_seq_len = 2048
    t0 = time.time()
    params = port.make_synthetic_params(cfg, 128, False, seed=SEED,
                                        device=device, fast=True)
    model = port.ExLlama(cfg, params=params, device=device)
    cache = port.ExLlamaCache(model)
    tok = port.FakeTokenizer()
    gen = port.ExLlamaGenerator(model, tok, cache, seed=SEED)
    gen.disallow_tokens([tok.eos_token_id])   # fixed lengths for the rates
    torch.cuda.synchronize()
    log(f"  model: {cfg.num_hidden_layers} layers, "
        f"{model.num_params_bytes() / 2**30:.2f} GiB params, built in "
        f"{time.time() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
    prompt = bytes(rng.choice(letters, 1919)).decode()

    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # request 1: benchmark.py -p shape, 1919-token prompt + 128 new tokens
    t0 = time.time()
    text = gen.generate_simple(prompt, max_new_tokens=128)
    torch.cuda.synchronize()
    t_req = time.time() - t0
    assert isinstance(text, str) and gen.sequence.shape == (1, 1919 + 128)
    log(f"  request 1: 1919-token prompt + 128 tokens in {t_req:.2f} s")

    # the same request split into its prefill and decode halves, timed
    ids = tok.encode(prompt)
    c0 = counts()
    torch.cuda.synchronize()
    t0 = time.time()
    gen.gen_begin(ids)
    torch.cuda.synchronize()
    t_prefill = time.time() - t0
    c1 = counts()
    t0 = time.time()
    gen.gen_tokens(128)
    torch.cuda.synchronize()
    t_decode = time.time() - t0
    c2 = counts()
    prefill_launches = {k: c1[k] - c0[k] for k in c0}
    decode_launches = {k: (c2[k] - c1[k]) / 128 for k in c0}
    prompt_tps = (ids.shape[1] - 1) / t_prefill
    decode_tps = 128 / t_decode
    log(f"  prompt: {ids.shape[1] - 1} tokens in {t_prefill:.3f} s = "
        f"{prompt_tps:.1f} tok/s; decode: 128 tokens in {t_decode:.3f} s = "
        f"{decode_tps:.2f} tok/s")
    logits = model.forward(gen.sequence[:, -1:], cache)
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()

    # request 2: a short prompt resets the cache; a longer one reuses it
    text2 = gen.generate_simple("The quick brown fox", max_new_tokens=16)
    assert isinstance(text2, str) and cache.current_seq_len == 19 + 16 - 1
    longer = np.concatenate(
        [gen.sequence, tok.encode(" jumps over the lazy dog")], axis=1)
    reused = gen.gen_begin_reuse(longer)
    assert reused == gen.sequence.shape[1] - 24 > 19, reused
    gen.gen_tokens(4)
    log(f"  request 2: short prompt, then {reused} tokens of cache reused")

    # request 3: a B=2 batch of different lengths (left-pad input_mask)
    cache2 = port.ExLlamaCache(model, batch_size=2)
    gen2 = port.ExLlamaGenerator(model, tok, cache2, seed=SEED)
    gen2.disallow_tokens([tok.eos_token_id])
    texts = gen2.generate_simple(
        ["Once upon a time", "In a land far away, long before the port"],
        max_new_tokens=32)
    assert isinstance(texts, list) and len(texts) == 2
    assert gen2._mask is not None and gen2.sequence.shape[1] == 40 + 32
    log("  request 3: B=2 batch with a left-pad mask, 32 tokens each")

    final = counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in this phase: {final}")
    log(f"  launches per decode step: {decode_launches}")
    log(f"  launches per {ids.shape[1] - 1}-token prefill: {prefill_launches}")
    log(f"  max_memory_allocated {peak / 2**30:.2f} GiB")
    missing = [k for k, v in final.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return dict(launches=final, per_decode_step=decode_launches,
                per_prefill=prefill_launches, prompt_tps=prompt_tps,
                decode_tps=decode_tps, peak_bytes=peak)


# ------------------------------------------------------------------- main

SOURCES = {
    "q4_gemv": ("exllama_tpu_torch/csrc/q4_gemv.cu",
                "exllama_tpu/ops/quant.py:177", "qkv g128 M=1 norm"),
    "q4_dequant_matmul": ("exllama_tpu_torch/csrc/q4_matmul.cu",
                          "exllama_tpu/ops/quant.py:628", "gateup g128 M=1919"),
    "flash_attn": ("exllama_tpu_torch/csrc/flash_attn.cu",
                   "exllama_tpu/ops/attention.py:501", "decode past=2000"),
    "dense_gemv": ("exllama_tpu_torch/csrc/dense_gemv.cu",
                   "exllama_tpu/ops/dense.py:25", "lm_head 4096->32000 M=1"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from exllama_tpu_torch import kernels

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device)")
    log(smi)

    secs = kernels.build()
    log(f"[2 build] {len(kernels._SIGNATURES)} kernels built and loaded in "
        f"{secs:.1f} s")

    log("[3 kernels] kernel vs plain on the card, medians of L2-cold runs")
    t0 = time.time()
    res = kernel_cases(device, Timer(device))
    log(f"[3 kernels] all agree ({time.time() - t0:.1f} s)")

    t0 = time.time()
    worst = model_vs_cpu(device)
    log(f"[4 model] 2 layers at 7B width, 64-token prefill + 8 decode steps: "
        f"card vs CPU logits within {worst:.4f} of the logit scale "
        f"(limit 0.03; {time.time() - t0:.1f} s)")

    log("[5 main path] Llama-7B shapes, 32 layers, g128, bf16 KV, "
        "max_seq_len 2048")
    t0 = time.time()
    mp = main_path(device)
    log(f"[5 main path] done ({time.time() - t0:.1f} s)")

    summary = []
    for kname, (src, replaces, rep_case) in SOURCES.items():
        r = next(c for c in res[kname] if c["case"].startswith(rep_case))
        log(f"  {kname} ({r['case']}): kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} launches_per_decode_step "
            f"{mp['per_decode_step'][kname]:g} launches_per_prefill "
            f"{mp['per_prefill'][kname]}")
        summary.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=mp["launches"][kname],
            max_abs_err=max(c["max_abs_err"] for c in res[kname]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            case=r["case"],
        ))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
