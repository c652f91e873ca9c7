#!/usr/bin/env python3
"""Smoke run of exllama_tpu_torch on one NVIDIA H100: build, check, measure.

    python3 chip_smoke.py

Phases, one line or block of output each; any failure exits non-zero:

  1. device: the card's name and its nvidia-smi name / power limit;
  2. build: every CUDA kernel under exllama_tpu_torch/csrc, compiled by nvcc
     in parallel (the build seconds are printed);
  3. each kernel against its plain PyTorch version on the card at the shapes
     of the Llama-7B main path (K2 also at the edges of its tile, K3's
     split-KV decode at the edges of its 64-key splits and at B = 4 with
     distinct cursors), with its time beside the plain version, one
     PyTorch library call computing the same function where there is one
     (timed here only; the port never calls it), the least time the card
     could take and, for the fused kernels K6/K7, the port's own chain of
     separate kernels for the same work; K7's attention is also held at
     its own scale, with no residual and planted keys, after the faults of
     its last-block merge of the key splits (a split dropped or counted
     twice) have moved the plain output by more than 3x its limit
     (k7_attention_cases), and at B = 1, 2, 8 in each GEMV mode over each
     cache format with two calls bit-equal (k7_sweep_cases);
     the W4A8 kernels K9-K11 are held to 5e-3 against their plain versions'
     unrounded values after the plain versions have shown that a dropped
     residual pass, zero-point term or nibble moves the output by more than
     3x that, and K10 (on o and gate|up also at 33 and 127 rows) is timed
     beside exact K2 on the same inputs and beside torch._int_mm on its own
     int8 operands; K11 on its K-major image at 33, 127 and 1919 rows (and
     at N = 4168 and 4100, off the 128-column tile and off a multiple of 8)
     beside K10 on the same inputs and torch._int_mm, after the image read
     as [K, N] and each column read as its neighbour's have moved the plain
     output by more than 3x its limit (w8_cases); K4 at M = 1, 2, 8, 32,
     40, 64, 1919 (beside its parent, the stream-K loop, at <= 32 rows) and
     K5 at M = 1, 2, 8, 32 on the 4096 x 32000 lm_head and at V = 32001
     (an odd vocab), two calls on the same inputs bit-equal; K12 at 33,
     127 and 1919 rows beside K2 alone and K2 +
     the plain silu*up, after up negated and a dropped silu have each moved
     the plain output by more than 3x its 1e-2 (turbo_cases); K3, K7 and K8
     over an int8 and an int4 KV
     cache at the same shapes (2e-2 / 5e-2 as over bf16, K8 bit-equal),
     after an independent f32 reference has shown that per-key K or V
     scales replaced by their mean, the V scale also applied to the
     softmax denominator, and swapped int4 halves each move the output by
     more than 3x the limit (kv_cases); K1 (its Hopper kernel, beside its
     parent, the mma.sync route, and K2) and K9 (a8, a8x2: the tensor-core
     route) at M = 2, 8, 16, 18, 32 on the four projections, K1 two calls
     bit-equal, at the edges of its row tiles, g32, act-order, N = 130 /
     100 / 32001, the tp shards and f32 scales (k1_cases), with the
     K1-vs-K2 crossover at M = 2..64 (gemv_tc_cases); K1, K9, K2,
     K10 and K12 at groupsize 256 and groupsize = K (groupsize_cases); K3
     at head_dim 256, decode and prefill, over bf16 / int8 / int4 caches,
     and head_dim 100 on the einsum route's own counter (head_dim_cases);
     the f32-scale builds of K1, K2, K6, K7, K9, K10 and K12 at the bf16
     limits, timed beside their bf16 builds, and K1 / K2 on a 4-bit lm_head
     at V = 32000 and 32001, M = 1 and 2047 (f32_scale_cases);
  4. a 2-layer model at full 7B width built from one seed on the card and on
     the CPU: teacher-forced prefill + decode logits compared, in the default
     configuration and with fuse_qkv + commit_impl="pallas", and the greedy
     head's tokens held against the CPU logits; then the same comparison
     under matmul_impl="pallas_a8x2" and "pallas_a8t", and under an int8
     and an int4 KV cache in both configurations (the CPU's plain forward
     runs once for every configuration that computes the same function:
     the two fuse configurations, and a8x2 beside the exact mode); then 2-layer full-width
     models at groupsize 256, at head_dim 256 and at head_dim 100
     (OpenLlama-3B, attn_impl "auto": the einsum route) against the CPU;
     then with f32 scales, with a 4-bit lm_head at V = 32001 and with
     act-order layers left unfolded (fold_act_order=False);
  5. the main path at full width, in the default configuration (the JAX
     package's: fuse_mlp, fuse_attn, commit_impl="auto"): a 32-layer
     Llama-7B-shape model (random weights from a seed) answering three
     generate_simple requests, with prompt and decode tokens/s, peak memory
     and every kernel's launch count, request 2's 18-token prefill and a
     B=2 decode step of request 3 timed;
  6. greedy decode as bench.py drives it: 128 tokens through
     forward_chunk(head_mode="argmax") after the 1919-token prompt, once with
     commit_impl="auto" and once with fuse_qkv + commit_impl="pallas";
  7. the separate-kernel configuration of the first slice (fusions off) on
     request 1, so fused and separate decode tokens/s come from one run;
  8. the opt-in matmul modes on the same 32-layer model: request 1 under
     matmul_impl="pallas_a8t" with the resident int8 image (K11, K10 for the
     o-projection, K9 at decode), under "pallas_a8x2", under "pallas_a8t"
     with prefill_w8="off" (K10 everywhere) and in the exact mode with
     EXL_GLU_FUSE=1 (K12), phase 6's fuse_qkv + K8 greedy decode under
     "pallas_a8" and "pallas_a8x2", the 18-token request 2 under
     "pallas_a8" (K6 in K9's arithmetic), and the generator's decode under
     exact / a8 / a8x2 in turns, with tokens/s beside phase 5's;
  9. the quantized KV caches on the same 32-layer model, each under the
     config that exllama_tpu_torch.model_init.make_config returns for its
     flags (a config.json written to a temporary directory): request 1
     under --kv_int8, --kv_int4, --turbo and --turbo --turbo_prefill, then
     phase 6's fuse_qkv + K8 greedy decode under int8, int4 and --turbo,
     with prompt and decode tokens/s, peak memory and the cache's bytes;
 10. the port's benchmark (python -m exllama_tpu_torch.benchmark) on the
     32-layer 7B-shape model: -p (prompt tok/s, best / worst decode tok/s
     fitted and raw, the greedy fuse_qkv + K8 line, memory); -ppl under
     --matmul_impl xla (the plain path: none of K1, K2, K4-K7, K9-K12
     launches); -ppl -vv (plain vs kernels within 0.01 + 0.01 ppl, the
     completion, 4 identical batched rows); --scale_f32 -ppl -v with
     EXL_GLU_FUSE=1 (the f32-scale builds only); --ppl_turbo -l 256 with
     bf16 and f32 scales (the certificate); and a checkpoint written by the
     port's fabricate (7B width, act-order g128, 4 layers) through -d -v
     with the act-order fold on and off (K1 on the unfolded down
     projection, no K6 / K7).
 11. the compiled decode step on the same 32-layer model:
     ``generator.gen_tokens`` and the benchmark's greedy loop
     (``benchmark.greedy_loop``) through captured CUDA graphs, one per
     attend-length bucket, each held bit for bit (tokens and caches)
     against the same step run eagerly from the same state: B = 1 top-k 1
     from 249 tokens across the 256 bucket, B = 1 sampled (top-k 40, top-p
     0.65, penalty 1.15: the captured Philox stream is the eager one), B = 2
     with a left-padded row and its mask, and the greedy loop against
     forward_chunk(head_mode="argmax") at int cursors; the launch counters
     after n replays n x the captured step's (K1 32, K7 32, K4 1 sampled;
     K7 32, K5 1, K8 1 greedy); one replay of each traced by torch.profiler
     (the kernels by name, the device's idle share beside phase 6's eager
     step); graph and eager tok/s in turns. Phase 4 also holds the
     generator's features on its 2-layer model against the CPU: beam
     search at top-k 1 (= the card's greedy) and with 3 beams alive (K1 /
     K7 at B = 3, K4 at M = 3), CFG (K7 at B = 2) and constraints.
 12. LoRA adapters and the other generators: two adapters written in the
     PEFT layout from a seed (Q: r 8 on q and v, PEFT's default targets;
     A: r 16 on all seven projections). On 2-layer full-width models on
     zero-mean weights each first moves the card's logits by more than 3x
     the 0.03 limit, then holds the card against the CPU within it, with
     K1 / K7 (Q) or K1 / K3 (A) a decode step; act-order g128 with the
     fold under A, where an adapter loaded without the fold's permutation
     moves the logits by more than 3x the limit. On a zero-mean 32-layer
     model: gen_tokens through the graphs bit-equal to the eager steps
     under Q (K1 32, K7 32, K4 1 a step), then under A after a switch
     without gen_begin (every graph captured anew; K1 128, K3 32, K4 1, no
     K6 / K7), a prefill under A (K2 128, K3 32), generate_simple under
     each through the graphs = eager, decode tok/s with none / Q / A in
     turns and one replay of each traced (device launches, idle share);
     ExLlamaAltGenerator under Q with a stop string and a stop token (no
     leak, stream() = generate); SpeculativeGenerator with the n-gram
     proposer on a repeating 1,024-token prompt, 128 tokens each
     within 0.03 of the one-token path's best, K1 64, K3 32, K6 32, K4 1
     per verify forward, beside the generator's graphed and eager tok/s;
     then a 4-layer draft model (another seed), 32 tokens, its acceptance.
 13. serving on phase 12's 32-layer model (zero-mean weights, adapter Q):
     the continuous-batching engine at 8 slots (64-token admission chunks,
     256-key buckets; an 8 GiB bf16 cache) takes twelve requests with
     prompts of 32-512 tokens from a seed, 64 new tokens each: six greedy,
     six sampled (temperature 0.8, top-k 40, top-p 0.65, penalty 1.15),
     three under adapter Q, two with a stop string, one admitted
     mid-flight. Each greedy request is first run alone in the engine (its
     stop string is cut from that text); batched, its tokens are bit-equal
     to alone (up to the stop string, which never reaches the text); the
     scenario through the captured graphs is bit-equal to the same engine
     run eagerly (every token, the caches, the histories); every slot is
     free at the end; each batched step launches K1 32, K7 32, K4 1 and
     each admission chunk K2 128, K3 32; the greedy tokens lie within
     max(0.03, 1.5x the spread of two one-token routes) of the
     single-sequence generator's best, teacher-forced. The six greedy
     requests again through the engine's speculative step (NgramProposer,
     lookahead 4, eager: T = 5 rows at eight cursors, K2 128 and K3 32 a
     verify step, K4 1 on its 40-row lm_head), each equal to the plain
     engine's tokens or within the
     same teacher-forced limit. Then the greedy-all 8-slot step: the
     engine's whole step() (packed read and retire loop included), and its
     device step alone replayed and eager (ms, tok/s), one replay traced;
     the HTTP API (eight concurrent clients, four JSON and four SSE
     streams, /health), the websocket protocol (driven in process: echo,
     getConfig, estimateToken, oneShotInfer, streamInfer) and the web UI
     (/, /api/populate, a streamed /api/userinput) on the card; and
     ``benchmark --synthetic 7b -cs 8`` through phase 10's runner.

 14. parallelism (tensor, sequence, data) as ranks on the one card: gloo
     worlds of 2 and 4 processes (``parallel.launch.run_world``; NCCL
     refuses two ranks on one device), after a world that records which
     collectives gloo runs on CUDA tensors. tp = 2 on the 32-layer 7B
     (centred weights, a 512-token prompt, 32 teacher-forced steps and one
     greedy-head step) and sp = 2 (4 steps at a 2,048-token context; the
     ring prefill where gloo carries CUDA point-to-point) in the world of
     two; tp = 4 at 8 layers (down's 2,752 rows a rank padded to 2,816) and
     the continuous-batching engine at dp = 2 x tp = 2 (8 slots, four
     greedy requests, 32 tokens each) in the world of four. Each held
     against the unsharded port on the card within phase 13's rule
     (max(0.03, 1.5x the spread of the default and separate one-token
     routes)), every rank the same bits, and each route's per-rank
     launches (tp: K1 4 a layer, K3 1, K4 or K5 1 a step; K2 4 a layer and
     K3 1 a prefill; no K6 / K7; sp: K1 4 a layer); then K1 and K3 at the
     shard shapes against their plain versions, timed beside their bounds.

 15. the compiled steps: every route that the JAX package runs through a
     compiled executable replays a CUDA graph (``ExLlama.forward``'s
     chunks of up to 64 rows, ``gen_single_token`` through the decode
     loop, the engine's speculative step), each run graphed and eagerly
     (``model.capture = False``) from the same state and held bit for bit
     in tokens and state (caches, histories) and in launches: on phase
     12's 32-layer model gen_single_token greedy under adapter Q and
     sampled, each over a second gen_begin turn of the same shapes with a
     new temperature and top-p that must capture no graph; a streamed web
     UI reply, a websocket streamInfer and the chatbot example's loop;
     the speculative generator (n-gram, top-k 1); five web UI replies in
     turns to user inputs of growing length, each reply's time and the
     graphs it captured (a new row or attend bucket only); the engine's six greedy
     requests of phase 13 through 64-token admission chunks and its
     speculative step (every chunk K2 128, K3 32; every verify step K2
     128, K3 32, K4 1); on phase 4's 2-layer model CFG and beam search with 3
     beams alive; each route's graphed and eager rate in turns, one
     replayed verify step of the engine timed and traced (its device time
     by kernel), and the allocator's reserved bytes before and after.

Each phase prints its seconds. Each of phases 5-13 and 15 sets every launch
counter to 0 just before it drives its path (phase 10: each benchmark run)
and reads them just after; phase 14's ranks are fresh processes (every
counter at 0) that read their counters around each step, prefill and
admission chunk; a kernel its path must run that shows no launch fails the
run. The line before the last is a JSON summary of the kernels; the last
line is ``{"ok": true, "device": {...}}``. Needs exactly one visible CUDA
device.
"""

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
INT8_OP_PER_S = 1979e12        # dense int8 tensor-core peak
SEED = 0
# kernel vs plain, max |difference| over max |plain| (reasons in kernel_cases
# and fused_cases); head_argmax: plain max logit minus the plain logit at the
# kernel's token, over max |plain logit|; kv_commit: exact
TOL = {"q4_gemv": 1e-2, "q4_dequant_matmul": 1e-2, "flash_attn": 2e-2,
       "dense_gemv": 1e-4, "head_argmax": 1e-4, "q4_mlp": 2e-2,
       "layer_tail": 2e-2, "kv_commit": 0.0,
       # against the plain version's unrounded f32 values (turbo_cases)
       "q4_gemv_a8": 5e-3, "q4_prefill_a8": 5e-3, "w8_matmul": 5e-3,
       "q4_matmul_glu": 1e-2, "q4_mlp_a8": 2e-2,
       # K7 in one-pass a8: the JAX suite's own limit for its fused layer
       # kernel in a8 (tests/test_attn_block.py:478); a8x2 keeps K7's 2e-2
       "layer_tail_a8": 5e-2, "layer_tail_a8x2": 2e-2}
# over an int8 / int4 KV cache: kernel and plain version read the same bytes
# and scales, so K3 and K7 keep their limits and K8 stays bit-equal
KV_KINDS = ("int8", "int4")
for _kind in KV_KINDS:
    for _name in ("flash_attn", "layer_tail", "layer_tail_a8", "kv_commit"):
        TOL[f"{_name}_{_kind}"] = TOL[_name]
# the f32-scale builds (scale_dtype="f32") keep their bf16 builds' limits
F32_KERNELS = ("q4_gemv", "q4_dequant_matmul", "q4_mlp", "layer_tail",
               "q4_gemv_a8", "q4_prefill_a8", "q4_matmul_glu")
for _name in F32_KERNELS:
    TOL[f"{_name}_f32"] = TOL[_name]


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing

class Timer:
    """Median over fenced runs, each preceded by an L2 flush (the decode path
    streams its weights cold: 3.5 GB per token against a 50 MB L2) and by a
    ~1 ms spin on the card, so that the host has queued the whole call by
    the time the start event is reached: the time is the card's, not the
    wrapper's Python."""

    SPIN_CYCLES = 2_000_000        # ~1 ms at the H100's ~2 GHz SM clock

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
            torch.cuda._sleep(self.SPIN_CYCLES)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def bound_ms(nbytes, flops, peak=BF16_FLOP_PER_S):
    """The least time the card could take: bytes over the memory rate or
    operations over ``peak`` (the tensor-core rate of their type)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def q4_bytes(k, n, gs, scale_bytes=2):
    """Packed nibbles plus the scales and zero-scales (bf16, or f32 with
    ``scale_bytes`` 4) of a K x N tensor."""
    return k * n // 2 + 2 * (k // gs) * n * scale_bytes


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


# timings a case may carry beside kernel / plain / library / bound
EXTRA_TIMES = ("separate_ms", "k2_ms", "library_int8_ms", "floor_ms",
               "bf16_ms", "parent_ms")


def make_recorder(timer, res):
    """record(...) times kernel, plain, library (l_fn), the port's separate
    chain (s_fn) and ``extra`` {name in EXTRA_TIMES: fn or None} in turns
    and files the case under res[kernel]."""
    def record(kernel, label, err, rel, k_fn, p_fn, l_fn, nbytes, flops,
               iters=15, s_fn=None, peak=BF16_FLOP_PER_S, extra=None):
        kms = timer(k_fn, iters)
        pms = timer(p_fn, max(3, iters // 3))
        lms = None if l_fn is None else timer(l_fn, iters)
        extra = dict(extra or {})
        if s_fn is not None:
            extra["separate_ms"] = s_fn
        more = {key: None if fn is None else timer(fn, iters)
                for key, fn in extra.items()}
        b, by = bound_ms(nbytes, flops, peak)
        r = dict(case=label, max_abs_err=err, rel_err=rel, ms=kms,
                 plain_ms=pms, library_ms=lms, bound_ms=b, bound_by=by,
                 **more)
        res.setdefault(kernel, []).append(r)
        log(f"  {kernel:18s} {label:34s} err {err:.3g} (rel {rel:.2g} <= "
            f"{TOL[kernel]:g})  "
            f"kernel_ms {kms:.4f}  plain_ms {pms:.4f}  library_ms "
            f"{'n/a' if lms is None else f'{lms:.4f}'}  "
            + "".join(f"{key} {'n/a' if v is None else f'{v:.4f}'}  "
                      for key, v in more.items())
            + f"bound_ms {b:.4f} ({by})")
    return record


def kernel_cases(device, timer, res):
    """Hold K1-K4 against their plain versions at main-path shapes and time
    kernel / plain / library into res {kernel: [case results]}."""
    from exllama_tpu_torch import kernels
    from exllama_tpu_torch.formats.gptq import dequantize_t
    from exllama_tpu_torch.ops import attention, dense, quant

    gen = torch.Generator(device=device).manual_seed(SEED)
    record = make_recorder(timer, res)

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
            nbytes = (q4_bytes(k, n, gs) + m * k * 2
                      + m * n * 2 + (k * 2 if nw is not None else 0)
                      + (k * 4 if act else 0))
            record("q4_gemv", f"{nm} g{gs} M={m}" + (" norm" if nw is not None
                                                     else ""),
                   err, rel, lambda: quant.q4_gemv(x, qt, nw, 1e-6),
                   lambda: quant.q4_gemv_plain(x, qt, nw, 1e-6),
                   lambda: torch.matmul(x, w), nbytes, 2 * m * k * n)
        del w

    k2_cases(device, timer, res)

    # K3: rel tol 2e-2 -- the kernel rounds p to bf16 inside the online
    # softmax (against a running max), the plain version once against the
    # final max; one bf16 rounding of p is 2^-8 relative
    acases = [
        # label, B, T, Hkv, past, attend_len, deferred, masked
        ("decode past=0", 1, 1, 32, 0, 256, True, False),
        ("decode past=100", 1, 1, 32, 100, 256, True, False),
        ("decode past=2000", 1, 1, 32, 2000, 2048, True, False),
        ("decode B=2 past=2000 gqa8", 2, 1, 8, 2000, 2048, True, False),
        # the split-KV decode's 64-key splits: one key, ragged, full, empty
        ("decode past=1", 1, 1, 32, 1, 256, True, False),
        ("decode past=63", 1, 1, 32, 63, 256, True, False),
        ("decode past=64", 1, 1, 32, 64, 256, True, False),
        ("decode past=65", 1, 1, 32, 65, 256, True, False),
        ("decode past=127", 1, 1, 32, 127, 256, True, False),
        ("decode B=4 past=[0,65,1000,2000]", 4, 1, 32, [0, 65, 1000, 2000],
         2048, True, False),
        ("prefill T=1919 past=0", 1, 1919, 32, 0, 2048, False, False),
        ("prefill B=2 T=64 past=[1000,1100]", 2, 64, 32, [1000, 1100], 1280,
         False, False),
        ("prefill B=2 T=64 left-pad mask", 2, 64, 32, 0, 256, False, True),
        # the speculative verify forward: T = k + 1 query rows of a chunk
        # written at the cursor, on the split-KV decode path
        ("verify T=4 past=1024", 1, 4, 32, 1024, 1280, False, False),
        ("verify T=5 past=1100", 1, 5, 32, 1100, 1280, False, False),
        ("verify T=9 past=2000", 1, 9, 32, 2000, 2048, False, False),
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
        if label.startswith("verify"):
            plant_chunk_keys(q, kc, past)
        got = attention.attend(q, kc, vc, past_t, alen, mask, new_kv)
        ref = attention.attend_plain(q, kc, vc, past_t, alen, mask, new_kv)
        err, rel = check_close(f"flash_attn {label}", got, ref,
                               TOL["flash_attn"])
        if label.startswith("verify"):
            # the fault: the causal mask inside the chunk dropped, every
            # row seeing the whole chunk
            leak = attention.attend_plain(q, kc, vc, past + t - 1, alen,
                                          mask, new_kv).float()
            moved = ((leak - ref.float()).abs().max()
                     / ref.float().abs().max()).item()
            if moved <= 3 * TOL["flash_attn"]:
                raise AssertionError(f"flash_attn {label}: a chunk without "
                                     f"its causal mask moves only {moved}")

        # work this data needs: visible keys per query row, K/V rows read
        vis, kv_rows = 0, 0
        for bi in range(b):
            lim = [min(alen, pasts[bi] + ti + (0 if deferred else 1))
                   for ti in range(t)]
            vis += sum(li + (1 if deferred else 0) for li in lim)
            kv_rows += max(lim)
        flops = 4 * d * h * vis
        nbytes = (2 * q.numel() * 2 + 2 * kv_rows * hkv * d * 2
                  + (2 * b * hkv * d * 2 if deferred else 0)
                  + (b * alen if masked else 0))

        # library yardstick: SDPA over the cache slice with the same
        # causal / padding mask (the in-flight row of a deferred step is
        # not folded in; SDPA's boolean mask drops padding keys where the
        # port adds the finite pad bias)
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
    # order of the f32 sums differs, and it is fixed: two calls on the same
    # inputs give the same bits. V = 32001 (a vocab with one added token)
    # runs the cp.async copies of each row; above 32 rows the lm_head of a
    # verify step (40), an admission chunk (64) and a perplexity chunk
    # (1919). Timed beside its parent (the stream-K loop K5 runs, at <= 32
    # rows) in the same call.
    for v in (32000, 32001):
        w = (torch.randn((4096, v), generator=gen, device=device)
             * 0.02).bfloat16()
        for m in K4_ROWS:
            x = torch.randn((m, 4096), generator=gen,
                            device=device).bfloat16()
            got = dense.dense_gemv(x, w)
            ref = dense.dense_gemv_plain(x, w)
            err, rel = check_close(f"dense_gemv V={v} M={m}", got, ref,
                                   TOL["dense_gemv"])
            if not torch.equal(got, dense.dense_gemv(x, w)):
                raise AssertionError(f"dense_gemv V={v} M={m}: two calls "
                                     f"on the same inputs differ")
            del got, ref
            record("dense_gemv", f"lm_head 4096->{v} M={m}", err, rel,
                   lambda: dense.dense_gemv(x, w),
                   lambda: dense.dense_gemv_plain(x, w),
                   lambda: torch.matmul(x, w), 4096 * v * 2 + m * 4096 * 2
                   + m * v * 4, 2 * m * 4096 * v,
                   iters=15 if m <= 64 else 5,
                   extra={"parent_ms": (lambda: k4_parent(x, w))
                          if m <= dense.GEMV_MAX_M else None})
            r = res["dense_gemv"][-1]
            plan = dense.dense_plan(m, 4096, v, kernels.sm_count(device))
            r.update(share=r["bound_ms"] / r["ms"], tile=f"{plan.bm}x256",
                     stream_k=plan.stream_k, grid=plan.grid)
        del w
    log("  K4 against its parent (the stream-K loop), ms: " + "; ".join(
        f"{r['case']} {r['ms']:.4f} / parent "
        f"{'n/a' if r['parent_ms'] is None else format(r['parent_ms'], '.4f')}"
        f" / library {r['library_ms']:.4f} / bound {r['bound_ms']:.4f} "
        f"(share {r['share']:.1%}, {r['tile']}"
        f"{' stream-K' if r['stream_k'] else ''})"
        for r in res["dense_gemv"]))


# the row counts K4 meets: decode (1), a beam step (2), the engine's 8-row
# step, a 32-row graph bucket, the 40-row verify step, a 64-row admission
# chunk, a 1919-row perplexity chunk
K4_ROWS = (1, 2, 8, 32, 40, 64, 1919)


def k4_parent(x, w):
    """K4's parent: the stream-K loop of csrc/dense_stream.cuh (entry
    dense_gemv_stream_launch, K5's loop), K4's kernel before the Hopper one,
    timed beside it; no wrapper of the package reaches it."""
    from exllama_tpu_torch import kernels
    from exllama_tpu_torch.ops import dense, quant

    m, k = x.shape
    v = w.shape[1]
    tiles, grid = dense.dense_grid(k, v, kernels.sm_count(x.device))
    part, ticket = quant.gemv_scratch(
        x.device, grid * 2 * dense._pow2(m) * dense.DENSE_BN, tiles)
    out = torch.empty((m, v), dtype=torch.float32, device=x.device)
    kernels.check(kernels.launcher("dense_gemv_stream")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(),
        ticket.data_ptr(), m, k, v, grid, kernels.stream_of(x)),
        "dense_gemv_stream")
    return out


def k1_parent(x, qt, nw, eps):
    """K1's parent at 2..32 rows: the mma.sync tensor-core route of
    csrc/q4_gemv_tc.cuh in the exact mode (entry q4_gemv_tc_launch), K1's
    kernel before the Hopper one, timed beside it; no wrapper of the
    package reaches it."""
    from exllama_tpu_torch import kernels
    from exllama_tpu_torch.ops import quant

    m, k = x.shape
    n = qt.out_features
    nsplit = quant.gemv_split_plan(n, k, kernels.sm_count(x.device))
    tiles = -(-n // quant.GEMV_BN)
    part, ticket = quant.gemv_scratch(
        x.device, tiles * nsplit * quant.gemv_rows(m) * quant.GEMV_BN, tiles)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = kernels.scaled("q4_gemv_tc", qt.scales)
    kernels.check(kernels.launcher(lib)(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), kernels.ptr(nw), kernels.ptr(qt.x_map),
        out.data_ptr(), part.data_ptr(), ticket.data_ptr(), m, k, n,
        qt.groupsize, nsplit, float(eps), kernels.stream_of(x)), lib)
    return out


def parent_launches() -> dict:
    """The C launch counters of the parents of K1 (both scale builds), K2
    and K4: phase 3's timings are their only callers."""
    from exllama_tpu_torch import kernels

    return {name: kernels.launcher(name)() for name in (
        "q4_gemv_tc_launches", "q4_gemv_tc_launches_f32",
        "q4_matmul_ring_launches", "dense_gemv_stream_launches")}


def ring_parent(x, qt):
    """K2's parent: the mma.sync ring's Exact mode (csrc/q4_ring.cuh,
    entry q4_matmul_ring_launch), K2's kernel before the Hopper one,
    timed beside it; no wrapper of the package reaches it."""
    from exllama_tpu_torch import kernels

    m, k = x.shape
    out = torch.empty((m, qt.out_features), dtype=torch.bfloat16,
                      device=x.device)
    kernels.check(kernels.launcher("q4_matmul_ring")(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), out.data_ptr(), m, k, qt.out_features,
        qt.groupsize, kernels.stream_of(x)), "q4_matmul_ring")
    return out


# the row counts K2 meets on the main path: the engine's 40-row verify
# step, a 64-row admission chunk, a 127-row chunk, the 1919-token prefill
K2_ROWS = (40, 64, 127, 1919)


def k2_cases(device, timer, res):
    """K2 (csrc/q4_wgmma.cuh) against its plain version, 1e-2 -- the same
    bf16 weights on both sides; f32 sums in another order and the bf16
    output rounding (2^-8) -- and timed beside its parent (the ring's Exact
    mode, ``ring_parent``, in the same call), one library call and its
    bound: at 40, 64, 127 and 1919 rows on the four Llama-7B projections at
    g128; g32 and act-order at 127 rows; the edges of its row tiles (33,
    64 / 65, 128 / 129, 256 / 257), ragged and unaligned N (4168, 130,
    100); the tp = 2 / 4 shard shapes at 40 and 1919 rows. A second call on
    the same inputs is bit-equal (stream-K's fixed combine order)."""
    from exllama_tpu_torch import kernels
    from exllama_tpu_torch.formats.gptq import dequantize_t, tp_chunk
    from exllama_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    record = make_recorder(timer, res)
    shapes = [("qkv", 4096, 12288), ("o", 4096, 4096),
              ("gateup", 4096, 22016), ("down", 11008, 4096)]
    cases = [(f"{nm} g128 M={m}", m, k, n, 128, False)
             for nm, k, n in shapes for m in K2_ROWS]
    cases += [("gateup-g32 g32 M=127", 127, 4096, 22016, 32, False),
              ("down-actorder g128 M=127", 127, 11008, 4096, 128, True)]
    cases += [(f"edge {k}->{n} g128 M={m}", m, k, n, 128, False)
              for m, k, n in ((33, 4096, 4096), (65, 4096, 4096),
                              (128, 4096, 4096), (129, 4096, 4096),
                              (256, 4096, 4096), (257, 4096, 4096),
                              (1919, 4096, 4168), (40, 4096, 130),
                              (1919, 4096, 100))]
    for tp in (2, 4):
        for nm, k, n in (("qkv", 4096, 12288 // tp), ("o", 4096 // tp, 4096),
                         ("gateup", 4096, 22016 // tp),
                         ("down", tp_chunk(11008, tp, 128), 4096)):
            cases += [(f"tp{tp} {nm} {k}->{n} g128 M={m}", m, k, n, 128,
                       False) for m in (40, 1919)]
    weights = {}
    for label, m, k, n, gs, act in cases:
        key = (k, n, gs, act)
        if key not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            qt = random_qt(gen, k, n, gs, act, device)
            weights[key] = (qt, dequantize_t(qt))
        qt, w = weights[key]
        x = torch.randn((m, k), generator=gen, device=device).bfloat16()
        if act:       # the caller gathers act-order x (ops/quant.py)
            x = x.index_select(1, qt.x_map.long())
        got = quant.q4_dequant_matmul(x, qt)
        ref = quant._q4_matmul_plain(x, qt)
        err, rel = check_close(f"q4_dequant_matmul {label}", got, ref,
                               TOL["q4_dequant_matmul"])
        if not torch.equal(quant.q4_dequant_matmul(x, qt), got):
            raise AssertionError(f"q4_dequant_matmul {label}: two calls "
                                 f"on the same inputs differ")
        record("q4_dequant_matmul", label, err, rel,
               lambda: quant.q4_dequant_matmul(x, qt),
               lambda: quant._q4_matmul_plain(x, qt),
               lambda: torch.matmul(x, w),
               q4_bytes(k, n, gs) + m * k * 2 + m * n * 2, 2 * m * k * n,
               extra={"parent_ms": lambda: ring_parent(x, qt)})
        r = res["q4_dequant_matmul"][-1]
        plan = quant.q4_matmul_plan(m, n, k, kernels.sm_count(device))
        r.update(share=r["bound_ms"] / r["ms"], tile=f"{plan.bm}x{plan.bn}",
                 stream_k=plan.stream_k, grid=plan.grid)
    weights.clear()
    torch.cuda.empty_cache()
    log("  K2 against its parent (the ring's Exact mode), ms: " + "; ".join(
        f"{r['case']} {r['ms']:.4f} / parent {r['parent_ms']:.4f} / library "
        f"{r['library_ms']:.4f} / bound {r['bound_ms']:.4f} ({r['bound_by']},"
        f" share {r['share']:.1%}, {r['tile']}"
        f"{' stream-K' if r['stream_k'] else ''})"
        for r in res["q4_dequant_matmul"]))
    slow = [r["case"] for r in res["q4_dequant_matmul"]
            if r["case"].endswith(tuple(f" M={m}" for m in K2_ROWS))
            and r["case"].split()[0] in ("qkv", "o", "gateup", "down")
            and "g128" in r["case"] and r["ms"] >= r["parent_ms"]]
    if slow:
        log(f"  K2 not faster than its parent at: {slow}")


def fused_cases(device, timer, res):
    """Hold K5-K8 against their plain versions at Llama-7B shapes; time
    kernel / plain / library and, for K6 / K7, the port's chain of separate
    kernels (K1, K3 and plain tensor code) for the same work."""
    from exllama_tpu_torch.ops import attention, attn_block, dense, mlp, quant
    from exllama_tpu_torch.ops.norms import rms_norm
    from exllama_tpu_torch.ops.rope import (
        apply_rope_sliced,
        rope_tables,
        slice_tables,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    record = make_recorder(timer, res)
    hidden, inter, heads, d, s_max, vocab = 4096, 11008, 32, 128, 2048, 32000
    eps = 1e-6

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).bfloat16()

    def norm_w():
        return (torch.rand(hidden, generator=gen, device=device)
                + 0.5).bfloat16()

    # K5: the kernel's token must be a maximum of the plain logits up to
    # their f32 sum-order noise (1e-4 of the logit scale, as K4); the
    # reported error is max logit - logit at the kernel's token
    # (V = 32001, a vocab with one added token: K4's unaligned loads); two
    # calls on the same inputs give the same tokens
    nw = norm_w()
    for v in (vocab, vocab + 1):
        w = rnd(hidden, v, scale=0.02)
        for m in (1, 2, 8, 32):
            x = rnd(m, hidden)
            ids = dense.head_argmax(x, nw, w, eps)
            if not torch.equal(ids, dense.head_argmax(x, nw, w, eps)):
                raise AssertionError(f"head_argmax V={v} M={m}: two calls "
                                     f"on the same inputs differ")
            xn = rms_norm(x, nw, eps)
            logits = dense.dense_gemv_plain(xn, w)
            gap = (logits.amax(1)
                   - logits.gather(1, ids.long()).reshape(-1)).max().item()
            scale = logits.abs().max().item()
            if not gap <= TOL["head_argmax"] * scale:
                raise AssertionError(f"head_argmax V={v} M={m}: token logit "
                                     f"{gap:.3g} below the max (scale "
                                     f"{scale:.3g})")
            record("head_argmax", f"lm_head 4096->{v} M={m}", gap,
                   gap / scale, lambda: dense.head_argmax(x, nw, w, eps),
                   lambda: dense.head_argmax_plain(x, nw, w, eps),
                   lambda: torch.argmax(torch.matmul(xn, w), dim=-1),
                   hidden * v * 2 + m * hidden * 2 + hidden * 2 + m * 4,
                   2 * m * hidden * v)
        del w

    # K6: rel tol 2e-2 -- K1's 1e-2 twice over (gate|up, then down), the
    # same bf16 cast points on both sides; one row and the row tiles 8 /
    # 16 (M = 18: three n8 tiles of a 32-row tile) / 32 of the streaming
    # GEMV
    for gs, ms in ((128, (1, 2, 8, 18, 32)), (32, (1, 18))):
        gateup = random_qt(gen, hidden, 2 * inter, gs, False, device)
        down = random_qt(gen, inter, hidden, gs, False, device)
        nw = norm_w()
        for m in ms:
            h = rnd(m, 1, hidden)
            got = mlp.q4_mlp(h, nw, gateup, down, eps)
            ref = mlp.q4_mlp_plain(h, nw, gateup, down, eps)
            err, rel = check_close(f"q4_mlp g{gs} M={m}", got, ref,
                                   TOL["q4_mlp"])

            def separate():
                a = rms_norm(h, nw, eps)
                gu = quant.q4_matmul(a, gateup)
                mid = mlp.silu_mul(gu[..., :inter], gu[..., inter:])
                return h + quant.q4_matmul(mid, down)

            nbytes = (q4_bytes(hidden, 2 * inter, gs)
                      + q4_bytes(inter, hidden, gs)
                      + 2 * m * hidden * 2 + hidden * 2)
            flops = 2 * m * 3 * hidden * inter
            record("q4_mlp", f"g{gs} M={m}", err, rel,
                   lambda: mlp.q4_mlp(h, nw, gateup, down, eps),
                   lambda: mlp.q4_mlp_plain(h, nw, gateup, down, eps),
                   None, nbytes, flops, s_fn=separate)
        del gateup, down

    # K7: rel tol 2e-2 -- K3's bf16 rounding of p (running vs final max)
    # plus the GEMV phases' group-sum order (K1, K6)
    gs = 128
    o = random_qt(gen, heads * d, hidden, gs, False, device)
    gateup = random_qt(gen, hidden, 2 * inter, gs, False, device)
    down = random_qt(gen, inter, hidden, gs, False, device)
    iw, nw = norm_w(), norm_w()
    sin, cos = rope_tables(s_max, d, device=device)
    kcases = [
        # label, entry, B, Hkv, past, masked
        ("layer_tail B=1 past=2000", "layer_tail", 1, 32, 2000, False),
        ("attn_block_o B=1 past=2000", "attn_block_o", 1, 32, 2000, False),
        ("layer_step B=1 past=2000", "layer_step", 1, 32, 2000, False),
        ("layer_tail B=2 gqa8 past=2000 left-pad mask", "layer_tail", 2, 8,
         2000, True),
    ]
    qkvs = {}
    for label, entry, b, hkv, past, masked in kcases:
        if hkv not in qkvs:
            qkvs[hkv] = random_qt(gen, hidden, (heads + 2 * hkv) * d, gs,
                                  False, device)
        qkv = qkvs[hkv]
        h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
        kc, vc = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d)
        new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
        sin_t, cos_t = slice_tables(sin, cos, past, 1)
        mask = None
        if masked:
            mask = torch.ones((b, s_max), dtype=torch.bool, device=device)
            mask[0, :17] = False
        nq, nkv = heads * d, hkv * d
        if entry == "attn_block_o":
            args = (h, q, kc, vc, past, s_max, o, new_kv, mask)
            k_fn = lambda: attn_block.attn_block_o(*args)  # noqa: E731
            p_fn = lambda: attn_block.attn_block_o_plain(*args)  # noqa: E731
        elif entry == "layer_tail":
            args = (h, q, kc, vc, past, s_max, o, nw, gateup, down, eps,
                    new_kv, mask)
            k_fn = lambda: attn_block.layer_tail(*args)  # noqa: E731
            p_fn = lambda: attn_block.layer_tail_plain(*args)  # noqa: E731
        else:
            args = (h, qkv, iw, sin_t, cos_t, kc, vc, past, s_max, o, nw,
                    gateup, down, eps, heads, hkv, d, mask)
            k_fn = lambda: attn_block.layer_step(*args)  # noqa: E731
            p_fn = lambda: attn_block.layer_step_plain(*args)  # noqa: E731
        got, ref = k_fn(), p_fn()
        if entry == "layer_step":
            for i, nm in ((1, "k_row"), (2, "v_row")):
                check_close(f"layer_step {nm}", got[i], ref[i], 1e-2)
            got, ref = got[0], ref[0]
        err, rel = check_close(f"layer_tail {label}", got, ref,
                               TOL["layer_tail"])

        def separate(entry=entry, h=h, q=q, kc=kc, vc=vc, new_kv=new_kv,
                     mask=mask, qkv=qkv, sin_t=sin_t, cos_t=cos_t, b=b,
                     hkv=hkv, nq=nq, nkv=nkv):
            qq, kv = q, new_kv
            if entry == "layer_step":
                f = quant.q4_matmul(h, qkv, norm_w=iw, norm_eps=eps)
                qq = apply_rope_sliced(f[..., :nq].reshape(b, 1, heads, d),
                                       sin_t, cos_t)
                kk = apply_rope_sliced(
                    f[..., nq:nq + nkv].reshape(b, 1, hkv, d), sin_t, cos_t)
                kv = (kk, f[..., nq + nkv:].reshape(b, 1, hkv, d))
            attn = attention.attend(qq, kc, vc, past, s_max, mask, kv)
            h1 = h + quant.q4_matmul(attn.reshape(b, 1, nq), o)
            if entry == "attn_block_o":
                return h1
            gu = quant.q4_matmul(rms_norm(h1, nw, eps), gateup)
            mid = mlp.silu_mul(gu[..., :inter], gu[..., inter:])
            return h1 + quant.q4_matmul(mid, down)

        keys = b * min(past, s_max)
        nbytes = (q4_bytes(nq, hidden, gs) + 2 * keys * nkv * 2
                  + 2 * b * hidden * 2 + (b * s_max if masked else 0))
        flops = 4 * d * heads * b * (min(past, s_max) + 1) + 2 * b * nq * hidden
        if entry == "layer_step":
            nbytes += q4_bytes(hidden, nq + 2 * nkv, gs) + hidden * 2 + b * d * 8
            nbytes += 2 * b * nkv * 2              # the K/V rows it returns
            flops += 2 * b * hidden * (nq + 2 * nkv)
        else:
            nbytes += b * nq * 2 + 2 * b * nkv * 2  # q and the in-flight rows
        if entry != "attn_block_o":
            nbytes += (q4_bytes(hidden, 2 * inter, gs)
                       + q4_bytes(inter, hidden, gs) + hidden * 2)
            flops += 2 * b * 3 * hidden * inter
        record("layer_tail", label, err, rel, k_fn, p_fn, None, nbytes, flops,
               iters=10, s_fn=separate)
    del o, gateup, down, qkvs
    k7_attention_cases(device, timer, res)


def plant_chunk_keys(q, kc, past):
    """For the query rows of a chunk at ``past`` (q [B, T, H, D], one query
    head a kv head): row t's next key, at past + t + 1 (hidden from it by
    the causal mask), scores 8 above row t's best visible key, so that a
    row that sees past its own position takes that key's value. In place
    on kc."""
    d = q.shape[-1]
    qf = q.float()
    for i in range(q.shape[1] - 1):
        qi = qf[:, i]                                           # [B, H, D]
        best = (torch.einsum("bhd,bhsd->bhs", qi,
                             kc[:, :, :past + i + 1].float())
                / math.sqrt(d)).amax(-1)                        # [B, H]
        norm = qi.norm(dim=-1, keepdim=True)
        a = (best[..., None] + 8) * math.sqrt(d) / norm
        kc[:, :, past + i + 1] = (a * qi / norm).bfloat16()


def planted_attention(gen, b, heads, hkv, s_max, past, n_pad, device):
    """Decode attention inputs whose softmax is peaked and whose special
    keys carry real weight: q ~ 4 N(0, 1) (score std ~4), cache and new rows
    ~ N(0, 1). A planted key is a * u, u the unit direction of the summed
    queries of one (batch row, kv head) group; ``best`` is the group's best
    score over the keys n_pad..past. The in-flight K row scores best - 1 on
    the group's mean query head (about as much weight as the best cache
    key: more would drown the cache keys), and with ``n_pad`` row 0's first
    n_pad keys are padding (mask False) that score best + 8 on the least
    aligned head -- they win unless the pad bias is applied. Returns q,
    k_cache, v_cache, (k_new, v_new), mask (None without padding)."""
    d, g = 128, heads // hkv

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).bfloat16()

    q, kc, vc = rnd(b, 1, heads, d, scale=4.0), rnd(b, hkv, s_max, d), \
        rnd(b, hkv, s_max, d)
    kn, vn = rnd(b, 1, hkv, d), rnd(b, 1, hkv, d)
    qg = q.float().reshape(b, hkv, g, d)
    u = qg.sum(2)
    u = u / u.norm(dim=-1, keepdim=True)                        # [B, Hkv, D]
    per_unit = (qg * u[:, :, None]).sum(-1) / math.sqrt(d)     # [B, Hkv, G]
    best = (torch.einsum("bhgd,bhsd->bhgs", qg,
                         kc[:, :, n_pad:past].float())
            / math.sqrt(d)).amax((2, 3))                        # [B, Hkv]
    kn = (((best - 1) / per_unit.mean(2))[..., None] * u)[:, None].bfloat16()
    mask = None
    if n_pad:
        mask = torch.ones((b, s_max), dtype=torch.bool, device=device)
        mask[0, :n_pad] = False
        a = (best[0] + 8) / per_unit[0].amin(1)
        kc[0, :, :n_pad] = (a[:, None, None] * u[0][:, None, :]).bfloat16()
    return q, kc, vc, (kn, vn), mask


def k7_attention_cases(device, timer, res):
    """K7's attention at its own scale: attn_block_o with h = 0, so the
    output is o-proj(attention) alone (the other K7 cases add a residual of
    std ~1, beside which an attention fault is below the tolerance), on
    planted_attention's inputs. Each case first shows on the plain version
    that every fault it guards against moves the output by more than 3x
    the tolerance: the in-flight row dropped (its K row negated, so it
    scores far below every key), the pad bias left out (no mask), one key
    split lost (keys 256-511, K7's second split at 8 splits, given the pad
    bias), and the two faults the last block's merge of the splits could
    have: a split dropped, or counted twice (attention_split_plain)."""
    from exllama_tpu_torch.ops import attn_block

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    record = make_recorder(timer, res)
    hidden, heads, d, s_max, past, gs = 4096, 32, 128, 2048, 2000, 128
    tol = TOL["layer_tail"]
    o = random_qt(gen, heads * d, hidden, gs, False, device)
    for label, b, hkv, n_pad in (
            ("attn_block_o h=0 peaked B=1 past=2000", 1, 32, 0),
            ("attn_block_o h=0 peaked B=2 gqa8 left-pad", 2, 8, 17)):
        q, kc, vc, new_kv, mask = planted_attention(gen, b, heads, hkv,
                                                    s_max, past, n_pad,
                                                    device)
        h = torch.zeros((b, 1, hidden), dtype=torch.bfloat16, device=device)
        args = (h, q, kc, vc, past, s_max, o, new_kv, mask)
        ref = attn_block.attn_block_o_plain(*args)
        scale = ref.float().abs().max().item()
        lost = torch.ones((b, s_max), dtype=torch.bool, device=device)
        lost[:, 256:512] = False
        faults = {
            "in-flight row dropped": (h, q, kc, vc, past, s_max, o,
                                      (-new_kv[0], new_kv[1]), mask),
            "split lost": (h, q, kc, vc, past, s_max, o, new_kv,
                           lost if mask is None else lost & mask),
        }
        if mask is not None:
            faults["pad bias left out"] = (h, q, kc, vc, past, s_max, o,
                                           new_kv, None)
        # the last block's merge of the key splits (8 splits: K7's at B = 1
        # on two blocks an SM): each head's heaviest split dropped, or
        # counted twice
        split = (h, q, kc, vc, past, s_max, o, None, None, None, 1e-6,
                 new_kv, mask)
        for fault in ("drop", "twice"):
            faults[f"merge: heaviest split {fault}"] = (split, fault)
        margins = {}
        for fault, fargs in faults.items():
            out = (attn_block.layer_tail_split_plain(
                *fargs[0], blocks=264, nsplit=8, fault=fargs[1])
                if fault.startswith("merge") else
                attn_block.attn_block_o_plain(*fargs))
            moved = (out.float() - ref.float()).abs().max().item()
            margins[fault] = round(moved / (tol * scale), 1)
            if not moved > 3 * tol * scale:
                raise AssertionError(f"{label}: '{fault}' moves the plain "
                                     f"output by only {moved:.3g} (scale "
                                     f"{scale:.3g})")
        log(f"  {label}: each fault moves the plain output by this many "
            f"times the tolerance: {margins}")
        got = attn_block.attn_block_o(*args)
        err, rel = check_close(f"layer_tail {label}", got, ref, tol)
        nq, nkv = heads * d, hkv * d
        nbytes = (q4_bytes(nq, hidden, gs) + 2 * b * past * nkv * 2
                  + 2 * b * hidden * 2 + b * nq * 2 + 2 * b * nkv * 2
                  + (b * s_max if mask is not None else 0))
        flops = 4 * d * heads * b * (past + 1) + 2 * b * nq * hidden
        record("layer_tail", label, err, rel,
               lambda: attn_block.attn_block_o(*args),
               lambda: attn_block.attn_block_o_plain(*args), None, nbytes,
               flops, iters=10)


def k7_sweep_cases(device):
    """K7 at B = 1, 2 and 8 (GQA 8 beyond one row, each row its own cursor)
    in each GEMV mode over each cache format at Llama-7B widths, held
    against its plain version at the usual limits (exact and a8x2 2e-2, a8
    5e-2, the K/V rows 1e-2): layer_step (every phase) in the exact and
    a8x2 modes, layer_tail in one-pass a8 (whose q from an int8-activation
    GEMV moves a peaked softmax beyond a8's limit: tests/test_torch_kernels
    .py); two calls on the same inputs give the same bits (every split is
    combined in a fixed order)."""
    from exllama_tpu_torch.ops import attn_block
    from exllama_tpu_torch.ops.rope import rope_tables, slice_tables

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    hidden, inter, heads, d, s_max, gs, eps = 4096, 11008, 32, 128, 2048, 128, 1e-6

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).bfloat16()

    o = random_qt(gen, heads * d, hidden, gs, False, device)
    gateup = random_qt(gen, hidden, 2 * inter, gs, False, device)
    down = random_qt(gen, inter, hidden, gs, False, device)
    iw, nw = ((torch.rand(hidden, generator=gen, device=device) + 0.5)
              .bfloat16() for _ in range(2))
    sin, cos = rope_tables(s_max, d, device=device)
    for b in (1, 2, 8):
        hkv = 32 if b == 1 else 8
        qkv = random_qt(gen, hidden, (heads + 2 * hkv) * d, gs, False, device)
        past = torch.tensor([2000 - 37 * i for i in range(b)],
                            dtype=torch.int32, device=device)
        sin_t, cos_t = slice_tables(sin, cos, past, 1)
        h = rnd(b, 1, hidden)
        errs = {}
        for kind in ("bf16", "int8", "int4"):
            if kind == "bf16":
                kc, vc, ks, vs = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d), \
                    None, None
            else:
                kc, vc, ks, vs = quantized_cache(gen, kind, b, hkv, s_max, d,
                                                 device, spread=False)
            for impl in ("auto", "pallas_a8", "pallas_a8x2"):
                mode = {"auto": "", "pallas_a8": "_a8",
                        "pallas_a8x2": "_a8x2"}[impl]
                if impl == "pallas_a8":
                    q = rnd(b, 1, heads, d)
                    new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
                    args = (h, q, kc, vc, past, s_max, o, nw, gateup, down,
                            eps, new_kv, None, impl, ks, vs)
                    fn, plain = attn_block.layer_tail, attn_block.layer_tail_plain
                else:
                    args = (h, qkv, iw, sin_t, cos_t, kc, vc, past, s_max, o,
                            nw, gateup, down, eps, heads, hkv, d, None, impl,
                            ks, vs)
                    fn, plain = attn_block.layer_step, attn_block.layer_step_plain
                got, again, ref = fn(*args), fn(*args), plain(*args)
                label = f"{fn.__name__}{mode} {kind} B={b}"
                if fn is attn_block.layer_step:
                    for i, nm in ((1, "k_row"), (2, "v_row")):
                        check_close(f"{label} {nm}", got[i], ref[i], 1e-2)
                else:
                    got, again, ref = (got,), (again,), (ref,)
                _, rel = check_close(label, got[0], ref[0],
                                     TOL[f"layer_tail{mode}"])
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    raise AssertionError(f"{label}: two calls on the same "
                                         f"inputs differ")
                errs[f"{kind}{mode or ' exact'}"] = round(rel, 5)
            del kc, vc, ks, vs
        log(f"  layer_tail sweep B={b}: rel err (limits 2e-2, a8 5e-2), "
            f"bit-equal on two calls: {errs}")
        del qkv


def with_outliers(gen, x, gs, factor=50.0):
    """One element per group of gs scaled up by ``factor``: it sets the int8
    step of its whole group, which is the noise the a8x2 residual pass takes
    away (elsewhere a8 and a8x2 differ by less than K9's tolerance)."""
    m, k = x.shape
    idx = torch.randint(0, gs, (m, k // gs), generator=gen, device=x.device)
    idx = idx + torch.arange(0, k, gs, device=x.device)
    return x.scatter(1, idx, (x.gather(1, idx).float() * factor).bfloat16())


def require_fault_moves(label, ref, faulty, tol):
    """Each plain output in ``faulty`` {fault: tensor} must differ from the
    plain ``ref`` by more than 3x the tolerance: a kernel with that fault
    could not pass."""
    scale = ref.float().abs().max().item()
    margins = {}
    for fault, out in faulty.items():
        moved = (out.float() - ref.float()).abs().max().item()
        margins[fault] = round(moved / (tol * scale), 1)
        if not moved > 3 * tol * scale:
            raise AssertionError(f"{label}: '{fault}' moves the plain output "
                                 f"by only {moved:.3g} (scale {scale:.3g})")
    log(f"  {label}: each fault moves the plain output by this many times "
        f"the tolerance: {margins}")


def turbo_cases(device, timer, res):
    """Hold K9-K12 against their plain versions at Llama-7B shapes, with
    kernel / plain / library / bound times. K9-K11 do the same integer
    arithmetic as their plain versions, so they are held to 5e-3 of the
    output scale against the plain version's unrounded f32 values: what is
    left is the kernel's bf16 output rounding (half a step, at most 0.39% of
    an element) and the order of the f32 sums."""
    from exllama_tpu_torch.formats.gptq import (
        dequantize_t,
        w8_col_scale,
        with_w8,
    )
    from exllama_tpu_torch.ops import attn_block, mlp, quant
    from exllama_tpu_torch.ops.norms import rms_norm
    from exllama_tpu_torch.ops.rope import rope_tables, slice_tables

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    record = make_recorder(timer, res)
    hidden, inter, heads, d, s_max, gs = 4096, 11008, 32, 128, 2048, 128
    eps = 1e-6
    f32 = torch.float32

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).bfloat16()

    def norm_w():
        return (torch.rand(hidden, generator=gen, device=device)
                + 0.5).bfloat16()

    def broken(qt, **kw):
        return dataclasses.replace(qt, **kw)

    def no_even_nibbles(qt):
        return broken(qt, qweight=qt.qweight & ~0x0F0F0F0F)

    # ---- K9: the a8 / a8x2 GEMV beside K1 on the same inputs
    qkv = random_qt(gen, hidden, 12288, gs, False, device)
    down = random_qt(gen, inter, hidden, gs, False, device)
    nw = norm_w()
    for nm, qt, k, n, w_norm, ms in (("qkv", qkv, hidden, 12288, nw, (1, 18)),
                                     ("down", down, inter, hidden, None, (1,))):
        w = dequantize_t(qt)
        nbytes0 = q4_bytes(k, n, gs) + (k * 2 if w_norm is not None else 0)
        for m in ms:
            x = with_outliers(gen, rnd(m, k), gs)
            nbytes = nbytes0 + m * k * 2 + m * n * 2
            tag = f"{nm} g{gs} M={m}" + (" norm" if w_norm is not None else "")
            if m > 2:      # K1 at this M, not among kernel_cases' shapes
                got = quant.q4_gemv(x, qt, w_norm, eps)
                ref = quant.q4_gemv_plain(x, qt, w_norm, eps)
                err, rel = check_close(f"q4_gemv {tag}", got, ref,
                                       TOL["q4_gemv"])
                record("q4_gemv", tag, err, rel,
                       lambda: quant.q4_gemv(x, qt, w_norm, eps),
                       lambda: quant.q4_gemv_plain(x, qt, w_norm, eps),
                       lambda: torch.matmul(x, w), nbytes, 2 * m * k * n)
            for two_pass in (False, True):
                mode = "a8x2" if two_pass else "a8"
                ref = quant.q4_gemv_a8_plain(x, qt, w_norm, eps, two_pass, f32)
                if m == 1 and nm == "qkv":
                    faulty = {
                        "zero-point term dropped": quant.q4_gemv_a8_plain(
                            x, broken(qt, zscale=torch.zeros_like(qt.zscale)),
                            w_norm, eps, two_pass, f32),
                        "even nibbles dropped": quant.q4_gemv_a8_plain(
                            x, no_even_nibbles(qt), w_norm, eps, two_pass, f32),
                    }
                    if two_pass:
                        faulty["residual pass dropped"] = \
                            quant.q4_gemv_a8_plain(x, qt, w_norm, eps, False,
                                                   f32)
                    require_fault_moves(f"q4_gemv_a8 {mode} {tag}", ref,
                                        faulty, TOL["q4_gemv_a8"])
                got = quant.q4_gemv_a8(x, qt, w_norm, eps, two_pass)
                err, rel = check_close(f"q4_gemv_a8 {mode} {tag}", got, ref,
                                       TOL["q4_gemv_a8"])
                record("q4_gemv_a8", f"{mode} {tag}", err, rel,
                       lambda: quant.q4_gemv_a8(x, qt, w_norm, eps, two_pass),
                       lambda: quant.q4_gemv_a8_plain(x, qt, w_norm, eps,
                                                      two_pass),
                       lambda: torch.matmul(x, w), nbytes, 2 * m * k * n)
        del w
    del qkv

    # ---- K6 in K9's arithmetic: 2e-2, as the exact K6 (gate|up is rounded
    # to bf16 between the GEMVs on both sides)
    gateup = random_qt(gen, hidden, 2 * inter, gs, False, device)
    nbytes_mlp = (q4_bytes(hidden, 2 * inter, gs) + q4_bytes(inter, hidden, gs)
                  + hidden * 2)
    gu32 = random_qt(gen, hidden, 2 * inter, 32, False, device)
    dn32 = random_qt(gen, inter, hidden, 32, False, device)
    for m, impl, gu, dn in ((1, "pallas_a8", gateup, down),
                            (1, "pallas_a8x2", gateup, down),
                            (18, "pallas_a8", gateup, down),
                            (18, "pallas_a8x2", gateup, down),
                            (1, "pallas_a8", gu32, dn32)):
        h = rnd(m, 1, hidden)
        got = mlp.q4_mlp(h, nw, gu, dn, eps, impl)
        ref = mlp.q4_mlp_plain(h, nw, gu, dn, eps, impl)
        tag = f"{impl[7:]} g{gu.groupsize} M={m}"
        err, rel = check_close(f"q4_mlp_a8 {tag}", got, ref, TOL["q4_mlp_a8"])

        def separate():
            a = rms_norm(h, nw, eps)
            gu_out = quant.q4_matmul(a, gu, impl)
            mid = mlp.silu_mul(gu_out[..., :inter], gu_out[..., inter:])
            return h + quant.q4_matmul(mid, dn, impl)

        record("q4_mlp_a8", tag, err, rel,
               lambda: mlp.q4_mlp(h, nw, gu, dn, eps, impl),
               lambda: mlp.q4_mlp_plain(h, nw, gu, dn, eps, impl),
               None, q4_bytes(hidden, 2 * inter, gu.groupsize)
               + q4_bytes(inter, hidden, gu.groupsize) + hidden * 2
               + 2 * m * hidden * 2, 2 * m * 3 * hidden * inter,
               s_fn=separate)
    del gu32, dn32

    # ---- K7 in K9's arithmetic: a8x2 2e-2, as the exact K7; one-pass a8
    # 5e-2, since the kernel's attention row differs from the plain one by
    # bf16 steps and a step in a GEMV's input draws other int8 roundings
    # (K9 itself is held to 5e-3 above). The attention is held at its own
    # scale (h = 0, planted keys) as in k7_attention_cases
    o = random_qt(gen, heads * d, hidden, gs, False, device)
    qkv7 = random_qt(gen, hidden, 3 * heads * d, gs, False, device)
    iw = norm_w()
    sin, cos = rope_tables(s_max, d, device=device)
    b, hkv, past = 1, 32, 2000
    nq = nkv = heads * d
    sin_t, cos_t = slice_tables(sin, cos, past, 1)
    h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
    kc, vc = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d)
    new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
    # B = 2, GQA-8, row 0 left-padded by 17 tokens (the exact K7's case)
    h2, q2 = rnd(2, 1, hidden), rnd(2, 1, heads, d)
    kc2, vc2 = rnd(2, 8, s_max, d), rnd(2, 8, s_max, d)
    new_kv2 = (rnd(2, 1, 8, d), rnd(2, 1, 8, d))
    mask2 = torch.ones((2, s_max), dtype=torch.bool, device=device)
    mask2[0, :17] = False
    for entry, impl in (("layer_tail", "pallas_a8"),
                        ("layer_tail", "pallas_a8x2"),
                        ("layer_step", "pallas_a8"),
                        ("layer_tail gqa8", "pallas_a8")):
        if entry == "layer_tail gqa8":
            args = (h2, q2, kc2, vc2, past, s_max, o, nw, gateup, down, eps,
                    new_kv2, mask2, impl)
            k_fn = lambda: attn_block.layer_tail(*args)  # noqa: E731
            p_fn = lambda: attn_block.layer_tail_plain(*args)  # noqa: E731
        elif entry == "layer_tail":
            args = (h, q, kc, vc, past, s_max, o, nw, gateup, down, eps,
                    new_kv, None, impl)
            k_fn = lambda: attn_block.layer_tail(*args)  # noqa: E731
            p_fn = lambda: attn_block.layer_tail_plain(*args)  # noqa: E731
        else:
            args = (h, qkv7, iw, sin_t, cos_t, kc, vc, past, s_max, o, nw,
                    gateup, down, eps, heads, hkv, d, None, impl)
            k_fn = lambda: attn_block.layer_step(*args)  # noqa: E731
            p_fn = lambda: attn_block.layer_step_plain(*args)  # noqa: E731
        got, ref = k_fn(), p_fn()
        if entry == "layer_step":
            for i, nm in ((1, "k_row"), (2, "v_row")):
                check_close(f"layer_step a8 {nm}", got[i], ref[i], 1e-2)
            got, ref = got[0], ref[0]
        gqa = entry.endswith("gqa8")
        bb, kv_w = (2, 8 * d) if gqa else (b, nkv)
        tag = (f"{impl[7:]} {entry} B={bb} past=2000"
               + (" left-pad mask" if gqa else ""))
        err, rel = check_close(f"layer_tail_a8 {tag}", got, ref,
                               TOL[f"layer_tail_{impl[7:]}"])
        nbytes = (q4_bytes(nq, hidden, gs) + 2 * bb * past * kv_w * 2
                  + 2 * bb * hidden * 2 + nbytes_mlp
                  + (bb * s_max if gqa else 0))
        flops = (4 * d * heads * bb * (past + 1) + 2 * bb * nq * hidden
                 + 2 * bb * 3 * hidden * inter)
        if entry == "layer_step":
            nbytes += (q4_bytes(hidden, nq + 2 * nkv, gs) + hidden * 2
                       + b * d * 8 + 2 * b * nkv * 2)
            flops += 2 * b * hidden * (nq + 2 * nkv)
        else:
            nbytes += bb * nq * 2 + 2 * bb * kv_w * 2
        record(f"layer_tail_{impl[7:]}", tag, err, rel, k_fn, p_fn, None,
               nbytes, flops, iters=10)
    del qkv7, gateup, h2, q2, kc2, vc2, new_kv2
    q, kc, vc, new_kv, _ = planted_attention(gen, b, heads, hkv, s_max, past,
                                             0, device)
    h0 = torch.zeros((b, 1, hidden), dtype=torch.bfloat16, device=device)
    tol = TOL["layer_tail_a8"]
    lost = torch.ones((b, s_max), dtype=torch.bool, device=device)
    lost[:, 256:512] = False
    ref = attn_block.attn_block_o_plain(h0, q, kc, vc, past, s_max, o, new_kv,
                                        None, "pallas_a8")
    require_fault_moves("layer_tail_a8 attn_block_o h=0 peaked", ref, {
        "in-flight row dropped": attn_block.attn_block_o_plain(
            h0, q, kc, vc, past, s_max, o, (-new_kv[0], new_kv[1]), None,
            "pallas_a8"),
        "split lost": attn_block.attn_block_o_plain(
            h0, q, kc, vc, past, s_max, o, new_kv, lost, "pallas_a8"),
    }, tol)
    args = (h0, q, kc, vc, past, s_max, o, new_kv, None, "pallas_a8")
    got = attn_block.attn_block_o(*args)
    err, rel = check_close("layer_tail_a8 attn_block_o h=0", got, ref, tol)
    record("layer_tail_a8", "a8 attn_block_o h=0 peaked B=1 past=2000", err,
           rel, lambda: attn_block.attn_block_o(*args),
           lambda: attn_block.attn_block_o_plain(*args), None,
           q4_bytes(nq, hidden, gs) + 2 * b * past * nkv * 2
           + 2 * b * hidden * 2 + b * nq * 2 + 2 * b * nkv * 2,
           4 * d * heads * b * (past + 1) + 2 * b * nq * hidden, iters=10)
    del q, kc, vc, new_kv, o

    # ---- K10, K11: the int8 tensor-core prefill matmuls at M = 1919 (K10
    # on o and gate|up also at 33 and 127 rows), each K10 case beside exact
    # K2 on the same x and weight (separate_ms); the library yardsticks are
    # the bf16 product that also stands beside K2 and, for both, torch._int_mm
    # on the same int8 operands plus the rescale (K10: on its own
    # re-quantized bytes), where this torch has it
    shapes = {"qkv": (hidden, 12288), "o": (hidden, hidden),
              "gateup": (hidden, 2 * inter), "down": (inter, hidden)}
    for nm, (k, n) in shapes.items():
        qt = down if nm == "down" else random_qt(gen, k, n, gs, False, device)
        ws = w8_col_scale(qt)
        w = dequantize_t(qt)
        w8 = torch.round(w.float() * (1.0 / ws.clamp_min(1e-22)))
        qt10 = dataclasses.replace(       # K10's bytes as a K-major image
            qt, w8=w8.clamp_(-127, 127).to(torch.int8).t().contiguous(),
            w8_scale=ws)
        for m in ((33, 127, 1919) if nm in ("o", "gateup") else (1919,)):
            x = rnd(m, k)
            ops = 2 * m * k * n
            ref = quant.q4_prefill_a8_plain(x, qt, ws, f32)
            if nm == "o" and m == 1919:
                require_fault_moves(f"q4_prefill_a8 {nm}", ref, {
                    "even nibbles dropped": quant.q4_prefill_a8_plain(
                        x, no_even_nibbles(qt), ws, f32)},
                    TOL["q4_prefill_a8"])
            got = quant.q4_prefill_a8(x, qt, ws)
            err, rel = check_close(f"q4_prefill_a8 {nm} M={m}", got, ref,
                                   TOL["q4_prefill_a8"])
            record("q4_prefill_a8", f"{nm} g{gs} M={m}", err, rel,
                   lambda: quant.q4_prefill_a8(x, qt, ws),
                   lambda: quant.q4_prefill_a8_plain(x, qt, ws),
                   lambda: torch.matmul(x, w),
                   q4_bytes(k, n, gs) + n * 4 + m * k * 2 + m * n * 2, ops,
                   iters=8, peak=INT8_OP_PER_S,
                   s_fn=lambda: quant.q4_dequant_matmul(x, qt),
                   extra={"library_int8_ms": int_mm_library(x, qt10)})
        del w, w8, qt10
        if nm != "o":
            w8_cases(record, rnd, nm, qt, k, n,
                     (1919,) if nm == "down" else (33, 127, 1919))
        del qt
    # K11 at N off the 128-column tile (4168) and off a multiple of 8 (4100)
    for n in (4168, 4100):
        qt = random_qt(gen, hidden, n, gs, False, device)
        w8_cases(record, rnd, f"o+{n - hidden}", qt, hidden, n, (127, 1919))
        del qt

    # ---- K12: the down projection with the GLU prologue at 33, 127 and
    # 1919 rows, beside K2 alone on the formed activation (k2_ms) and K2
    # plus the plain silu(gate)*up it replaces (separate_ms). 1e-2, as K2;
    # up negated and a dropped silu must each move the plain output by
    # more than 3x that.
    w = dequantize_t(down)
    for m in (33, 127, 1919):
        x = rnd(m, 2 * inter)
        ref = quant.q4_matmul_glu_plain(x, down, inter, inter)
        if m == 1919:
            require_fault_moves("q4_matmul_glu down", ref, {
                "up negated": quant.q4_matmul_glu_plain(
                    torch.cat([x[:, :inter], -x[:, inter:]], dim=1), down,
                    inter, inter),
                "silu dropped": quant._q4_matmul_plain(
                    x[:, :inter] * x[:, inter:], down)},
                TOL["q4_matmul_glu"])
        got = quant.q4_matmul_glu(x, down, inter, inter)
        err, rel = check_close(f"q4_matmul_glu down M={m}", got, ref,
                               TOL["q4_matmul_glu"])
        act = quant.glu_silu_mul(x, inter, inter)
        record("q4_matmul_glu", f"down g{gs} M={m}", err, rel,
               lambda: quant.q4_matmul_glu(x, down, inter, inter),
               lambda: quant.q4_matmul_glu_plain(x, down, inter, inter),
               lambda: torch.matmul(quant.glu_silu_mul(x, inter, inter), w),
               q4_bytes(inter, hidden, gs) + m * 2 * inter * 2
               + m * hidden * 2, 2 * m * inter * hidden, iters=8,
               s_fn=lambda: quant.q4_dequant_matmul(
                   quant.glu_silu_mul(x, inter, inter), down),
               extra={"k2_ms": lambda: quant.q4_dequant_matmul(act, down)})


def w8_cases(record, rnd, nm, qt, k, n, ms):
    """K11 on qt's K-major image at M in ``ms``, held to 5e-3 against the
    plain version's unrounded f32 values, timed beside K10 on the same x and
    4-bit weight (separate_ms) and beside torch._int_mm + the rescale. At
    the largest M, first: the image's bytes read as [K, N] (the old layout)
    and each column read as its neighbour's must move the plain output by
    more than 3x the limit."""
    from exllama_tpu_torch.formats.gptq import with_w8
    from exllama_tpu_torch.ops import quant

    qt8 = with_w8(qt)
    for m in ms:
        x = rnd(m, k)
        ref = quant.w8_matmul_plain(x, qt8.w8, qt8.w8_scale, torch.float32)
        if m == max(ms):
            require_fault_moves(f"w8_matmul {nm}", ref, {
                "[K, N] read as [N, K]": quant.w8_matmul_plain(
                    x, qt8.w8.reshape(k, n).t(), qt8.w8_scale, torch.float32),
                "neighbour column": quant.w8_matmul_plain(
                    x, qt8.w8.roll(1, 0), qt8.w8_scale, torch.float32)},
                TOL["w8_matmul"])
        got = quant.w8_matmul(x, qt8)
        err, rel = check_close(f"w8_matmul {nm} M={m}", got, ref,
                               TOL["w8_matmul"])
        record("w8_matmul", f"{nm} M={m}", err, rel,
               lambda: quant.w8_matmul(x, qt8),
               lambda: quant.w8_matmul_plain(x, qt8.w8, qt8.w8_scale),
               int_mm_library(x, qt8),
               k * n + n * 4 + m * k * 2 + m * n * 2, 2 * m * k * n,
               iters=8, peak=INT8_OP_PER_S,
               s_fn=lambda: quant.q4_prefill_a8(x, qt, qt8.w8_scale))


def int_mm_library(x, qt8):
    """One-call yardstick of K11: torch._int_mm on the row-quantized x and
    the image, plus the rescale. None where this torch cannot run it."""
    from exllama_tpu_torch.ops import quant

    xq, sx = quant._quant_rows(x.float())
    xq = xq.to(torch.int8)
    w8_cm = qt8.w8.t()            # the K-major image: column-major [K, N]
    ws = qt8.w8_scale

    def lib():
        return (torch._int_mm(xq, w8_cm).float() * sx * ws).bfloat16()

    try:
        lib()
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError) as e:
        log(f"  torch._int_mm is not usable here ({str(e)[:80]}): no library "
            f"time for w8_matmul")
        return None
    return lib



# ------------------------------------------- phase 3: quantized KV caches

def quantized_cache(gen, kind, b, hkv, s_max, d, device, rows=None,
                    spread=True):
    """An int8 / int4 cache with its f32 scales, written by the plain
    update_kv_cache from bf16 rows [B, S, Hkv, D] (``rows``: a (K, V) pair;
    default N(0, 1)), each row scaled by a power of two in [1/4, 2] with
    ``spread``, so that the per-key scales differ by up to x8."""
    from exllama_tpu_torch.ops import attention

    dc = d // 2 if kind == "int4" else d
    kc = torch.zeros((b, hkv, s_max, dc), dtype=torch.int8, device=device)
    vc = torch.zeros_like(kc)
    ks = torch.zeros((b, hkv, s_max), dtype=torch.float32, device=device)
    vs = torch.zeros_like(ks)
    out = []
    for i in range(2):
        x = (torch.randn((b, s_max, hkv, d), generator=gen, device=device)
             if rows is None else rows[i].float())
        if spread:
            x = x * 2.0 ** torch.randint(-2, 2, (b, s_max, hkv, 1),
                                         generator=gen, device=device)
        out.append(x.bfloat16())
    attention.update_kv_cache(kc, vc, out[0], out[1], 0, ks, vs)
    return kc, vc, ks, vs


def dequantized(c, s, d):
    """The bf16 cache a quantized one stands for (the library yardstick's
    input)."""
    from exllama_tpu_torch.ops import attention

    raw = (attention.unpack_kv4(c, torch.float32) if c.shape[-1] != d
           else c.float())
    return (raw * s[..., None]).bfloat16()


def quantized_attention_reference(q, kc, vc, ks, vs, past, new_kv,
                                  fault=None):
    """Deferred decode attention (T = 1, no padding) over a quantized
    cache, written out in f32 independently of attend_plain, and the faults
    a kernel could make: "k_scale" / "v_scale" (one scale, the mean, for
    every key), "v_scale_on_l" (the V scale also in the softmax
    denominator), "halves" (the two halves of an int4 head swapped)."""
    b, _, h, d = q.shape
    hkv = kc.shape[1]
    g = h // hkv

    def raw(c):
        c = c[:, :, :past]
        if c.shape[-1] == d:
            return c.float()
        lo, hi = ((c & 15) - 8).float(), (c >> 4).float()
        return torch.cat([hi, lo] if fault == "halves" else [lo, hi], -1)

    def scales(s, flat):
        s = s[:, :, :past]
        return s.mean(-1, keepdim=True).expand_as(s) if flat else s

    k, v = raw(kc), raw(vc)
    ksc, vsc = scales(ks, fault == "k_scale"), scales(vs, fault == "v_scale")
    qf = q.float().reshape(b, hkv, g, d)
    sc = torch.einsum("bhgd,bhsd->bhgs", qf, k) * ksc[:, :, None]
    s_new = torch.einsum("bhgd,bhd->bhg", qf, new_kv[0][:, 0].float())
    sc = torch.cat([sc, s_new[..., None]], -1) / math.sqrt(d)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    pv, p_new = p[..., :-1] * vsc[:, :, None], p[..., -1:]
    l = (pv.sum(-1, keepdim=True) + p_new if fault == "v_scale_on_l"
         else p.sum(-1, keepdim=True))
    o = torch.einsum("bhgs,bhsd->bhgd", pv.bfloat16().float(), v)
    o = o + p_new * new_kv[1][:, 0].float()[:, :, None]
    return (o / l).reshape(b, 1, h, d).bfloat16()


def kv_cases(device, timer, res):
    """Hold K3, K7 and K8 over an int8 and an int4 KV cache against their
    plain versions at Llama-7B shapes, with kernel / plain / library / bound
    times, under the names <kernel>_<kind>."""
    from exllama_tpu_torch.ops import attention, attn_block
    from exllama_tpu_torch.ops.mlp import gemv_plain_of
    from exllama_tpu_torch.ops.rope import rope_tables, slice_tables

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    record = make_recorder(timer, res)
    hidden, inter, heads, d, s_max, gs = 4096, 11008, 32, 128, 2048, 128
    eps, past = 1e-6, 2000

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).bfloat16()

    def norm_w():
        return (torch.rand(hidden, generator=gen, device=device)
                + 0.5).bfloat16()

    def kv_bytes(kind, keys, hkv):
        """K and V rows of ``keys`` keys plus their two f32 scales."""
        return 2 * keys * hkv * (d // 2 if kind == "int4" else d) \
            + 2 * keys * hkv * 4

    o = random_qt(gen, heads * d, hidden, gs, False, device)
    gateup = random_qt(gen, hidden, 2 * inter, gs, False, device)
    down = random_qt(gen, inter, hidden, gs, False, device)
    qkv = random_qt(gen, hidden, 3 * heads * d, gs, False, device)
    iw, nw = norm_w(), norm_w()
    sin_t, cos_t = slice_tables(*rope_tables(s_max, d, device=device), past, 1)
    nq = nkv = heads * d
    nbytes_mlp = (q4_bytes(hidden, 2 * inter, gs) + q4_bytes(inter, hidden, gs)
                  + hidden * 2)

    for kind in KV_KINDS:
        # ---- the faults, on an independent reference: a peaked softmax
        # (q x4, planted keys) over rows whose scales differ by up to x8
        q, kcb, vcb, new_kv, _ = planted_attention(gen, 1, heads, heads, s_max,
                                                   past, 0, device)
        kc, vc, ks, vs = quantized_cache(
            gen, kind, 1, heads, s_max, d, device,
            rows=(kcb.transpose(1, 2), vcb.transpose(1, 2)))
        args = (q, kc, vc, ks, vs, past, new_kv)
        ref = quantized_attention_reference(*args)
        plain = attention.attend_plain(q, kc, vc, past, s_max, None, new_kv,
                                       ks, vs)
        check_close(f"attend_plain {kind} vs the f32 reference", plain, ref,
                    TOL["flash_attn"])
        names = {"k_scale": "per-key K scale dropped (their mean used)",
                 "v_scale": "per-key V scale dropped (their mean used)",
                 "v_scale_on_l": "V scale also applied to l"}
        if kind == "int4":
            names["halves"] = "int4 halves swapped"
        faulty = {nm: quantized_attention_reference(*args, fault=f)
                  for f, nm in names.items()}
        require_fault_moves(f"flash_attn_{kind} decode peaked", ref, faulty,
                            TOL["flash_attn"])
        # ... and at K7's scale: h = 0, so its output is o-proj(attention)
        h0 = torch.zeros((1, 1, hidden), dtype=torch.bfloat16, device=device)
        through_o = gemv_plain_of("auto")
        require_fault_moves(
            f"layer_tail_{kind} attn_block_o h=0 peaked",
            through_o(ref.reshape(1, -1), o),
            {nm: through_o(out.reshape(1, -1), o)
             for nm, out in faulty.items()}, TOL["layer_tail"])
        targs = (h0, q, kc, vc, past, s_max, o, new_kv, None, "auto", ks, vs)
        got = attn_block.attn_block_o(*targs)
        ref7 = attn_block.attn_block_o_plain(*targs)
        err, rel = check_close(f"layer_tail_{kind} attn_block_o h=0", got,
                               ref7, TOL["layer_tail"])
        record(f"layer_tail_{kind}",
               f"{kind} attn_block_o h=0 peaked B=1 past=2000", err, rel,
               lambda: attn_block.attn_block_o(*targs),
               lambda: attn_block.attn_block_o_plain(*targs), None,
               q4_bytes(nq, hidden, gs) + kv_bytes(kind, past, heads)
               + 2 * hidden * 2 + nq * 2 + 2 * nkv * 2,
               4 * d * heads * (past + 1) + 2 * nq * hidden, iters=10)
        got = attention.attend(q, kc, vc, past, s_max, None, new_kv, ks, vs)
        check_close(f"flash_attn_{kind} decode peaked", got, plain,
                    TOL["flash_attn"])

        # ---- K3 at the main path's shapes
        acases = [
            # label, B, T, Hkv, past, deferred, masked
            (f"{kind} decode past=2000", 1, 1, 32, past, True, False),
            (f"{kind} prefill T=1919 past=0", 1, 1919, 32, 0, False, False),
            (f"{kind} decode B=2 past=2000 gqa8 left-pad mask", 2, 1, 8, past,
             True, True),
        ]
        for label, b, t, hkv, pst, deferred, masked in acases:
            q = rnd(b, t, heads, d)
            kc, vc, ks, vs = quantized_cache(gen, kind, b, hkv, s_max, d,
                                             device)
            new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d)) if deferred \
                else None
            mask = None
            if masked:
                mask = torch.ones((b, s_max), dtype=torch.bool, device=device)
                mask[0, :17] = False
            aargs = (q, kc, vc, pst, s_max, mask, new_kv, ks, vs)
            got = attention.attend(*aargs)
            ref = attention.attend_plain(*aargs)
            err, rel = check_close(f"flash_attn_{kind} {label}", got, ref,
                                   TOL["flash_attn"])
            lim = [min(s_max, pst + ti + (0 if deferred else 1))
                   for ti in range(t)]
            vis = b * sum(li + (1 if deferred else 0) for li in lim)
            nbytes = (2 * q.numel() * 2 + kv_bytes(kind, b * max(lim), hkv)
                      + (2 * b * hkv * d * 2 if deferred else 0)
                      + (b * s_max if masked else 0))
            # library yardstick: SDPA over the dequantized bf16 cache
            pos = torch.arange(s_max, device=device)
            allow = pos[None, :] < (pst + torch.arange(t, device=device)[
                :, None] + (0 if deferred else 1))
            allow = allow[None].expand(b, t, s_max)
            if mask is not None:
                allow = allow & mask[:, None]
            allow, qh = allow[:, None], q.transpose(1, 2)
            kd, vd = dequantized(kc, ks, d), dequantized(vc, vs, d)

            def lib():
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, kd, vd, attn_mask=allow, enable_gqa=hkv != heads)

            record(f"flash_attn_{kind}", label, err, rel,
                   lambda: attention.attend(*aargs),
                   lambda: attention.attend_plain(*aargs), lib, nbytes,
                   4 * d * heads * vis, iters=10)
            del kd, vd

        # ---- K7 at the main path's shapes, exact and a8 builds
        h, q = rnd(1, 1, hidden), rnd(1, 1, heads, d)
        kc, vc, ks, vs = quantized_cache(gen, kind, 1, heads, s_max, d, device,
                                         spread=False)
        new_kv = (rnd(1, 1, heads, d), rnd(1, 1, heads, d))
        for entry in ("layer_tail", "layer_step"):
            for impl in ("auto", "pallas_a8"):
                if entry == "layer_tail":
                    targs = (h, q, kc, vc, past, s_max, o, nw, gateup, down,
                             eps, new_kv, None, impl, ks, vs)
                    k_fn = lambda: attn_block.layer_tail(*targs)  # noqa: E731
                    p_fn = lambda: attn_block.layer_tail_plain(*targs)  # noqa: E731
                else:
                    targs = (h, qkv, iw, sin_t, cos_t, kc, vc, past, s_max, o,
                             nw, gateup, down, eps, heads, heads, d, None,
                             impl, ks, vs)
                    k_fn = lambda: attn_block.layer_step(*targs)  # noqa: E731
                    p_fn = lambda: attn_block.layer_step_plain(*targs)  # noqa: E731
                got, ref = k_fn(), p_fn()
                if entry == "layer_step":
                    for i, nm in ((1, "k_row"), (2, "v_row")):
                        check_close(f"layer_step {kind} {nm}", got[i], ref[i],
                                    1e-2)
                    got, ref = got[0], ref[0]
                name = ("layer_tail_a8_" if impl == "pallas_a8"
                        else "layer_tail_") + kind
                tag = (f"{kind} " + ("a8 " if impl == "pallas_a8" else "")
                       + f"{entry} B=1 past=2000")
                err, rel = check_close(f"{name} {tag}", got, ref, TOL[name])
                nbytes = (q4_bytes(nq, hidden, gs)
                          + kv_bytes(kind, past, heads) + 2 * hidden * 2
                          + nbytes_mlp)
                flops = (4 * d * heads * (past + 1) + 2 * nq * hidden
                         + 2 * 3 * hidden * inter)
                if entry == "layer_step":
                    nbytes += (q4_bytes(hidden, nq + 2 * nkv, gs) + hidden * 2
                               + d * 8 + 2 * nkv * 2)
                    flops += 2 * hidden * (nq + 2 * nkv)
                else:
                    nbytes += nq * 2 + 2 * nkv * 2
                record(name, tag, err, rel, k_fn, p_fn, None, nbytes, flops,
                       iters=10)


def kv_commit_cases(device, timer, res):
    """K8 in each cache format, its cursor in device memory as the model
    passes it -- a [1] cursor shared by a B = 1 batch, and a [B] cursor of
    a B = 2 batch, one position a row -- and its rows in one staged [2, L,
    B, 1, Hkv, D] buffer: bytes and scales bit-equal to the plain writes
    (an all-zero row and half-way values among the rows of a quantized
    cache), timed beside an empty launch (the floor, ``floor_ms``)."""
    from exllama_tpu_torch.ops import attention

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    record = make_recorder(timer, res)
    n_layers, hkv, s_max, d = 32, 32, 2048, 128
    for kind in ("bf16", *KV_KINDS):
        name = "kv_commit" if kind == "bf16" else f"kv_commit_{kind}"
        for b, cursor in ((1, [1919]), (2, [1919, 1000])):
            if kind == "bf16":
                caches = [(torch.randn((b, hkv, s_max, d), generator=gen,
                                       device=device).bfloat16(),
                           torch.randn((b, hkv, s_max, d), generator=gen,
                                       device=device).bfloat16())
                          for _ in range(n_layers)]
                lists = [[c[0] for c in caches], [c[1] for c in caches],
                         None, None]
            else:
                caches = [quantized_cache(gen, kind, b, hkv, s_max, d, device)
                          for _ in range(n_layers)]
                lists = [[c[i] for c in caches] for i in range(4)]
            plain = [None if ts is None else [t.clone() for t in ts]
                     for ts in lists]
            rows = torch.randn((2, n_layers, b, 1, hkv, d), generator=gen,
                               device=device).bfloat16()
            if kind != "bf16":
                rows[0, 0, 0, 0, 0] = 0
                rows[0, 0, 0, 0, 1] = ((torch.arange(d, device=device) % 14
                                        - 7) + 0.5) * 0.5
                rows[0, 0, 0, 0, 1, 0] = 63.5 if kind == "int8" else 3.5
            past = torch.tensor(cursor, dtype=torch.int32, device=device)
            ptrs = attention.kv_ptr_array(*[ts for ts in lists
                                            if ts is not None])
            attention.kv_commit(lists[0], lists[1], rows[0], rows[1], past,
                                lists[2], lists[3], ptrs)
            attention.commit_kv_cache(
                plain[0], plain[1], rows[0], rows[1],
                cursor[0] if b == 1 else past, plain[2], plain[3],
                impl="xla")
            n_diff = sum(int((g != r).sum())
                         for gs_, rs_ in zip(lists, plain) if gs_ is not None
                         for g, r in zip(gs_, rs_))
            label = (("" if kind == "bf16" else f"{kind} ")
                     + f"L={n_layers} B={b} Hkv={hkv} "
                     + ("[1]" if b == 1 else "[B]") + " cursor")
            if n_diff:
                raise AssertionError(f"{name} {label}: {n_diff} bytes / "
                                     f"scales differ from the plain writes")
            if kind != "bf16" and not all(
                    (lists[2][0][i, :, p] > 0).all()
                    for i, p in enumerate(cursor)):
                raise AssertionError(f"{name} {label}: no scale written")
            # each bf16 row read once, each written row (and scale) once
            written = {"bf16": 2 * d, "int8": d + 4, "int4": d // 2 + 4}[kind]
            nbytes = 2 * n_layers * b * hkv * (2 * d + written) + 4 * b
            record(name, label, 0.0, 0.0,
                   lambda: attention.kv_commit(
                       lists[0], lists[1], rows[0], rows[1], past, lists[2],
                       lists[3], ptrs),
                   lambda: attention.commit_kv_cache(
                       lists[0], lists[1], rows[0], rows[1],
                       cursor[0] if b == 1 else past, lists[2], lists[3],
                       impl="xla"),
                   None, nbytes, 0,
                   extra={"floor_ms": lambda: attention.launch_floor(device)})
            del caches, lists, plain


# ------------------------------- phase 3: the tensor-core GEMV, new shapes

GEMV_MS = (2, 8, 16, 18, 32)        # rows of the 2..32-row routes' sweep
CROSSOVER_MS = (2, 4, 8, 16, 24, 32, 33, 48, 64)


def gemv_tc_cases(device, timer, res, crossover):
    """K1 (its Hopper kernel, csrc/q4_gemv_wg.cuh) and K9 (a8, a8x2: the
    tensor-core route) at 2..32 rows, at the four Llama-7B projections (qkv
    with the RMSNorm prologue), each against its plain version with kernel /
    plain / library / bound times, K1 bit-equal on a second call and timed
    beside its parent (``k1_parent``) and K2 at the same rows; then K1's
    edge and shape cases (``k1_cases``); and the K1-vs-K2 crossover: both
    kernels at M = 2..32, K2 alone at 33..64 (K1 takes at most 32 rows), on
    the qkv and down shapes, into ``crossover`` {shape: {M: {"q4_gemv": ms,
    "q4_dequant_matmul": ms}}}."""
    from exllama_tpu_torch.formats.gptq import dequantize_t
    from exllama_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    record = make_recorder(timer, res)
    eps, f32 = 1e-6, torch.float32
    shapes = [("qkv", 4096, 12288), ("o", 4096, 4096),
              ("gateup", 4096, 22016), ("down", 11008, 4096)]
    for nm, k, n in shapes:
        qt = random_qt(gen, k, n, 128, False, device)
        w = dequantize_t(qt)
        nw = ((torch.rand(k, generator=gen, device=device) + 0.5).bfloat16()
              if nm == "qkv" else None)
        for m in GEMV_MS:
            x = torch.randn((m, k), generator=gen, device=device).bfloat16()
            tag = f"{nm} g128 M={m}" + (" norm" if nw is not None else "")
            nbytes = (q4_bytes(k, n, 128) + m * k * 2 + m * n * 2
                      + (k * 2 if nw is not None else 0))
            got = quant.q4_gemv(x, qt, nw, eps)
            err, rel = check_close(f"q4_gemv {tag}", got,
                                   quant.q4_gemv_plain(x, qt, nw, eps),
                                   TOL["q4_gemv"])
            if not torch.equal(got, quant.q4_gemv(x, qt, nw, eps)):
                raise AssertionError(f"q4_gemv {tag}: two calls on the "
                                     f"same inputs differ")
            xn = x if nw is None else quant._prologue_plain(x, qt, nw, eps)
            record("q4_gemv", tag, err, rel,
                   lambda: quant.q4_gemv(x, qt, nw, eps),
                   lambda: quant.q4_gemv_plain(x, qt, nw, eps),
                   lambda: torch.matmul(x, w), nbytes, 2 * m * k * n,
                   iters=10, extra={
                       "parent_ms": lambda: k1_parent(x, qt, nw, eps),
                       "k2_ms": lambda: quant.q4_dequant_matmul(xn, qt)})
            r = res["q4_gemv"][-1]
            r["share"] = r["bound_ms"] / r["ms"]
            for two_pass in (False, True):
                mode = "a8x2" if two_pass else "a8"
                got = quant.q4_gemv_a8(x, qt, nw, eps, two_pass)
                ref = quant.q4_gemv_a8_plain(x, qt, nw, eps, two_pass, f32)
                err, rel = check_close(f"q4_gemv_a8 {mode} {tag}", got, ref,
                                       TOL["q4_gemv_a8"])
                record("q4_gemv_a8", f"{mode} {tag}", err, rel,
                       lambda: quant.q4_gemv_a8(x, qt, nw, eps, two_pass),
                       lambda: quant.q4_gemv_a8_plain(x, qt, nw, eps,
                                                      two_pass),
                       lambda: torch.matmul(x, w), nbytes, 2 * m * k * n,
                       iters=10)
        if nm in ("qkv", "down"):
            row = crossover.setdefault(f"{nm} {k}->{n} g128", {})
            for m in CROSSOVER_MS:
                x = torch.randn((m, k), generator=gen,
                                device=device).bfloat16()
                t = {"q4_dequant_matmul": timer(
                    lambda: quant.q4_dequant_matmul(x, qt), 10)}
                if m <= quant.GEMV_MAX_M:
                    t["q4_gemv"] = timer(lambda: quant.q4_gemv(x, qt), 10)
                row[m] = t
            log(f"  crossover {nm}: " + "; ".join(
                f"M={m} " + ", ".join(f"{kk} {v:.4f}" for kk, v in t.items())
                for m, t in row.items()))
        del w
    k1_cases(device, timer, res)
    log("  K1 against its parent (the mma.sync route), ms: " + "; ".join(
        f"{r['case']} {r['ms']:.4f} / parent {r['parent_ms']:.4f} / library "
        f"{r['library_ms']:.4f} / K2 "
        f"{'n/a' if r.get('k2_ms') is None else format(r['k2_ms'], '.4f')}"
        f" / bound {r['bound_ms']:.4f} (share {r['bound_ms'] / r['ms']:.1%})"
        for r in res["q4_gemv"] if r.get("parent_ms") is not None))


def k1_cases(device, timer, res):
    """K1's Hopper kernel at the edges of its row tiles (9, 17, 24, 25 rows
    on o), at g32 (gate|up), act-order (down), ragged N (130, 100, the
    4-bit lm_head's 32001) and the tp = 2 / 4 shards at 18 rows: each
    within 1e-2 of its plain version, bit-equal on a second call and timed
    beside its parent and the library call (the groupsizes 256 and K are
    groupsize_cases', f32 scales at 18 rows f32_scale_cases')."""
    from exllama_tpu_torch.formats.gptq import dequantize_t, tp_chunk
    from exllama_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    record = make_recorder(timer, res)
    eps = 1e-6
    cases = [(f"edge o g128 M={m}", m, 4096, 4096, 128, False, False)
             for m in (9, 17, 24, 25)]
    cases += [("gateup-g32 g32 M=18", 18, 4096, 22016, 32, False, True),
              ("down-actorder g128 M=18", 18, 11008, 4096, 128, True, False),
              ("N=130 g128 M=18", 18, 4096, 130, 128, False, True),
              ("N=100 g128 M=18", 18, 4096, 100, 128, False, False),
              ("lm_head 4096->32001 g128 M=18", 18, 4096, 32001, 128, False,
               True)]
    for tp in (2, 4):
        cases += [(f"tp{tp} {nm} {k}->{n} g128 M=18", 18, k, n, 128, False,
                   nm == "qkv")
                  for nm, k, n in (("qkv", 4096, 12288 // tp),
                                   ("o", 4096 // tp, 4096),
                                   ("gateup", 4096, 22016 // tp),
                                   ("down", tp_chunk(11008, tp, 128), 4096))]
    weights = {}
    kname = "q4_gemv"
    for label, m, k, n, gs, act, norm in cases:
        key = (k, n, gs, act)
        if key not in weights:
            weights.clear()
            qt = random_qt(gen, k, n, gs, act, device)
            weights[key] = (qt, dequantize_t(qt))
        qt, w = weights[key]
        x = torch.randn((m, k), generator=gen, device=device).bfloat16()
        nw = ((torch.rand(k, generator=gen, device=device) + 0.5).bfloat16()
              if norm else None)
        got = quant.q4_gemv(x, qt, nw, eps)
        err, rel = check_close(f"{kname} {label}", got,
                               quant.q4_gemv_plain(x, qt, nw, eps), TOL[kname])
        if not torch.equal(got, quant.q4_gemv(x, qt, nw, eps)):
            raise AssertionError(f"{kname} {label}: two calls on the same "
                                 f"inputs differ")
        record(kname, label + (" norm" if norm else ""), err, rel,
               lambda: quant.q4_gemv(x, qt, nw, eps),
               lambda: quant.q4_gemv_plain(x, qt, nw, eps),
               lambda: torch.matmul(x, w),
               q4_bytes(k, n, gs) + m * k * 2 + m * n * 2
               + (k * 2 if norm else 0) + (k * 4 if act else 0),
               2 * m * k * n, iters=10,
               extra={"parent_ms": lambda: k1_parent(x, qt, nw, eps)})
    weights.clear()


def groupsize_cases(device, timer, res):
    """K1, K9 (a8, a8x2), K2, K10 and K12 at groupsize 256 and at
    groupsize = K (one group a column), against their plain versions at
    Llama-7B shapes, each with its limit."""
    from exllama_tpu_torch.formats.gptq import dequantize_t, w8_col_scale
    from exllama_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    record = make_recorder(timer, res)
    eps, f32 = 1e-6, torch.float32
    for gs_name in ("256", "K"):
        # K1 / K9: the qkv projection with its norm, one row and 18
        k, n = 4096, 12288
        gs = k if gs_name == "K" else 256
        qt = random_qt(gen, k, n, gs, False, device)
        w = dequantize_t(qt)
        nw = (torch.rand(k, generator=gen, device=device) + 0.5).bfloat16()
        for m in (1, 18):
            x = torch.randn((m, k), generator=gen, device=device).bfloat16()
            tag = f"qkv g{gs} M={m} norm"
            nbytes = q4_bytes(k, n, gs) + m * k * 2 + m * n * 2 + k * 2
            err, rel = check_close(f"q4_gemv {tag}",
                                   quant.q4_gemv(x, qt, nw, eps),
                                   quant.q4_gemv_plain(x, qt, nw, eps),
                                   TOL["q4_gemv"])
            record("q4_gemv", tag, err, rel,
                   lambda: quant.q4_gemv(x, qt, nw, eps),
                   lambda: quant.q4_gemv_plain(x, qt, nw, eps),
                   lambda: torch.matmul(x, w), nbytes, 2 * m * k * n,
                   iters=10)
            for two_pass in (False, True):
                mode = "a8x2" if two_pass else "a8"
                err, rel = check_close(
                    f"q4_gemv_a8 {mode} {tag}",
                    quant.q4_gemv_a8(x, qt, nw, eps, two_pass),
                    quant.q4_gemv_a8_plain(x, qt, nw, eps, two_pass, f32),
                    TOL["q4_gemv_a8"])
                record("q4_gemv_a8", f"{mode} {tag}", err, rel,
                       lambda: quant.q4_gemv_a8(x, qt, nw, eps, two_pass),
                       lambda: quant.q4_gemv_a8_plain(x, qt, nw, eps,
                                                      two_pass),
                       lambda: torch.matmul(x, w), nbytes, 2 * m * k * n,
                       iters=10)
        del w
        m = 127
        # K2: gate|up
        k, n = 4096, 22016
        gs = k if gs_name == "K" else 256
        qt = random_qt(gen, k, n, gs, False, device)
        w = dequantize_t(qt)
        x = torch.randn((m, k), generator=gen, device=device).bfloat16()
        err, rel = check_close(f"q4_dequant_matmul gateup g{gs} M={m}",
                               quant.q4_dequant_matmul(x, qt),
                               quant._q4_matmul_plain(x, qt),
                               TOL["q4_dequant_matmul"])
        record("q4_dequant_matmul", f"gateup g{gs} M={m}", err, rel,
               lambda: quant.q4_dequant_matmul(x, qt),
               lambda: quant._q4_matmul_plain(x, qt),
               lambda: torch.matmul(x, w),
               q4_bytes(k, n, gs) + m * k * 2 + m * n * 2, 2 * m * k * n)
        del w
        # K10: the o-projection through int8
        k, n = 4096, 4096
        gs = k if gs_name == "K" else 256
        qt = random_qt(gen, k, n, gs, False, device)
        ws = w8_col_scale(qt)
        x = torch.randn((m, k), generator=gen, device=device).bfloat16()
        err, rel = check_close(f"q4_prefill_a8 o g{gs} M={m}",
                               quant.q4_prefill_a8(x, qt, ws),
                               quant.q4_prefill_a8_plain(x, qt, ws, f32),
                               TOL["q4_prefill_a8"])
        w = dequantize_t(qt)
        record("q4_prefill_a8", f"o g{gs} M={m}", err, rel,
               lambda: quant.q4_prefill_a8(x, qt, ws),
               lambda: quant.q4_prefill_a8_plain(x, qt, ws),
               lambda: torch.matmul(x, w),
               q4_bytes(k, n, gs) + n * 4 + m * k * 2 + m * n * 2,
               2 * m * k * n, peak=INT8_OP_PER_S)
        del w
        # K12: down over silu(gate)*up formed in the kernel
        ni, n = 11008, 4096
        gs = ni if gs_name == "K" else 256
        qt = random_qt(gen, ni, n, gs, False, device)
        w = dequantize_t(qt)
        x = torch.randn((m, 2 * ni), generator=gen, device=device).bfloat16()
        err, rel = check_close(f"q4_matmul_glu down g{gs} M={m}",
                               quant.q4_matmul_glu(x, qt, ni, ni),
                               quant.q4_matmul_glu_plain(x, qt, ni, ni),
                               TOL["q4_matmul_glu"])
        record("q4_matmul_glu", f"down g{gs} M={m}", err, rel,
               lambda: quant.q4_matmul_glu(x, qt, ni, ni),
               lambda: quant.q4_matmul_glu_plain(x, qt, ni, ni),
               lambda: torch.matmul(quant.glu_silu_mul(x, ni, ni), w),
               q4_bytes(ni, n, gs) + m * 2 * ni * 2 + m * n * 2,
               2 * m * ni * n)
        del w


def head_dim_cases(device, timer, res):
    """K3 at head_dim 256 (16 heads of 256 at 7B width): split-KV decode
    at past 2000 (and B = 2 with GQA 4:1) and the prefill tiles at T =
    1919, over bf16, int8 and int4 caches, each against its plain version
    (2e-2) with kernel / plain / SDPA / bound times; then head_dim 100
    (OpenLlama-3B: 32 heads of 100), which attn_impl "auto" routes to the
    einsum attention: its counter moves and K3's does not. Returns the
    route's launches."""
    from exllama_tpu_torch.ops import attention

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    record = make_recorder(timer, res)
    d, h, s_max = 256, 16, 2048
    cases = [("decode past=2000", 1, 1, 16, 2000, 2048, True),
             ("decode B=2 past=2000 gqa4", 2, 1, 4, 2000, 2048, True),
             ("prefill T=1919 past=0", 1, 1919, 16, 0, 2048, False)]
    for kind in ("bf16",) + KV_KINDS:
        kname = "flash_attn" if kind == "bf16" else f"flash_attn_{kind}"
        for label, b, t, hkv, past, alen, deferred in cases:
            q = torch.randn((b, t, h, d), generator=gen,
                            device=device).bfloat16()
            ks = vs = None
            if kind == "bf16":
                kc, vc = (torch.randn((b, hkv, s_max, d), generator=gen,
                                      device=device).bfloat16()
                          for _ in range(2))
                kd, vd = kc, vc
            else:
                kc, vc, ks, vs = quantized_cache(gen, kind, b, hkv, s_max, d,
                                                 device)
                kd, vd = dequantized(kc, ks, d), dequantized(vc, vs, d)
            new_kv = None
            if deferred:
                new_kv = tuple(torch.randn((b, 1, hkv, d), generator=gen,
                                           device=device).bfloat16()
                               for _ in range(2))
            args = (q, kc, vc, past, alen, None, new_kv, ks, vs)
            err, rel = check_close(f"{kname} D=256 {label}",
                                   attention.attend(*args),
                                   attention.attend_plain(*args),
                                   TOL[kname])
            keys = past + (0 if deferred else t)
            vis = b * sum(min(alen, past + ti + (0 if deferred else 1))
                          + (1 if deferred else 0) for ti in range(t))
            row_b = (d // 2 if kind == "int4" else d) * (
                2 if kind == "bf16" else 1) + (0 if kind == "bf16" else 4)
            nbytes = 2 * q.numel() * 2 + 2 * b * hkv * keys * row_b
            qh = q.transpose(1, 2)
            pos = torch.arange(alen, device=device)
            tpos = past + torch.arange(t, device=device)
            allow = (pos[None, :] < tpos[:, None] + (0 if deferred else 1))

            def lib():
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, kd[:, :, :alen], vd[:, :, :alen], attn_mask=allow,
                    enable_gqa=hkv != h)

            record(kname, f"D=256 {label}", err, rel,
                   lambda: attention.attend(*args),
                   lambda: attention.attend_plain(*args), lib, nbytes,
                   4 * d * h * vis, iters=10)
    # head_dim 100: the einsum route, on its own counter
    d, h, hkv = 100, 32, 32
    if attention.resolve_attn_impl("auto", d) != "xla":
        raise AssertionError("head_dim 100 must take the einsum route")
    fn = attention.attend_xla
    before = (attention.attend_xla.launches, attention.attend.launches)
    q = torch.randn((1, 1, h, d), generator=gen, device=device).bfloat16()
    kc, vc = (torch.randn((1, hkv, 512, d), generator=gen,
                          device=device).bfloat16() for _ in range(2))
    new_kv = tuple(torch.randn((1, 1, hkv, d), generator=gen,
                               device=device).bfloat16() for _ in range(2))
    got = fn(q, kc, vc, 300, 512, None, new_kv)
    ref = attention.attend_plain(q, kc, vc, 300, 512, None, new_kv)
    check_close("attend_xla D=100 vs attend_plain", got, ref,
                TOL["flash_attn"])
    moved = (attention.attend_xla.launches - before[0],
             attention.attend.launches - before[1])
    if moved != (1, 0):
        raise AssertionError(f"head_dim 100 route launches {moved}")
    log(f"  attend_xla D=100 (OpenLlama-3B heads): the einsum route, "
        f"counter +{moved[0]}, K3 +{moved[1]}")
    return moved[0]


def with_f32_scales(qt, gen):
    """qt with f32 scales carrying bits below bf16's (the bf16 values
    times 1 + u, |u| < 2^-9), zscale likewise: what scale_dtype="f32"
    stores; the plain versions read the same f32 values."""
    def widen(t):
        u = (torch.rand(t.shape, generator=gen, device=t.device) - 0.5)
        return t.float() * (1.0 + u * 2.0 ** -8)
    return dataclasses.replace(qt, scales=widen(qt.scales),
                               zscale=widen(qt.zscale))


def f32_scale_cases(device, timer, res):
    """The f32-scale builds (-DSCALE_F32=1, scale_dtype="f32") of K1, K2,
    K6, K7, K9, K10 and K12 at the Llama-7B shapes of the bf16 cases, each
    against its plain version on the same f32 scales at its bf16 build's
    limit, each timed beside its bf16 build on the same weights with the
    scales rounded to bf16 (bf16_ms); each launch counts on
    ``launches_f32``, never on ``launches``. Then K1 and K2 on a 4-bit
    lm_head (quantize_lm_head): 4096 -> 32000 and 32001 (an odd vocab: the
    kernels' plain loads) at M = 1 and 2047."""
    from exllama_tpu_torch.formats.gptq import dequantize_t, w8_col_scale
    from exllama_tpu_torch.ops import attn_block, mlp, quant

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    record = make_recorder(timer, res)
    hidden, inter, heads, d, s_max, gs = 4096, 11008, 32, 128, 2048, 128
    eps = 1e-6
    f32 = torch.float32

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).bfloat16()

    def norm_w():
        return (torch.rand(hidden, generator=gen, device=device)
                + 0.5).bfloat16()

    def pair(k, n):
        """(f32-scale tensor, the same with bf16-rounded scales)."""
        q32 = with_f32_scales(random_qt(gen, k, n, gs, False, device), gen)
        return q32, dataclasses.replace(q32, scales=q32.scales.bfloat16(),
                                        zscale=q32.zscale.bfloat16())

    def counted(fn, kernel, f):
        """Call fn once: exactly one launch on fn's launches_f32 and none
        on its launches."""
        before = (f.launches, f.launches_f32)
        out = fn()
        if (f.launches, f.launches_f32) != (before[0], before[1] + 1):
            raise AssertionError(f"{kernel}: launch counts {before} -> "
                                 f"{(f.launches, f.launches_f32)}")
        return out

    # K1 and K9 (a8 / a8x2) on qkv with the norm
    qt, qb = pair(hidden, 12288)
    nw = norm_w()
    w = dequantize_t(qt)
    for m in (1, 18):
        x = rnd(m, hidden)
        nbytes = (q4_bytes(hidden, 12288, gs, 4) + hidden * 2 + m * hidden * 2
                  + m * 12288 * 2)
        got = counted(lambda: quant.q4_gemv(x, qt, nw, eps), "q4_gemv_f32",
                      quant.q4_gemv)
        err, rel = check_close(f"q4_gemv_f32 qkv M={m}", got,
                               quant.q4_gemv_plain(x, qt, nw, eps),
                               TOL["q4_gemv_f32"])
        record("q4_gemv_f32", f"qkv g{gs} M={m} norm", err, rel,
               lambda: quant.q4_gemv(x, qt, nw, eps),
               lambda: quant.q4_gemv_plain(x, qt, nw, eps),
               lambda: torch.matmul(x, w), nbytes, 2 * m * hidden * 12288,
               extra={"bf16_ms": lambda: quant.q4_gemv(x, qb, nw, eps)})
        if m != 1:
            continue
        x = with_outliers(gen, x, gs)
        for two_pass in (False, True):
            mode = "a8x2" if two_pass else "a8"
            got = counted(lambda: quant.q4_gemv_a8(x, qt, nw, eps, two_pass),
                          "q4_gemv_a8_f32", quant.q4_gemv_a8)
            err, rel = check_close(
                f"q4_gemv_a8_f32 {mode}", got,
                quant.q4_gemv_a8_plain(x, qt, nw, eps, two_pass, f32),
                TOL["q4_gemv_a8_f32"])
            record("q4_gemv_a8_f32", f"{mode} qkv g{gs} M=1 norm", err, rel,
                   lambda: quant.q4_gemv_a8(x, qt, nw, eps, two_pass),
                   lambda: quant.q4_gemv_a8_plain(x, qt, nw, eps, two_pass),
                   lambda: torch.matmul(x, w), nbytes,
                   2 * hidden * 12288,
                   extra={"bf16_ms": lambda: quant.q4_gemv_a8(
                       x, qb, nw, eps, two_pass)})
    del w, qt, qb

    # K2 on gate|up, K10 on o, K12 on down, at M = 1919
    for kernel, k, n in (("q4_dequant_matmul_f32", hidden, 2 * inter),
                         ("q4_prefill_a8_f32", hidden, hidden),
                         ("q4_matmul_glu_f32", inter, hidden)):
        qt, qb = pair(k, n)
        m = 1919
        if kernel == "q4_dequant_matmul_f32":
            x = rnd(m, k)
            k_fn = lambda: quant.q4_dequant_matmul(x, qt)  # noqa: E731
            b_fn = lambda: quant.q4_dequant_matmul(x, qb)  # noqa: E731
            p_fn = lambda: quant._q4_matmul_plain(x, qt)  # noqa: E731
            ref, f, peak = p_fn(), quant.q4_dequant_matmul, BF16_FLOP_PER_S
            nbytes = q4_bytes(k, n, gs, 4) + m * k * 2 + m * n * 2
        elif kernel == "q4_prefill_a8_f32":
            x = rnd(m, k)
            ws, wsb = w8_col_scale(qt), w8_col_scale(qb)
            k_fn = lambda: quant.q4_prefill_a8(x, qt, ws)  # noqa: E731
            b_fn = lambda: quant.q4_prefill_a8(x, qb, wsb)  # noqa: E731
            p_fn = lambda: quant.q4_prefill_a8_plain(x, qt, ws)  # noqa: E731
            ref = quant.q4_prefill_a8_plain(x, qt, ws, f32)
            f, peak = quant.q4_prefill_a8, INT8_OP_PER_S
            nbytes = q4_bytes(k, n, gs, 4) + n * 4 + m * k * 2 + m * n * 2
        else:
            x = rnd(m, 2 * k)
            k_fn = lambda: quant.q4_matmul_glu(x, qt, k, k)  # noqa: E731
            b_fn = lambda: quant.q4_matmul_glu(x, qb, k, k)  # noqa: E731
            p_fn = lambda: quant.q4_matmul_glu_plain(x, qt, k, k)  # noqa: E731
            ref, f, peak = p_fn(), quant.q4_matmul_glu, BF16_FLOP_PER_S
            nbytes = q4_bytes(k, n, gs, 4) + m * 2 * k * 2 + m * n * 2
        got = counted(k_fn, kernel, f)
        err, rel = check_close(f"{kernel} M={m}", got, ref, TOL[kernel])
        w = dequantize_t(qt)
        xw = quant.glu_silu_mul(x, k, k) if x.shape[1] != k else x
        record(kernel, f"{k}->{n} g{gs} M={m}", err, rel, k_fn, p_fn,
               lambda: torch.matmul(xw, w), nbytes, 2 * m * k * n, iters=8,
               peak=peak, extra={"bf16_ms": b_fn})
        del w, qt, qb

    # K6 at M = 1 and 18, K7's layer tail at B = 1, past 2000
    gateup, gub = pair(hidden, 2 * inter)
    down, dnb = pair(inter, hidden)
    nw = norm_w()
    nbytes_mlp = (q4_bytes(hidden, 2 * inter, gs, 4)
                  + q4_bytes(inter, hidden, gs, 4) + hidden * 2)
    for m in (1, 18):
        h = rnd(m, 1, hidden)
        got = counted(lambda: mlp.q4_mlp(h, nw, gateup, down, eps),
                      "q4_mlp_f32", mlp.q4_mlp)
        err, rel = check_close(f"q4_mlp_f32 M={m}", got,
                               mlp.q4_mlp_plain(h, nw, gateup, down, eps),
                               TOL["q4_mlp_f32"])
        record("q4_mlp_f32", f"g{gs} M={m}", err, rel,
               lambda: mlp.q4_mlp(h, nw, gateup, down, eps),
               lambda: mlp.q4_mlp_plain(h, nw, gateup, down, eps), None,
               nbytes_mlp + 2 * m * hidden * 2, 2 * m * 3 * hidden * inter,
               extra={"bf16_ms": lambda: mlp.q4_mlp(h, nw, gub, dnb, eps)})
    o, ob = pair(heads * d, hidden)
    b, hkv, past = 1, 32, 2000
    h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
    kc, vc = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d)
    new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
    args = (h, q, kc, vc, past, s_max, o, nw, gateup, down, eps, new_kv)
    argb = (h, q, kc, vc, past, s_max, ob, nw, gub, dnb, eps, new_kv)
    got = counted(lambda: attn_block.layer_tail(*args), "layer_tail_f32",
                  attn_block.layer_tail)
    err, rel = check_close("layer_tail_f32", got,
                           attn_block.layer_tail_plain(*args),
                           TOL["layer_tail_f32"])
    nq = nkv = heads * d
    record("layer_tail_f32", f"layer_tail B=1 past={past}", err, rel,
           lambda: attn_block.layer_tail(*args),
           lambda: attn_block.layer_tail_plain(*args), None,
           q4_bytes(nq, hidden, gs, 4) + 2 * past * nkv * 2
           + 2 * hidden * 2 + nq * 2 + 2 * nkv * 2 + nbytes_mlp,
           4 * d * heads * (past + 1) + 2 * nq * hidden
           + 2 * 3 * hidden * inter, iters=10,
           extra={"bf16_ms": lambda: attn_block.layer_tail(*argb)})
    del gateup, gub, down, dnb, o, ob, kc, vc

    # K1 / K2 on a 4-bit lm_head (bf16 scales, as the default scale dtype
    # stores it), an even and an odd vocab
    for v in (32000, 32001):
        head = random_qt(gen, hidden, v, gs, False, device)
        w = dequantize_t(head)
        for m in (1, 2047):
            x = rnd(m, hidden)
            kernel = "q4_gemv" if m <= 32 else "q4_dequant_matmul"
            k_fn = ((lambda: quant.q4_gemv(x, head)) if m <= 32 else
                    (lambda: quant.q4_dequant_matmul(x, head)))
            before = quant.q4_gemv.launches + quant.q4_dequant_matmul.launches
            got = quant.q4_matmul(x, head)
            if (quant.q4_gemv.launches + quant.q4_dequant_matmul.launches
                    != before + 1):
                raise AssertionError(f"lm_head V={v} M={m}: no kernel launch")
            err, rel = check_close(f"{kernel} lm_head V={v} M={m}", got,
                                   quant._q4_matmul_plain(x, head),
                                   TOL[kernel])
            record(kernel, f"lm_head 4096->{v} g{gs} M={m}", err, rel, k_fn,
                   lambda: quant._q4_matmul_plain(x, head),
                   lambda: torch.matmul(x, w),
                   q4_bytes(hidden, v, gs) + m * hidden * 2 + m * v * 2,
                   2 * m * hidden * v, iters=8)
        del head, w


# --------------------------------------------------------------- phase 4

# the CPU references' lengths (each CPU forward dequantizes every weight of
# the 2-layer full-width model, ~3-4 s on the chip machine's 8 threads):
# decode steps of the two configurations, decode steps of the shape and
# knob models, tokens of the generator features (8, 4 and 8 until phase 14
# took the time)
PHASE4_STEPS, PHASE4_MODEL_STEPS, PHASE4_TOKENS = 4, 2, 4


def model_vs_cpu(device):
    """2 layers at full 7B width, one seed, on the card in the default
    configuration and with fuse_qkv + the K8 commit, against the CPU's
    plain forward, run once (the knobs choose how the card computes the
    function, not the function). Returns the worst logit difference over
    the logit scale."""
    import exllama_tpu_torch as port
    from exllama_tpu_torch.models.llama import forward_chunk

    cfg = port.ExLlamaConfig()
    cfg.num_hidden_layers = 2
    cfg.max_seq_len = 128
    cpu_params = port.make_synthetic_params(cfg, 128, False, seed=1,
                                            device="cpu", fast=True)
    cpu_model = port.ExLlama(cfg, params=cpu_params, device="cpu")
    gpu_model = port.ExLlama(cfg, params=cpu_params.to(device), device=device)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, size=(1, 64)).astype(np.int32)
    steps = [ids] + [rng.integers(0, cfg.vocab_size, size=(1, 1)).astype(
        np.int32) for _ in range(PHASE4_STEPS)]
    c_cpu = port.ExLlamaCache(cpu_model)
    refs = [cpu_model.forward(tok, c_cpu, last_id_only=i > 0)
            for i, tok in enumerate(steps)]
    worst = 0.0
    for qkv_fuse, commit in ((False, "auto"), (True, "pallas")):
        cfg.tuning.fuse_qkv = qkv_fuse
        cfg.tuning.commit_impl = commit
        c_gpu = port.ExLlamaCache(gpu_model)
        # 3% of the logit scale: the kernels round at other places than the
        # CPU plain path (see tests/test_torch_model.py for the JAX package's
        # own 2.1% spread between its two paths)
        for i, (tok, ref) in enumerate(zip(steps, refs)):
            got = gpu_model.forward(tok, c_gpu, last_id_only=i > 0).cpu()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if not torch.isfinite(got).all() or rel > 0.03:
                raise AssertionError(
                    f"fuse_qkv={qkv_fuse} commit={commit} step {i}: card vs "
                    f"CPU logits rel {rel:.4f}")
            worst = max(worst, rel)
        # the greedy head (K5) on the card against the CPU logits of the
        # same state (the last step's): its token's logit is within the
        # same 3% of the max
        tok = torch.as_tensor(steps[-1], device=device)
        kw = dict(attend_len=cfg.max_seq_len, last_token_only=True,
                  preprocess_only=False, heads=cfg.num_attention_heads,
                  kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
                  eps=cfg.rms_norm_eps, qkv_fuse=qkv_fuse, commit_impl=commit)
        c_gpu.current_seq_len -= 1
        pick = forward_chunk(gpu_model.params, c_gpu, tok,
                             c_gpu.current_seq_len, None, head_mode="argmax",
                             **kw).cpu()
        ref = refs[-1][0, -1]
        gap = (ref.max() - ref[pick.reshape(-1)[0].long()]).item()
        if gap > 0.03 * ref.abs().max().item():
            raise AssertionError(f"greedy head: token logit {gap:.3g} below "
                                 f"the CPU max")
    cfg.tuning.fuse_qkv = False
    cfg.tuning.commit_impl = "auto"
    features = generator_vs_cpu(cpu_model, gpu_model, ids[:, :24])
    return (worst,
            turbo_model_vs_cpu(cfg, cpu_params, steps[:5], refs[:5], device),
            kv_model_vs_cpu(cfg, cpu_model, gpu_model, steps[:3]), features)


def _generator(model, batch=1, **settings):
    import exllama_tpu_torch as port

    g = port.ExLlamaGenerator(
        model, port.FakeTokenizer(), port.ExLlamaCache(model, batch_size=batch),
        seed=SEED)
    for k, v in settings.items():
        setattr(g.settings, k, v)
    return g


def _penalized(logits, g):
    """Row 0 of the generator's penalized, BOS-banned logits."""
    from exllama_tpu_torch.ops.sampling import apply_rep_penalty

    s = g.settings
    row = apply_rep_penalty(logits, g._seq_buf, g.sequence.shape[1],
                            s.token_repetition_penalty_max,
                            s.token_repetition_penalty_sustain,
                            s.token_repetition_penalty_decay)[0]
    row[g.tokenizer.bos_token_id] -= 10000.0
    return row


def forced_gaps(model, ids, toks, score=_penalized, mask=None, rank=1):
    """Teacher-forced on ``model`` after ``ids`` (each token of ``toks``
    appended to every row in turn): how far each lies below the rank-th
    best of ``score(logits, generator)``, over the raw logits' scale."""
    g = _generator(model, batch=ids.shape[0])
    g.gen_begin(ids, mask=mask)
    gaps = []
    for t in toks:
        logits = model.forward(g.sequence[:, -1:], g.cache,
                               input_mask=g._mask)[:, -1].float()
        row = score(logits, g)
        gaps.append(float(row.topk(rank).values[-1] - row[int(t)])
                    / float(logits.abs().max()))
        g.gen_accept_token(np.full((ids.shape[0], 1), t, np.int32))
        g._sync_seq_buf()
    return gaps


def generator_vs_cpu(cpu_model, gpu_model, ids):
    """Phase 4's generator features on the 2-layer full-width model, the
    card against the CPU: beam search at top-k 1 (beams 3, length 4,
    PHASE4_TOKENS tokens) equal to the card's own greedy tokens bit for bit and, on the
    CPU's teacher-forced logits, within 3% of the scale of its best; beam
    search with 3 beams alive (top-k 3, top-p off), each step at 3 rows
    launching K1 and K7 at B = 3 and K4 at M = 3, each committed token
    among the best 3 of the card's teacher-forced logits; generate_cfg (alpha 0.3, PHASE4_TOKENS tokens, top-k 1)
    within 3% of the CPU's best mixed log-softmax, K7 at B = 2 a step;
    gen_single_token(constraints=) in the set and within 3% of the CPU's
    constrained best."""
    out = {}
    bg = _generator(gpu_model, top_k=1, beams=3, beam_length=4)
    bg.gen_begin(ids)
    bg.begin_beam_search()
    beam = [int(bg.beam_search()[0, 0]) for _ in range(PHASE4_TOKENS)]
    bg.end_beam_search()
    gg = _generator(gpu_model, top_k=1)
    gg.gen_begin(ids)
    greedy_toks = [int(gg.gen_single_token()[0, 0])
                   for _ in range(PHASE4_TOKENS)]
    if beam != greedy_toks:
        raise AssertionError(f"phase 4 beams top-k 1 {beam} vs greedy "
                             f"{greedy_toks}")
    gaps = forced_gaps(cpu_model, ids, beam)
    if max(gaps) > 0.03:
        raise AssertionError(f"phase 4 beams top-k 1 vs CPU: gaps {gaps}")
    out["beams top-k 1"] = max(gaps)

    b3 = _generator(gpu_model, top_k=3, top_p=0.0, beams=3, beam_length=4)
    b3.gen_begin(ids)
    b3.begin_beam_search()
    steps, step = [], b3._beam_step

    def counted_step(n_out):
        rows, c0 = b3._beam_seqs.shape[0], counts()
        r = step(n_out)
        c1 = counts()
        steps.append((rows, {k: c1[k] - c0[k] for k in c1}))
        return r

    b3._beam_step = counted_step
    toks3 = [int(b3.beam_search()[0, 0]) for _ in range(PHASE4_TOKENS)]
    b3.end_beam_search()
    at3 = [c for rows, c in steps if rows == 3]
    if not at3:
        raise AssertionError(f"phase 4 beams: no step at 3 rows "
                             f"({[r for r, _ in steps]})")
    for c in at3:
        require("phase 4 beam step at B = 3", c,
                {"q4_gemv": 2, "layer_tail": 2, "dense_gemv": 1,
                 "flash_attn": 0})
    # each committed token among the 3 best of the card's teacher-forced
    # logits, the candidates the filter keeps (the card decides both)
    gaps = forced_gaps(gpu_model, ids, toks3, rank=3)
    if max(gaps) > 0.0:
        raise AssertionError(f"phase 4 beams top-k 3: gaps {gaps}")
    out["beams at B = 3"] = (max(gaps), len(at3), len(steps))

    from exllama_tpu_torch.tokenizer import FakeTokenizer

    prompts = ["a cheerful story about", "a sad and dull report on"]
    cg = _generator(gpu_model, batch=2, top_k=1)
    zero_counts()
    cg.generate_cfg(prompts, 0.3, PHASE4_TOKENS)
    c = counts()
    cids, cmask = FakeTokenizer().encode(prompts, return_mask=True)
    done = cg.sequence.shape[1] - cids.shape[1]
    n_steps = done + (done < PHASE4_TOKENS)
    require("phase 4 CFG", c, {"layer_tail": 2 * n_steps,
                               "dense_gemv": n_steps})
    full = np.zeros((2, cpu_model.config.max_seq_len), bool)
    full[:, :cids.shape[1]] = cmask

    def mixed(logits, g):
        from exllama_tpu_torch.ops.sampling import apply_rep_penalty

        s = g.settings
        lg = apply_rep_penalty(logits, g._seq_buf, g.sequence.shape[1],
                               s.token_repetition_penalty_max,
                               s.token_repetition_penalty_sustain,
                               s.token_repetition_penalty_decay)
        lp = torch.log_softmax(lg, dim=-1)
        return 0.7 * lp[0] + 0.3 * lp[1]

    gaps = forced_gaps(cpu_model, cids, cg.sequence[0, cids.shape[1]:],
                       score=mixed, mask=full)
    if gaps and max(gaps) > 0.03:
        raise AssertionError(f"phase 4 CFG vs CPU: gaps {gaps}")
    out["cfg"] = (max(gaps, default=0.0), done)

    allowed = [300, 301, 400, 500]
    got = []
    for model in (gpu_model, cpu_model):
        g = _generator(model, top_k=1)
        g.gen_begin(ids)
        got.append(int(g.gen_single_token(constraints=allowed)[0, 0]))

    def constrained(logits, g):
        return _penalized(logits, g) + g._logit_bias(allowed).to(logits.device)

    gap = forced_gaps(cpu_model, ids, got[:1], score=constrained)[0]
    if got[0] not in allowed or gap > 0.03:
        raise AssertionError(f"phase 4 constraints: card {got[0]}, CPU "
                             f"{got[1]}, gap {gap}")
    out["constraints"] = (got, gap)
    return out


# the groupsize and head dims the port now takes on the card: (label,
# ExLlamaConfig fields, groupsize). Full width, 2 layers: Llama-7B at
# groupsize 256; 16 heads of 256 at 7B width; OpenLlama-3B (hidden 3200, 32
# heads of 100, intermediate 8640, which groupsize 128 does not divide: 64)
SHAPE_MODELS = (
    ("groupsize 256", {}, 256),
    ("head_dim 256", dict(num_attention_heads=16, num_key_value_heads=16,
                          head_dim=256), 128),
    ("head_dim 100", dict(hidden_size=3200, intermediate_size=8640,
                          num_attention_heads=32, num_key_value_heads=32,
                          head_dim=100), 64),
)


def shapes_model_vs_cpu(device):
    """Phase 4's comparison (64-token prefill, then PHASE4_MODEL_STEPS
    teacher-forced decode steps, card vs CPU logits within 3% of the logit
    scale) for each of SHAPE_MODELS in the default configuration (attn_impl "auto"). Returns
    {label: (worst rel, {counter: launches})}: head_dim 100 must take the
    einsum route and never K3, head_dim 256 K3, groupsize 256 K1 and K2."""
    import exllama_tpu_torch as port
    from exllama_tpu_torch.ops import attention, quant

    out = {}
    rng = np.random.default_rng(SEED + 1)
    for label, fields, gs in SHAPE_MODELS:
        cfg = port.ExLlamaConfig()
        for k, v in fields.items():
            setattr(cfg, k, v)
        cfg.num_key_value_groups = (cfg.num_attention_heads
                                    // cfg.num_key_value_heads)
        cfg.num_hidden_layers = 2
        cfg.max_seq_len = 128
        cpu_params = port.make_synthetic_params(cfg, gs, False, seed=3,
                                                device="cpu", fast=True)
        cpu_model = port.ExLlama(cfg, params=cpu_params, device="cpu")
        gpu_model = port.ExLlama(cfg, params=cpu_params.to(device),
                                 device=device)
        ids = rng.integers(0, cfg.vocab_size, size=(1, 64)).astype(np.int32)
        steps = [ids] + [rng.integers(0, cfg.vocab_size, size=(1, 1)).astype(
            np.int32) for _ in range(PHASE4_MODEL_STEPS)]
        c_cpu, c_gpu = port.ExLlamaCache(cpu_model), port.ExLlamaCache(gpu_model)
        fns = {"flash_attn": attention.attend, "attend_xla":
               attention.attend_xla, "q4_gemv": quant.q4_gemv,
               "q4_dequant_matmul": quant.q4_dequant_matmul}
        before = {k: f.launches for k, f in fns.items()}
        worst = 0.0
        for i, tok in enumerate(steps):
            ref = cpu_model.forward(tok, c_cpu, last_id_only=i > 0)
            got = gpu_model.forward(tok, c_gpu, last_id_only=i > 0).cpu()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if not torch.isfinite(got).all() or rel > 0.03:
                raise AssertionError(f"{label} step {i}: card vs CPU logits "
                                     f"rel {rel:.4f}")
            worst = max(worst, rel)
        moved = {k: f.launches - before[k] for k, f in fns.items()}
        want = {"head_dim 100": {"attend_xla": None, "flash_attn": 0},
                "head_dim 256": {"flash_attn": None, "attend_xla": 0},
                "groupsize 256": {"q4_gemv": None,
                                  "q4_dequant_matmul": None}}[label]
        require(f"phase 4 {label}", moved, want)
        out[label] = (worst, moved)
        del cpu_model, gpu_model, cpu_params, c_cpu, c_gpu
    return out


# the knobs of scale dtype, lm_head and act-order fold: (label, tuning
# values, groupsize, act-order, vocab). Full 7B width, 2 layers: f32 scales;
# a 4-bit lm_head at an odd vocab (one added token); act-order with the
# down projection's gather kept (fold_act_order=False)
KNOB_MODELS = (
    ("scale_dtype f32", dict(scale_dtype="f32"), 128, False, 32000),
    ("quantize_lm_head V=32001", dict(quantize_lm_head=True), 128, False,
     32001),
    ("act-order unfolded", dict(fold_act_order=False), 128, True, 32000),
)


def centered(params):
    """Zero-mean weights: ``exllama_tpu_torch.parallel.worlds.centered``
    (zscale = 7.5 * scales; make_synthetic_params(fast) puts the zero-point
    at 8, and through two layers at 7B width that common mode grows the
    residual stream by two orders of magnitude and leaves some rows' logits
    ill-conditioned: on the act-order model below, 1e-3 of noise on the
    embeddings moves the CPU's own logits by 35% of their scale; centered,
    by 1.2%)."""
    from exllama_tpu_torch.parallel.worlds import centered as center

    return center(params)


def knob_models_vs_cpu(device):
    """Phase 4's comparison (64-token prefill, then PHASE4_MODEL_STEPS
    teacher-forced decode steps, card vs CPU logits within 3% of the logit
    scale) for each of KNOB_MODELS in the default configuration, on zero-mean weights
    (``centered``). Returns {label: (worst rel, {counter: launches})}: f32
    scales launch the f32-scale builds only, the 4-bit head K1 / K2 and
    never K4, the unfolded act-order layers K1 (the down projection's
    gather in its prologue) and never K6 / K7."""
    import exllama_tpu_torch as port

    counters = launch_counters()
    out = {}
    rng = np.random.default_rng(SEED + 2)
    for label, knobs, gs, act, vocab in KNOB_MODELS:
        cfg = port.ExLlamaConfig()
        cfg.num_hidden_layers = 2
        cfg.max_seq_len = 128
        cfg.vocab_size = vocab
        for k, v in knobs.items():
            setattr(cfg.tuning, k, v)
        cpu_params = centered(port.make_synthetic_params(
            cfg, gs, act, seed=5, device="cpu", fast=True))
        cpu_model = port.ExLlama(cfg, params=cpu_params, device="cpu")
        gpu_model = port.ExLlama(cfg, params=cpu_params.to(device),
                                 device=device)
        lp = gpu_model.params
        if act and lp.layers[0].down.x_map is None:
            raise AssertionError(f"{label}: the down projection was folded")
        ids = rng.integers(0, vocab, size=(1, 64)).astype(np.int32)
        steps = [ids] + [rng.integers(0, vocab, size=(1, 1)).astype(
            np.int32) for _ in range(PHASE4_MODEL_STEPS)]
        c_cpu, c_gpu = port.ExLlamaCache(cpu_model), port.ExLlamaCache(gpu_model)
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        worst = 0.0
        for i, tok in enumerate(steps):
            ref = cpu_model.forward(tok, c_cpu, last_id_only=i > 0)
            got = gpu_model.forward(tok, c_gpu, last_id_only=i > 0).cpu()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if (got.shape[-1] != vocab or not torch.isfinite(got).all()
                    or rel > 0.03):
                raise AssertionError(f"{label} step {i}: card vs CPU logits "
                                     f"rel {rel:.4f}, shape {got.shape}")
            worst = max(worst, rel)
        moved = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}
        want = {
            "scale_dtype f32": {"q4_gemv_f32": None,
                                "q4_dequant_matmul_f32": None,
                                "q4_gemv": 0, "q4_dequant_matmul": 0},
            "quantize_lm_head V=32001": {"q4_gemv": None,
                                         "q4_dequant_matmul": None,
                                         "dense_gemv": 0},
            "act-order unfolded": {"q4_gemv": None, "q4_mlp": 0,
                                   "layer_tail": 0},
        }[label]
        require(f"phase 4 {label}", moved, want)
        out[label] = (worst, {k: v for k, v in moved.items() if v})
        del cpu_model, gpu_model, cpu_params, c_cpu, c_gpu
    return out


# card vs CPU logits over the logit scale under a quantized cache: (prefill,
# decode), the bf16 cache's 3%. Each decode step starts from the CPU's cache
# bytes and scales, so it is held on its own arithmetic: a quantizer
# amplifies what came before it (two rows one bf16 step apart round to other
# integers, and an int4 integer is a seventh of a row's maximum). At this
# width the prefill chunk, written and attended in one call, stays inside
# the same limit (0.3% measured on an H100, int8 and int4).
KV_MODEL_TOL = {"int8": (0.03, 0.03), "int4": (0.03, 0.03)}


def kv_model_vs_cpu(cfg, cpu_model, gpu_model, steps):
    """The same 2-layer model under an int8 and an int4 KV cache, default
    configuration and fuse_qkv + K8 commit: prefill + 2 decode steps, card
    vs CPU (the CPU's logits and cache after each step computed once a
    cache type). Returns {kind: (worst prefill, worst decode)}."""
    import exllama_tpu_torch as port

    worst = {}
    for kind, (lim_prefill, lim_decode) in KV_MODEL_TOL.items():
        cfg.tuning.kv_cache_dtype = kind
        worst[kind] = [0.0, 0.0]
        cfg.tuning.fuse_qkv = False
        cfg.tuning.commit_impl = "auto"
        c_cpu = port.ExLlamaCache(cpu_model)
        refs = []
        for i, tok in enumerate(steps):
            ref = cpu_model.forward(tok, c_cpu, last_id_only=i > 0)
            refs.append((ref, [[t.clone() for t in ts]
                               for ts in c_cpu._tensor_lists()]))
        for qkv_fuse, commit in ((False, "auto"), (True, "pallas")):
            cfg.tuning.fuse_qkv = qkv_fuse
            cfg.tuning.commit_impl = commit
            c_gpu = port.ExLlamaCache(gpu_model)
            assert c_gpu.k[0].dtype == torch.int8 and c_gpu.k_scale
            for i, (tok, (ref, state)) in enumerate(zip(steps, refs)):
                got = gpu_model.forward(tok, c_gpu, last_id_only=i > 0).cpu()
                rel = ((got - ref).abs().max() / ref.abs().max()).item()
                lim = lim_decode if i else lim_prefill
                if not torch.isfinite(got).all() or rel > lim:
                    raise AssertionError(
                        f"kv_cache_dtype={kind} fuse_qkv={qkv_fuse} "
                        f"commit={commit} step {i}: card vs CPU logits rel "
                        f"{rel:.4f} > {lim}")
                worst[kind][i > 0] = max(worst[kind][i > 0], rel)
                same = 0.0
                for dst, src in zip(c_gpu._tensor_lists(), state):
                    for t, a in zip(dst, src):
                        a = a.to(t.device)
                        same += (t == a).float().mean().item() / (4 * len(dst))
                        t.copy_(a)
                if same < 0.9:
                    raise AssertionError(
                        f"kv_cache_dtype={kind} step {i}: only {same:.3f} of "
                        f"the card's cache bytes and scales are the CPU's")
    cfg.tuning.kv_cache_dtype = "bf16"
    cfg.tuning.fuse_qkv = False
    cfg.tuning.commit_impl = "auto"
    return worst


# card vs CPU logits over the logit scale under the W4A8 modes. a8x2 is
# exact-grade (its quantization error is ~2^-14 of a group's maximum): the
# exact mode's 3%, against the exact mode's CPU reference. a8t quantizes
# every prefill activation to int8, so a bf16 step of difference between
# kernel and plain version can draw another int8 rounding downstream; at
# this depth it stays inside the same 3% (0.44% measured on an H100),
# against its own plain version on the CPU.
TURBO_MODEL_TOL = {"pallas_a8x2": 0.03, "pallas_a8t": 0.03}


def turbo_model_vs_cpu(cfg, cpu_params, steps, exact_refs, device):
    """The same 2-layer model under "pallas_a8x2" and "pallas_a8t" (int8
    images attached on both sides): prefill + 4 decode steps, card vs CPU
    (a8x2 against ``exact_refs``, the exact CPU logits of the same steps).
    Returns {impl: worst relative difference}."""
    import exllama_tpu_torch as port
    from exllama_tpu_torch.models.llama import _attach_prefill_w8

    worst = {}
    for impl, tol in TURBO_MODEL_TOL.items():
        cfg.tuning.matmul_impl = impl
        cfg.tuning.prefill_w8 = "on"
        params = cpu_params
        if impl == "pallas_a8t":
            params = _attach_prefill_w8(cpu_params, cfg)
        gpu_model = port.ExLlama(cfg, params=params.to(device), device=device)
        refs = exact_refs
        if impl == "pallas_a8t":
            assert gpu_model.params.layers[0].down.w8 is not None
            cpu_model = port.ExLlama(cfg, params=params, device="cpu")
            c_cpu = port.ExLlamaCache(cpu_model)
            refs = [cpu_model.forward(tok, c_cpu, last_id_only=i > 0)
                    for i, tok in enumerate(steps)]
        c_gpu = port.ExLlamaCache(gpu_model)
        worst[impl] = 0.0
        for i, (tok, ref) in enumerate(zip(steps, refs)):
            got = gpu_model.forward(tok, c_gpu, last_id_only=i > 0).cpu()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if not torch.isfinite(got).all() or rel > tol:
                raise AssertionError(f"matmul_impl={impl} step {i}: card vs "
                                     f"CPU logits rel {rel:.4f} > {tol}")
            worst[impl] = max(worst[impl], rel)
        del gpu_model, c_gpu
    cfg.tuning.matmul_impl = "auto"
    cfg.tuning.prefill_w8 = "auto"
    torch.cuda.empty_cache()
    return worst


# ----------------------------------------------------------- phases 5-7

def launch_counters():
    from exllama_tpu_torch.ops import attention, attn_block, dense, mlp, quant

    fns = {"q4_gemv": quant.q4_gemv,
           "q4_dequant_matmul": quant.q4_dequant_matmul,
           "flash_attn": attention.attend,
           "dense_gemv": dense.dense_gemv,
           "head_argmax": dense.head_argmax,
           "q4_mlp": mlp.q4_mlp,
           "layer_tail": attn_block.layer_tail,
           "kv_commit": attention.kv_commit,
           "q4_gemv_a8": quant.q4_gemv_a8,
           "q4_prefill_a8": quant.q4_prefill_a8,
           "w8_matmul": quant.w8_matmul,
           "q4_matmul_glu": quant.q4_matmul_glu,
           "q4_mlp_a8": mlp.q4_mlp_a8,
           "layer_tail_a8": attn_block.layer_tail_a8}
    out = {name: (fn, "launches") for name, fn in fns.items()}
    # launches over an int8 / int4 KV cache count apart from the bf16 ones
    for name in ("flash_attn", "layer_tail", "layer_tail_a8", "kv_commit"):
        for kind in KV_KINDS:
            out[f"{name}_{kind}"] = (fns[name], f"launches_{kind}")
    # and those of the f32-scale builds apart from both
    for name in F32_KERNELS + ("q4_mlp_a8", "layer_tail_a8"):
        out[f"{name}_f32"] = (fns[name], "launches_f32")
    return out


def zero_counts():
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def counts():
    return {k: getattr(fn, attr)
            for k, (fn, attr) in launch_counters().items()}


def since(c0):
    """The launches since ``c0 = counts()``."""
    return {k: v - c0[k] for k, v in counts().items()}


def require(name, got, want):
    """Fail unless every kernel in ``want`` launched the given number of
    times (None: at least once)."""
    bad = {k: got[k] for k, n in want.items()
           if (got[k] == 0 if n is None else got[k] != n)}
    if bad:
        raise AssertionError(f"{name}: launches {bad}, expected "
                             f"{ {k: want[k] for k in bad} }")


class MainPath:
    """The 32-layer Llama-7B-shape model and the request-1 prompt, shared by
    phases 5-7."""

    def __init__(self, device):
        import exllama_tpu_torch as port

        self.port = port
        self.cfg = cfg = port.ExLlamaConfig()   # Llama-7B (benchmark.py:43-45)
        cfg.max_seq_len = 2048
        t0 = time.time()
        params = port.make_synthetic_params(cfg, 128, False, seed=SEED,
                                            device=device, fast=True)
        self.model = port.ExLlama(cfg, params=params, device=device)
        self.cache = port.ExLlamaCache(self.model)
        self.tok = port.FakeTokenizer()
        self.gen = port.ExLlamaGenerator(self.model, self.tok, self.cache,
                                         seed=SEED)
        self.gen.disallow_tokens([self.tok.eos_token_id])  # fixed lengths
        torch.cuda.synchronize()
        log(f"  model: {cfg.num_hidden_layers} layers, "
            f"{self.model.num_params_bytes() / 2**30:.2f} GiB params, built "
            f"in {time.time() - t0:.1f} s")
        rng = np.random.default_rng(SEED)
        letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
        self.prompt = bytes(rng.choice(letters, 1919)).decode()
        self.ids = self.tok.encode(self.prompt)

    def set_tuning(self, **knobs):
        for k, v in knobs.items():
            setattr(self.cfg.tuning, k, v)

    def use_model(self, model, cache=None):
        """Serve from ``model`` (its configuration ``model.config``), with
        the cache in use or ``cache``."""
        self.model, self.cfg = model, model.config
        self.cache = self.cache if cache is None else cache
        self.gen = self.port.ExLlamaGenerator(model, self.tok, self.cache,
                                              seed=SEED)
        self.gen.disallow_tokens([self.tok.eos_token_id])

    def request1(self, label):
        """The 1919-token prompt + 128 tokens, then the same request split
        into its timed prefill and decode halves."""
        gen = self.gen
        t0 = time.time()
        text = gen.generate_simple(self.prompt, max_new_tokens=128)
        torch.cuda.synchronize()
        assert isinstance(text, str) and gen.sequence.shape == (1, 1919 + 128)
        log(f"  {label} request 1: 1919-token prompt + 128 tokens in "
            f"{time.time() - t0:.2f} s")
        c0 = counts()
        torch.cuda.synchronize()
        t0 = time.time()
        gen.gen_begin(self.ids)
        torch.cuda.synchronize()
        t_prefill = time.time() - t0
        c1 = counts()
        t0 = time.time()
        gen.gen_tokens(128)
        torch.cuda.synchronize()
        t_decode = time.time() - t0
        c2 = counts()
        n = self.ids.shape[1] - 1
        out = dict(per_prefill={k: c1[k] - c0[k] for k in c0},
                   per_decode_step={k: (c2[k] - c1[k]) / 128 for k in c0},
                   prompt_tps=n / t_prefill, decode_tps=128 / t_decode)
        log(f"  {label} prompt: {n} tokens in {t_prefill:.3f} s = "
            f"{out['prompt_tps']:.1f} tok/s; decode: 128 tokens in "
            f"{t_decode:.3f} s = {out['decode_tps']:.2f} tok/s")
        log(f"  {label} launches per decode step: {out['per_decode_step']}")
        log(f"  {label} launches per {n}-token prefill: {out['per_prefill']}")
        return out


def main_path(mp):
    """Phase 5: three requests in the default configuration."""
    port, gen, tok, model, cache = mp.port, mp.gen, mp.tok, mp.model, mp.cache
    torch.cuda.reset_peak_memory_stats()
    r1 = mp.request1("default")
    logits = model.forward(gen.sequence[:, -1:], cache)
    assert logits.shape == (1, 1, mp.cfg.vocab_size)
    assert torch.isfinite(logits).all()

    # request 2: a short prompt resets the cache (its 18-token prefill runs
    # the MLP as K6); a longer one reuses it
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

    # timed: request 2's 18-token prefill (K1 / K6 / K3 at M = 18) and a
    # decode step of request 3's B=2 batch (K1 and K7 at 2 rows), host
    # clock around synchronised work, min of 3
    ids2 = tok.encode("The quick brown fox")
    t_pre, t_dec = [], []
    for _ in range(3):
        c0 = counts()
        torch.cuda.synchronize()
        t0 = time.time()
        gen.gen_begin(ids2)
        torch.cuda.synchronize()
        t_pre.append(time.time() - t0)
        c1 = counts()
        t0 = time.time()
        gen2.gen_tokens(4)
        torch.cuda.synchronize()
        t_dec.append((time.time() - t0) / 4)
        c2 = counts()
        gen2.gen_rewind(4)
    n2 = ids2.shape[1] - 1
    r1["request2_prefill_ms"] = min(t_pre) * 1e3
    r1["request3_decode_step_ms"] = min(t_dec) * 1e3
    pre = {k: c1[k] - c0[k] for k in c0 if c1[k] - c0[k]}
    step = {k: (c2[k] - c1[k]) / 4 for k in c0 if c2[k] - c1[k]}
    log(f"  request 2: {n2}-token prefill in {r1['request2_prefill_ms']:.3f} "
        f"ms (launches {pre}); request 3: B=2 decode step in "
        f"{r1['request3_decode_step_ms']:.3f} ms (launches per step {step})")
    require("phase 5 request 2 prefill", pre, {
        "q4_gemv": 64, "q4_mlp": 32, "flash_attn": 32})
    require("phase 5 request 3 decode step", step, {
        "q4_gemv": 32, "layer_tail": 32})
    r1["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  max_memory_allocated {r1['peak_bytes'] / 2**30:.2f} GiB")

    # where the 1918-token prefill's device time goes: one prefill traced,
    # the kernels' totals against the host clock's fenced prefill
    gen.gen_begin(mp.ids)
    torch.cuda.synchronize()
    t0 = time.time()
    gen.gen_begin(mp.ids)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    top = kernel_times(lambda: gen.gen_begin(mp.ids), top=40) or []
    busy = sum(us for _, us in top) / 1e3
    k2 = sum(us for name, us in top if "q4_wgmma" in name) / 1e3
    k3 = sum(us for name, us in top if "prefill_kernel" in name) / 1e3
    r1["prefill_split"] = dict(wall_ms=wall_ms, device_ms=busy, k2_ms=k2,
                               k3_ms=k3, top=top[:6])
    log(f"  a {mp.ids.shape[1] - 1}-token prefill: {wall_ms:.1f} ms fenced; "
        f"traced, its kernels {busy:.1f} ms of device time, K2 {k2:.1f} ms "
        f"({k2 / max(busy, 1e-9):.1%}), K3 {k3:.1f} ms; the most: "
        + "; ".join(f"{us / 1e3:.2f} ms {name}" for name, us in top[:6]))
    return r1


def trace_step(step):
    """One call of ``step`` traced by torch.profiler on the card: (the
    device's kernel and memset launches by name, the device's idle share
    between the first launch's start and the last one's end), or (None,
    None) where three traces in a row show no device activity (a later
    profiler session in one process has come back empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):      # a trace may come back empty: take the next
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        names, spans = {}, []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
                spans.append((e.time_range.start, e.time_range.end))
        if spans:
            break
    else:
        return None, None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = max(b for _, b in spans) - spans[0][0]
    return names, dict(window_us=window, busy_us=busy,
                       idle_share=1.0 - busy / window if window else 0.0)


def greedy(mp, label, profile=False, **knobs):
    """Phase 6: bench.py's greedy decode -- the prompt prefilled, then 128
    tokens through forward_chunk(head_mode="argmax") at attend_len
    max_seq_len, each token fed back on the card without a host sync; with
    ``profile``, one more step traced by torch.profiler (its launches by
    kernel)."""
    from exllama_tpu_torch.models.llama import forward_chunk

    cfg, model, cache = mp.cfg, mp.model, mp.cache
    mp.gen.gen_begin(mp.ids)
    tok = torch.as_tensor(mp.ids[:, -1:], device=model.device)
    past = cache.current_seq_len
    kw = dict(attend_len=cfg.max_seq_len, last_token_only=True,
              preprocess_only=False, heads=cfg.num_attention_heads,
              kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
              eps=cfg.rms_norm_eps, head_mode="argmax", **knobs)
    c0 = counts()
    torch.cuda.synchronize()
    t0 = time.time()
    toks = []
    for i in range(128):
        tok = forward_chunk(model.params, cache, tok, past + i, None, **kw)
        toks.append(tok)
    t_host = time.time() - t0          # the host's enqueue time
    torch.cuda.synchronize()
    dt = time.time() - t0
    cache.current_seq_len = past + 128
    c1 = counts()
    toks = torch.cat(toks, dim=1).cpu()
    assert toks.shape == (1, 128) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    per_step = {k: (c1[k] - c0[k]) / 128 for k in c0}
    log(f"  greedy {label}: 128 tokens in {dt:.3f} s = {128 / dt:.2f} tok/s "
        f"(the host returned from its last call after {t_host:.3f} s); "
        f"launches per step {per_step}")
    out = dict(decode_tps=128 / dt, host_s=t_host, per_decode_step=per_step)
    if profile:
        traced, idle = trace_step(lambda: forward_chunk(
            model.params, cache, tok, past + 128, None, **kw))
        cache.current_seq_len = past + 129
        out["step_kernels"], out["step_idle"] = traced, idle
        log(f"  greedy {label}: one eager step traced by torch.profiler: "
            + ("no device activity in the trace (not measured)"
               if traced is None else
               f"{sum(traced.values())} device launches, device idle "
               f"{idle['idle_share']:.1%} of {idle['window_us']:.1f} us: "
               f"{traced}"))
    return out


def turbo_path(mp, exact, launches):
    """Phase 8: request 1 under each opt-in matmul mode on the 32-layer
    model, launch counts zeroed before and required after each, and the
    18-token request 2 under "pallas_a8". ``exact`` is phase 5's result."""
    port, cfg = mp.port, mp.cfg
    base = mp.model
    n_layers = cfg.num_hidden_layers
    out = {}

    def run(label, want_prefill, want_step):
        zero_counts()
        r = mp.request1(label)
        c = counts()
        require(f"phase 8 {label} prefill", r["per_prefill"], want_prefill)
        require(f"phase 8 {label} decode step", r["per_decode_step"],
                want_step)
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
        out[label] = r
        return r

    a8_step = {"q4_gemv_a8": n_layers, "layer_tail_a8": n_layers,
               "dense_gemv": 1, "q4_gemv": 0, "layer_tail": 0}

    # (a) turbo prefill against the resident int8 image
    mp.set_tuning(matmul_impl="pallas_a8t", prefill_w8="auto")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    turbo = port.ExLlama(cfg, params=base.params, device=base.device)
    torch.cuda.synchronize()
    image = turbo.w8_image_bytes()
    want = sum(qt.in_features * qt.out_features + 4 * qt.out_features
               for lp in turbo.params.layers
               for qt in (lp.qkv, lp.gateup, lp.down)) + sum(
        4 * lp.o.out_features for lp in turbo.params.layers)
    assert image == want, (image, want)
    assert all(lp.o.w8 is None and lp.down.w8 is not None
               for lp in turbo.params.layers)
    log(f"  int8 image: {image} bytes ({image / 2**30:.2f} GiB) attached in "
        f"{time.time() - t0:.1f} s")
    mp.use_model(turbo)
    run("a8t+image",
        {"w8_matmul": 3 * n_layers, "q4_prefill_a8": n_layers,
         "flash_attn": n_layers, "q4_dequant_matmul": 0}, a8_step)
    out["a8t+image"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["a8t+image"]["image_bytes"] = image
    log(f"  a8t+image max_memory_allocated "
        f"{out['a8t+image']['peak_bytes'] / 2**30:.2f} GiB")
    mp.use_model(base)
    del turbo
    torch.cuda.empty_cache()

    # (b) a8x2: K9 with the residual pass at decode, prefill on the exact K2
    mp.set_tuning(matmul_impl="pallas_a8x2")
    run("a8x2", {"q4_dequant_matmul": 4 * n_layers, "flash_attn": n_layers,
                 "w8_matmul": 0, "q4_prefill_a8": 0}, a8_step)

    # phase 6's card-bound greedy path (fuse_qkv + the K8 commit: one K7
    # launch a layer) in the a8 arithmetic, where the kernels' own times
    # show end to end
    for impl in ("pallas_a8", "pallas_a8x2"):
        mp.set_tuning(matmul_impl=impl)
        zero_counts()
        label = f"fuse_qkv, commit_impl=pallas, {impl}"
        out[label] = g = greedy(mp, label, qkv_fuse=True, commit_impl="pallas",
                                matmul_impl=impl)
        require(f"phase 8 greedy {impl}", g["per_decode_step"], {
            "layer_tail_a8": n_layers, "head_argmax": 1, "kv_commit": 1,
            "q4_gemv_a8": 0, "layer_tail": 0, "q4_gemv": 0})
        for k, v in counts().items():
            launches[k] = launches.get(k, 0) + v

    # (c) turbo prefill without images: every matmul re-quantizes its tile
    # (and, with prefill_w8="off", reduces its column scales per call)
    mp.set_tuning(matmul_impl="pallas_a8t", prefill_w8="off")
    run("a8t, prefill_w8=off",
        {"q4_prefill_a8": 4 * n_layers, "w8_matmul": 0,
         "q4_dequant_matmul": 0, "flash_attn": n_layers}, a8_step)

    # (d) the exact mode with the GLU prologue in the down projection
    mp.set_tuning(matmul_impl="auto", prefill_w8="auto")
    os.environ["EXL_GLU_FUSE"] = "1"
    try:
        run("exact, EXL_GLU_FUSE=1",
            {"q4_matmul_glu": n_layers, "q4_dequant_matmul": 3 * n_layers,
             "flash_attn": n_layers},
            {"q4_gemv": n_layers, "layer_tail": n_layers, "dense_gemv": 1,
             "q4_matmul_glu": 0})
    finally:
        del os.environ["EXL_GLU_FUSE"]

    # request 2 under "pallas_a8": its 18-token prefill runs the MLP as K6
    # and the projections as K9, all in the a8 arithmetic
    mp.set_tuning(matmul_impl="pallas_a8")
    zero_counts()
    text = mp.gen.generate_simple("The quick brown fox", max_new_tokens=16)
    assert isinstance(text, str) and mp.cache.current_seq_len == 19 + 16 - 1
    c = counts()
    require("phase 8 request 2 under pallas_a8", c, {
        "q4_mlp_a8": n_layers, "q4_gemv_a8": None, "layer_tail_a8": None,
        "q4_mlp": 0, "q4_gemv": 0, "layer_tail": 0})
    for k, v in c.items():
        launches[k] = launches.get(k, 0) + v
    log(f"  request 2 under pallas_a8: launches {c}")
    mp.set_tuning(matmul_impl="auto")

    # the generator's decode is host-bound and its rate moves between two
    # runs of the same kernels, so the decode modes are also timed in turns
    # (exact, a8, a8x2, three rounds) after the same prefill
    rates = {"auto": [], "pallas_a8": [], "pallas_a8x2": []}
    zero_counts()
    for _ in range(3):
        for impl, got in rates.items():
            mp.set_tuning(matmul_impl=impl)
            mp.gen.gen_begin(mp.ids)
            torch.cuda.synchronize()
            t0 = time.time()
            mp.gen.gen_tokens(128)
            torch.cuda.synchronize()
            got.append(128 / (time.time() - t0))
    mp.set_tuning(matmul_impl="auto")
    c = counts()
    require("phase 8 decode in turns", c, {
        "q4_gemv": 3 * 128 * n_layers, "layer_tail": 3 * 128 * n_layers,
        "q4_gemv_a8": 6 * 128 * n_layers, "layer_tail_a8": 6 * 128 * n_layers})
    for k, v in c.items():
        launches[k] = launches.get(k, 0) + v
    out["decode_in_turns"] = rates
    log("  decode tok/s in turns (3 rounds of 128 tokens after the 1918-token "
        "prefill): " + "; ".join(
            f"{impl}: " + ", ".join(f"{r:.2f}" for r in got)
            + f" (median {statistics.median(got):.2f})"
            for impl, got in rates.items()))

    log(f"  tok/s beside the exact mode (phase 5: prompt "
        f"{exact['prompt_tps']:.1f}, decode {exact['decode_tps']:.2f}): "
        + "; ".join(
            f"{k}: " + (f"prompt {v['prompt_tps']:.1f}, "
                        if "prompt_tps" in v else "")
            + f"decode {v['decode_tps']:.2f}" for k, v in out.items()
            if "decode_tps" in v))
    return out



def kv_path(mp, bf16, launches):
    """Phase 9: the quantized KV caches at full width, each under the config
    that model_init.make_config returns for its flags. ``bf16`` is phase
    5's result, {"greedy": phase 6's, "a8 greedy": phase 8's} beside it."""
    import argparse

    from exllama_tpu_torch import model_init

    port = mp.port
    base, base_cache = mp.model, mp.cache
    n_layers = mp.cfg.num_hidden_layers
    out, served = {}, {}

    def tally():
        for k, v in counts().items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:      # Llama-7B (benchmark.py:43-45)
            json.dump({"hidden_size": 4096, "intermediate_size": 11008,
                       "num_attention_heads": 32, "num_hidden_layers": 32,
                       "vocab_size": 32000, "rms_norm_eps": 1e-6}, f)
        for flags, greedy_too in ((["--kv_int8"], True), (["--kv_int4"], True),
                                  (["--turbo"], True),
                                  (["--turbo", "--turbo_prefill"], False)):
            label = " ".join(flags)
            parser = argparse.ArgumentParser()
            model_init.add_args(parser)
            cfg = model_init.make_config(parser.parse_args(
                ["-c", path, "-m", "synthetic", "-l", "2048"] + flags))
            kind, impl = cfg.tuning.kv_cache_dtype, cfg.tuning.matmul_impl
            assert kind == ("int4" if "--kv_int4" in flags else "int8")
            assert impl == {"--kv_int8": "auto", "--kv_int4": "auto",
                            "--turbo": "pallas_a8"}.get(label, "pallas_a8t")
            torch.cuda.reset_peak_memory_stats()
            model = port.ExLlama(cfg, params=base.params, device=base.device)
            cache = port.ExLlamaCache(model)
            assert cache.k[0].dtype == torch.int8 and cache.k[0].shape[-1] == (
                64 if kind == "int4" else 128)
            mp.use_model(model, cache)
            a8 = impl != "auto"
            tail = ("layer_tail_a8_" if a8 else "layer_tail_") + kind
            prefill = {f"flash_attn_{kind}": n_layers, "flash_attn": 0}
            if impl == "pallas_a8t":
                assert model.params.layers[0].down.w8 is not None
                prefill.update(w8_matmul=3 * n_layers, q4_prefill_a8=n_layers,
                               q4_dequant_matmul=0)
            else:
                prefill.update(q4_dequant_matmul=4 * n_layers, w8_matmul=0)
            step = {tail: n_layers, "layer_tail": 0, "layer_tail_a8": 0,
                    "q4_gemv_a8" if a8 else "q4_gemv": n_layers,
                    "q4_gemv" if a8 else "q4_gemv_a8": 0, "dense_gemv": 1,
                    f"flash_attn_{kind}": 0, f"kv_commit_{kind}": 0}
            zero_counts()
            out[label] = r = mp.request1(label)
            require(f"phase 9 {label} prefill", r["per_prefill"], prefill)
            require(f"phase 9 {label} decode step", r["per_decode_step"], step)
            logits = model.forward(mp.gen.sequence[:, -1:], cache)
            assert logits.shape == (1, 1, cfg.vocab_size)
            assert torch.isfinite(logits).all()
            assert (cache.k_scale[-1][:, :, :cache.current_seq_len] > 0).all()
            tally()
            r["cache_bytes"] = cache.nbytes()
            r["peak_bytes"] = torch.cuda.max_memory_allocated()
            log(f"  {label}: cache {r['cache_bytes']} bytes "
                f"({r['cache_bytes'] / 2**30:.3f} GiB; bf16 "
                f"{base_cache.nbytes() / 2**30:.3f} GiB), max_memory_allocated "
                f"{r['peak_bytes'] / 2**30:.2f} GiB (the bf16 cache and phase "
                f"5's model stay allocated beside it)")
            if greedy_too:
                # phase 6's card-bound path: one K7 launch a layer, one K8
                # commit a step, over the quantized cache
                zero_counts()
                glabel = f"{label}, fuse_qkv, commit_impl=pallas"
                out[glabel] = g = greedy(mp, glabel, qkv_fuse=True,
                                         commit_impl="pallas",
                                         matmul_impl=impl)
                require(f"phase 9 greedy {label}", g["per_decode_step"], {
                    tail: n_layers, f"kv_commit_{kind}": 1, "head_argmax": 1,
                    "layer_tail": 0, "layer_tail_a8": 0, "kv_commit": 0,
                    "q4_gemv": 0, "q4_gemv_a8": 0})
                tally()
                served[label] = (model, impl)
            mp.use_model(base, base_cache)
            del model, cache
            torch.cuda.empty_cache()

        # that path is within a tenth of being host-bound, and the host's
        # pace moves between two runs of the same kernels: the cache formats
        # are also timed in turns (two rounds), beside bf16 under both GEMV
        # arithmetics
        served = {"bf16": (base, "auto"), "bf16, pallas_a8": (base, "pallas_a8"),
                  **served}
        rates = {label: [] for label in served}
        zero_counts()
        for _ in range(2):
            for label, (model, impl) in served.items():
                cache = (base_cache if model is base
                         else port.ExLlamaCache(model))
                mp.use_model(model, cache)
                g = greedy(mp, f"in turns, {label}", qkv_fuse=True,
                           commit_impl="pallas", matmul_impl=impl)
                rates[label].append((g["decode_tps"], g["host_s"]))
        mp.use_model(base, base_cache)
        tally()
        out["greedy_in_turns"] = rates
        log("  greedy fuse_qkv + K8 tok/s in turns (host's share of the "
            "time in brackets): " + "; ".join(
                f"{label}: " + ", ".join(
                    f"{r:.2f} ({h * r / 128:.0%})" for r, h in got)
                for label, got in rates.items()))
        del served
        torch.cuda.empty_cache()
    log(f"  tok/s beside the bf16 cache (phase 5: prompt "
        f"{bf16['prompt_tps']:.1f}, decode {bf16['decode_tps']:.2f}; greedy "
        f"fuse_qkv + K8: {bf16['greedy']:.2f}, under pallas_a8 "
        f"{bf16['a8 greedy']:.2f}): " + "; ".join(
            f"{k}: " + (f"prompt {v['prompt_tps']:.1f}, "
                        if "prompt_tps" in v else "")
            + f"decode {v['decode_tps']:.2f}" for k, v in out.items()
            if "decode_tps" in v))
    return out


# -------------------------------------------------------------- phase 10

# the kernels (and their a8 / f32 builds) that the plain path must not run
NOT_UNDER_XLA = ("q4_gemv", "q4_dequant_matmul", "dense_gemv", "head_argmax",
                 "q4_mlp", "layer_tail", "q4_gemv_a8", "q4_prefill_a8",
                 "w8_matmul", "q4_matmul_glu", "q4_mlp_a8", "layer_tail_a8")
BENCH_STEPS = (
    # label, benchmark argv, environment, launches wanted (None: at least one)
    # -p at -l 2048: 5 prefills of 1920 tokens (K2 128, K3 32 each); 480
    # generator steps at each context (K1 32, K7 32, K4 1 a step) and 480
    # greedy steps (K7 32, K5 1, K8 1), nearly all of them graph replays,
    # which count the launches they captured
    ("-p", ["--synthetic", "7b", "-p"], {},
     {"q4_gemv": 30720, "q4_dequant_matmul": 640, "flash_attn": 160,
      "dense_gemv": 960, "layer_tail": 46080, "head_argmax": 480,
      "kv_commit": 480}),
    ("--matmul_impl xla -ppl", ["--synthetic", "7b", "-ppl",
                                "--matmul_impl", "xla"], {},
     {**{k: 0 for k in NOT_UNDER_XLA},
      **{f"{k}_f32": 0 for k in F32_KERNELS}, "flash_attn": None}),
    ("-ppl -vv", ["--synthetic", "7b", "-ppl", "-vv"], {},
     {k: None for k in ("q4_gemv", "q4_dequant_matmul", "flash_attn",
                        "dense_gemv", "q4_mlp", "layer_tail")}),
    ("--scale_f32 -ppl -v, EXL_GLU_FUSE=1",
     ["--synthetic", "7b", "--scale_f32", "-ppl", "-v"],
     {"EXL_GLU_FUSE": "1"},
     {**{f"{k}_f32": None for k in ("q4_gemv", "q4_dequant_matmul", "q4_mlp",
                                     "layer_tail", "q4_matmul_glu")},
      **{k: 0 for k in ("q4_gemv", "q4_dequant_matmul", "q4_mlp",
                        "layer_tail", "q4_matmul_glu")}}),
    ("--ppl_turbo -l 256", ["--synthetic", "7b", "--ppl_turbo", "-l", "256",
                            "--ppl_chunks", "4"], {},
     {k: None for k in ("q4_dequant_matmul", "w8_matmul", "q4_prefill_a8",
                        "q4_gemv_a8", "layer_tail_a8")}),
    ("--scale_f32 --ppl_turbo -l 256",
     ["--synthetic", "7b", "--scale_f32", "--ppl_turbo", "-l", "256",
      "--ppl_chunks", "4"], {},
     {**{f"{k}_f32": None for k in ("q4_dequant_matmul", "q4_prefill_a8",
                                     "q4_gemv_a8", "layer_tail_a8")},
      "w8_matmul": None, "q4_gemv_a8": 0, "q4_prefill_a8": 0}),
)
# the act-order checkpoint on disk: Llama-7B width, depth cut to this
CKPT_LAYERS = 4


def finite(name, values):
    bad = {k: v for k, v in values.items()
           if isinstance(v, float) and not math.isfinite(v)}
    if bad:
        raise AssertionError(f"{name}: non-finite {bad}")


def bench_step(label, argv, env, want, launches, inspect=None):
    """One run of the port's benchmark (``benchmark.load`` + ``run``, as
    ``python -m exllama_tpu_torch.benchmark ARGV`` runs it), every launch
    counter zeroed just before and read just after; ``inspect(model)`` runs
    inside the window. Returns the benchmark's numbers."""
    import gc

    from exllama_tpu_torch import benchmark

    log(f"  [10] benchmark {' '.join(argv)}"
        + (f" ({', '.join(f'{k}={v}' for k, v in env.items())})"
           if env else ""))
    t0 = time.time()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        zero_counts()
        args = benchmark.parse_args(argv)
        model, tok = benchmark.load(args)
        out = benchmark.run(args, model, tok)
        if inspect is not None:
            out["inspect"] = inspect(model, tok)
        c = counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(f"phase 10 {label}", c, want)
    launches.update({k: launches.get(k, 0) + v for k, v in c.items()})
    log(f"  [10] {label}: launches {({k: v for k, v in c.items() if v})} "
        f"({time.time() - t0:.1f} s)")
    del model, tok
    gc.collect()
    torch.cuda.empty_cache()
    return out


def benchmark_path(launches):
    """Phase 10: the port's benchmark on the card at Llama-7B width (full
    depth for the synthetic model; the act-order checkpoint cut to
    CKPT_LAYERS layers): -p (prompt, best / worst decode fitted and raw,
    the greedy fuse_qkv + K8 line, memory); the plain path alone (no 4-bit,
    lm_head or fused kernel launched; K3 still attends); -ppl -vv; f32
    scales with -ppl -v and the GLU-fused down projection; --ppl_turbo with
    bf16 and f32 scales; then a checkpoint written by the port's fabricate
    (act-order, g128) loaded through -d and validated (-v) with the
    act-order fold on and off."""
    from exllama_tpu_torch.generator import ExLlamaGenerator
    from exllama_tpu_torch.utils.fabricate import fabricate

    res = {}
    for label, argv, env, want in BENCH_STEPS:
        inspect = None
        if "xla" in argv:
            # the plain path's decode too: a short greedy completion
            def inspect(model, tok):
                from exllama_tpu_torch.cache import ExLlamaCache

                gen = ExLlamaGenerator(model, tok, ExLlamaCache(model))
                gen.settings.top_k = 1
                return gen.generate_simple("To be or not to be",
                                           max_new_tokens=8)
        out = bench_step(label, argv, env, want, launches, inspect)
        for part in out.values():
            if isinstance(part, dict):
                finite(label, part)
        v = out.get("validate", {})
        if "ppl_delta" in v and not v["ppl_delta"] < v["ppl_limit"]:
            raise AssertionError(f"{label}: ppl delta {v['ppl_delta']}")
        res[label] = out
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.time()
        _, nbytes = fabricate(ckpt, "7b", 128, act_order=True,
                              layers=CKPT_LAYERS, verbose=False)
        log(f"  [10] fabricate 7b g128 act-order, {CKPT_LAYERS} layers: "
            f"{nbytes / 2**30:.2f} GiB in {time.time() - t0:.1f} s")
        for fold in (True, False):
            label = f"-d (act-order) -v, fold_act_order={fold}"
            argv = ["-d", ckpt, "-v", "-l", "512"] + (
                [] if fold else ["--no_fold_act_order"])

            def inspect(model, tok, fold=fold):
                down = model.params.layers[0].down
                if (down.x_map is None) != fold:
                    raise AssertionError(f"{label}: down.x_map "
                                         f"{'kept' if fold else 'folded'}")
                return "x_map kept" if down.x_map is not None else "folded"

            res[label] = bench_step(
                label, argv, {}, {"q4_gemv": None, "q4_dequant_matmul": None,
                                  "flash_attn": None, "q4_mlp": 0,
                                  "layer_tail": 0}, launches, inspect)
    return res


# -------------------------------------------------------------- phase 11

# the kernels each captured decode step launches on the 32-layer model
SAMPLED_STEP = {"q4_gemv": 32, "layer_tail": 32, "dense_gemv": 1,
                "flash_attn": 0, "kv_commit": 0, "head_argmax": 0}
GREEDY_STEP = {"layer_tail": 32, "head_argmax": 1, "kv_commit": 1,
               "q4_gemv": 0, "flash_attn": 0, "dense_gemv": 0}
STEP_KERNELS = {"sampled": ("q4_gemv", "layer_tail_kernel", "dense_wg_kernel"),
                "greedy": ("layer_tail_kernel", "head_argmax", "kv_commit")}


def counter_names():
    """{(wrapper, attribute): name in counts()} for a graph's captured
    counts (``kernels.launch_counts`` keys)."""
    return {v: k for k, v in launch_counters().items()}


def captured(loop):
    """{attend_len: {counter name: launches a replay}} of a DecodeLoop."""
    names = counter_names()
    return {a: {**{k: 0 for k in launch_counters()},
                **{names[k]: n for k, n in e.counts.items()}}
            for a, e in sorted(loop.graphs.items())}


def same_caches(label, a, b):
    for x, y in zip(a._tensor_lists(), b._tensor_lists()):
        for s, t in zip(x, y):
            if not torch.equal(s, t):
                raise AssertionError(f"phase 11 {label}: caches differ")


def eager_twin(model):
    """The same model (parameters, config) with ``capture = False``: every
    step of what runs on it is eager."""
    twin = copy.copy(model)
    twin.capture = False
    return twin


def generator_pair(mp, batch=1, **settings):
    """Two generators on fresh caches of the 32-layer model, one seed: the
    first replays captured graphs, the second runs the same step eagerly
    (on the model's ``eager_twin``)."""
    port, tok = mp.port, mp.tok
    gens = []
    for model in (mp.model, eager_twin(mp.model)):
        g = port.ExLlamaGenerator(
            model, tok, port.ExLlamaCache(model, batch_size=batch),
            seed=SEED)
        g.disallow_tokens([tok.eos_token_id])
        for k, v in settings.items():
            setattr(g.settings, k, v)
        gens.append(g)
    return gens


def graph_vs_eager(mp, label, ids, n, mask=None, **settings):
    """gen_tokens(n) through the graphs and eagerly from the same state:
    tokens and caches bit-equal; the graph run's launches n x the step's,
    and each graph's captured counts the step's. Returns the graphed
    generator."""
    g, e = generator_pair(mp, ids.shape[0], **settings)
    for x in (g, e):
        x.gen_begin(ids, mask=mask)
    zero_counts()
    got = g.gen_tokens(n)
    c = counts()
    ref = e.gen_tokens(n)
    if not np.array_equal(got, ref):
        raise AssertionError(f"phase 11 {label}: graph {got.tolist()} vs "
                             f"eager {ref.tolist()}")
    same_caches(label, g.cache, e.cache)
    require(f"phase 11 {label}", c,
            {k: v * n for k, v in SAMPLED_STEP.items()})
    caps = captured(g._loop)
    for a, cc in caps.items():
        require(f"phase 11 {label} graph at attend_len {a}", cc, SAMPLED_STEP)
    log(f"  [11] {label}: {n} tokens bit-equal to the eager step "
        f"({got[:, :8].tolist()}...), graphs at attend_len {list(caps)}, "
        f"launches {({k: v for k, v in c.items() if v})}")
    return g, e


def time_turns(label, runs, n, phase=11):
    """Each of ``runs`` ({name: fn(n)}) in turns (A B B A), fenced by
    torch.cuda.synchronize(); the faster of each one's two, as tok/s."""
    order = list(runs) + list(runs)[::-1]
    best = {}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name](n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best[name] = min(best.get(name, dt), dt)
    out = {k: n / v for k, v in best.items()}
    log(f"  [{phase}] {label}, {n} tokens a run, A B B A: " + ", ".join(
        f"{k} {v:.2f} tok/s" for k, v in out.items()))
    return out


def compiled_decode(mp):
    """Phase 11: the compiled decode step on the 32-layer Llama-7B-shape
    model -- gen_tokens and the benchmark's greedy loop through captured
    CUDA graphs, one per attend-length bucket, held bit for bit against the
    same step run eagerly from the same state; launch counters through the
    replays; a torch.profiler trace of one replay (kernels by name, the
    device's idle share); graph and eager tok/s in turns."""
    from exllama_tpu_torch import benchmark
    from exllama_tpu_torch.models.llama import forward_chunk

    cfg, model, tok = mp.cfg, mp.model, mp.tok
    res = {}
    ids = mp.ids[:, :250]
    graph_vs_eager(mp, "B=1 top-k 1 from 249 across the 256 bucket", ids, 16,
                   top_k=1)
    g, e = graph_vs_eager(
        mp, "B=1 sampled (top-k 40, top-p 0.65, penalty 1.15)", ids, 16)
    ids2, m2 = tok.encode(["Once upon a time",
                           "In a land far away, long before the port"],
                          return_mask=True, max_seq_len=cfg.max_seq_len)
    full = np.zeros((2, cfg.max_seq_len), bool)
    full[:, :ids2.shape[1]] = m2
    graph_vs_eager(mp, "B=2, row 0 left-padded, with its mask", ids2, 16,
                   mask=full, top_k=1)

    # the benchmark's greedy loop (fuse_qkv + K8) against forward_chunk(
    # head_mode="argmax") called eagerly at int cursors, after the prompt
    cache = mp.port.ExLlamaCache(model)
    model.forward(mp.ids[:, :-1], cache, preprocess_only=True)
    ref_cache = cache.clone()
    past = cache.current_seq_len
    last = torch.as_tensor(mp.ids[:, -1:], device=model.device)
    loop = benchmark.greedy_loop(model, cache)
    zero_counts()
    got = benchmark.greedy_decode(loop, last, past, 32).cpu()
    c = counts()
    require("phase 11 greedy loop", c,
            {k: v * 32 for k, v in GREEDY_STEP.items()})
    for a, cc in captured(loop).items():
        require(f"phase 11 greedy graph at attend_len {a}", cc, GREEDY_STEP)
    kw = dict(attend_len=cfg.max_seq_len, last_token_only=True,
              preprocess_only=False, heads=cfg.num_attention_heads,
              kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
              eps=cfg.rms_norm_eps, head_mode="argmax", qkv_fuse=True,
              commit_impl="pallas")
    t, ref = last, []
    for i in range(32):
        t = forward_chunk(model.params, ref_cache, t, past + i, None, **kw)
        ref.append(t)
    ref = torch.cat(ref, dim=1).cpu()
    if not torch.equal(got, ref):
        raise AssertionError(f"phase 11 greedy loop: graph {got.tolist()} vs "
                             f"eager {ref.tolist()}")
    ref_cache.current_seq_len = past + 32
    same_caches("greedy loop", cache, ref_cache)
    log(f"  [11] greedy loop (fuse_qkv + K8, attend_len {cfg.max_seq_len}): "
        f"32 tokens bit-equal to eager forward_chunk(head_mode=\"argmax\"); "
        f"launches {({k: v for k, v in c.items() if v})}")

    # one replay of each graph traced (phase 6 traces an eager step of the
    # greedy path); the sampled graph at the 2048 bucket after the
    # 1919-token prompt
    g.gen_begin(mp.ids)
    e.gen_begin(mp.ids)
    took = []
    for _ in range(2):       # the bucket's capture (eager step + capture), a replay
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.gen_tokens(1)
        took.append(time.perf_counter() - t0)
    e.gen_tokens(2)
    res["capture_ms"], res["replay_ms"] = took[0] * 1e3, took[1] * 1e3
    log(f"  [11] gen_tokens(1) at a new bucket (eager step + capture): "
        f"{took[0] * 1e3:.1f} ms; at a captured one (a replay): "
        f"{took[1] * 1e3:.2f} ms (host clock, the token fetched)")
    entry = g._loop.graphs[2048]
    for label, step in (("sampled", entry.graph.replay),
                        ("greedy", loop.graphs[cfg.max_seq_len].graph.replay)):
        want = STEP_KERNELS[label]
        names, idle = trace_step(step)
        if names is None:
            log(f"  [11] {label} replay traced: no device activity in the "
                f"trace (not measured)")
            continue
        missing = [k for k in want if not any(k in n for n in names)]
        if missing:
            raise AssertionError(f"phase 11 {label} replay: no {missing} "
                                 f"in the trace {names}")
        res[f"{label}_replay"] = dict(launches=sum(names.values()), **idle)
        top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
        log(f"  [11] {label} step, one replay traced: "
            f"{sum(names.values())} device launches in "
            f"{idle['window_us']:.1f} us, device busy {idle['busy_us']:.1f} "
            f"us, idle {idle['idle_share']:.1%}; most launched: "
            + "; ".join(f"{n} x {k[:90]}" for k, n in top))
    # graph against eager, the same path, in turns
    g.gen_begin(mp.ids)
    e.gen_begin(mp.ids)
    g.gen_tokens(4)                    # captures the 2048 bucket's graph
    res["sampled_tps"] = time_turns(
        "generator decode (sampled, 1919-token context)",
        {"graph": lambda n: (g.gen_tokens(n), g.gen_rewind(n)),
         "eager": lambda n: (e.gen_tokens(n), e.gen_rewind(n))}, 64)

    def greedy_graph(n):
        benchmark.greedy_decode(loop, last, past, n)

    def greedy_eager(n):
        t = last
        for i in range(n):
            t = forward_chunk(model.params, ref_cache, t, past + i, None, **kw)

    res["greedy_tps"] = time_turns(
        "greedy loop (fuse_qkv + K8, 1919-token context)",
        {"graph": greedy_graph, "eager": greedy_eager}, 64)
    # the kernels' tickets (K3, the GEMVs) and K5's keys read zero after
    # the replays: each launch's last block resets them
    from exllama_tpu_torch import kernels

    held = [t for t in kernels.scratch_in_use(model.params.embed.device)
            if not t.is_floating_point()]
    if not held or any(int(t.count_nonzero()) for t in held):
        raise AssertionError("phase 11: tickets or keys not zero after the "
                             "replays")
    log(f"  [11] {len(held)} ticket / key buffers read zero after the "
        f"replays")
    return res


# -------------------------------------------------------------- phase 12

# the adapters (utils.fabricate.fabricate_lora, PEFT layout, written for the
# 32-layer model; the 2-layer models read their first two layers): Q =
# PEFT's default targets on a Llama model, A = all seven projections, at
# scale 0.3 on zero-mean weights (``centered``), where lora_vs_cpu first
# shows that each moves the logits by more than 3x LORA_TOL. On
# make_synthetic_params(fast)'s own weights (zero-point 8) the common mode
# of the residual stream dwarfs any projection's low-rank term.
ADAPTERS = {"Q": dict(targets=("q", "v"), r=8, alpha=16.0),
            "A": dict(targets=("q", "k", "v", "o", "gate", "up", "down"),
                      r=16, alpha=16.0)}
LORA_SCALE = 0.3
LORA_TOL = 0.03        # phase 4's: card vs CPU logits over the logit scale
# launches per decode step on the 32-layer model: adapter Q keeps K7's
# layer tail (q and v adapted: K1 with its norm prologue, the adapters
# on the plainly normed x), adapter A
# refuses K7 (o) and K6 (the MLP): K1 on qkv, o, gate|up and down, K3
LORA_STEP = {"Q": {"q4_gemv": 32, "layer_tail": 32, "dense_gemv": 1,
                   "flash_attn": 0, "q4_mlp": 0},
             "A": {"q4_gemv": 128, "flash_attn": 32, "dense_gemv": 1,
                   "layer_tail": 0, "q4_mlp": 0}}
# per prefill of more than 32 tokens under adapter A
LORA_PREFILL = {"q4_dequant_matmul": 128, "flash_attn": 32}
# per speculative verify forward (T = k + 1 = 2..9 rows, no adapter): K1 on
# qkv (norm prologue) and o, K3 at T query rows over the cache, K6, K4
VERIFY_STEP = {"q4_gemv": 64, "flash_attn": 32, "q4_mlp": 32,
               "dense_gemv": 1, "layer_tail": 0}


def lora_step_2layers(name, act):
    """LORA_STEP for the 2-layer models of lora_vs_cpu; on act-order layers
    (never fused: q, k, v, gate, up apart) adapter A runs K1 seven times a
    layer."""
    if act:
        return {"q4_gemv": 14, "flash_attn": 2, "dense_gemv": 1,
                "layer_tail": 0, "q4_mlp": 0}
    return {k: v if k == "dense_gemv" else v // 16
            for k, v in LORA_STEP[name].items()}


def write_adapters(cfg, root):
    """{name: (config path, adapter path)} of ADAPTERS for ``cfg``."""
    from exllama_tpu_torch.utils.fabricate import fabricate_lora

    return {name: fabricate_lora(os.path.join(root, name), cfg,
                                 scale=LORA_SCALE, seed=SEED + 12 + i, **a)
            for i, (name, a) in enumerate(ADAPTERS.items())}


def lora_vs_cpu(device, files):
    """2 layers at full width on zero-mean weights (``centered``), one seed,
    on the card and on the CPU: 64-token prefill + 4 teacher-forced decode
    steps under each adapter. Each adapter first moves the card's logits
    by more than 3x LORA_TOL against the same model without it; then card
    vs CPU within LORA_TOL. Then act-order g128 with the fold on under
    adapter A, where an adapter loaded without the fold's permutation
    moves the logits by more than 3x the limit. Returns {case: (moved,
    worst card vs CPU, launches a decode step)}."""
    import exllama_tpu_torch as port

    out = {}
    rng = np.random.default_rng(SEED + 12)
    for label, act, names in (("g128", False, ("Q", "A")),
                              ("act-order g128, folded", True, ("A",))):
        cfg = port.ExLlamaConfig()
        cfg.num_hidden_layers = 2
        cfg.max_seq_len = 128
        cpu_params = centered(port.make_synthetic_params(
            cfg, 128, act, seed=1, device="cpu", fast=True))
        if act and any(f is None for f in cpu_params.down_folds):
            raise AssertionError(f"phase 12 {label}: a layer was not folded")
        cpu_model = port.ExLlama(cfg, params=cpu_params, device="cpu")
        gpu_model = port.ExLlama(cfg, params=cpu_params.to(device),
                                 device=device)
        ids = rng.integers(0, cfg.vocab_size, size=(1, 64)).astype(np.int32)
        steps = [ids] + [rng.integers(0, cfg.vocab_size, size=(1, 1)).astype(
            np.int32) for _ in range(4)]

        def run(model, lora):
            cache, outs, per_step = port.ExLlamaCache(model), [], None
            for i, tok in enumerate(steps):
                c0 = counts()
                outs.append(model.forward(tok, cache, last_id_only=i > 0,
                                          lora=lora).float().cpu())
                c1 = counts()
                if i == len(steps) - 1:
                    per_step = {k: c1[k] - c0[k] for k in c1}
            return outs, per_step

        def rel(a, b):
            return max(((x - y).abs().max() / y.abs().max()).item()
                       for x, y in zip(a, b))

        base, _ = run(gpu_model, None)
        for name in names:
            got, step = run(gpu_model, port.ExLlamaLora(gpu_model,
                                                        *files[name]))
            ref, _ = run(cpu_model, port.ExLlamaLora(cpu_model, *files[name]))
            moved, err = rel(got, base), rel(got, ref)
            if moved <= 3 * LORA_TOL:
                raise AssertionError(f"phase 12 {label} adapter {name}: "
                                     f"moves the logits by only {moved:.4f}")
            if not all(torch.isfinite(g).all() for g in got) or err > LORA_TOL:
                raise AssertionError(f"phase 12 {label} adapter {name}: card "
                                     f"vs CPU logits rel {err:.4f}")
            require(f"phase 12 {label} adapter {name} decode step", step,
                    lora_step_2layers(name, act))
            case = dict(moved=moved, err=err,
                        step={k: v for k, v in step.items() if v})
            if act:
                # the fault: an adapter of gate / up / down without the
                # permutation the load folded into gate / up's columns
                blind = port.ExLlama(cfg, params=dataclasses.replace(
                    gpu_model.params, down_folds=None), device=device)
                wrong, _ = run(gpu_model, port.ExLlamaLora(blind,
                                                           *files[name]))
                case["unfolded_moved"] = rel(wrong, got)
                if case["unfolded_moved"] <= 3 * LORA_TOL:
                    raise AssertionError(
                        f"phase 12 {label}: the adapter without the fold "
                        f"moves the logits by only {case['unfolded_moved']}")
            out[f"{label} adapter {name}"] = case
        del cpu_model, gpu_model, cpu_params
    return out


def lora_generators(mp, loras):
    """The generator under each adapter on the 32-layer model: gen_tokens
    through the graphs bit-equal (tokens and caches) to the same steps run
    eagerly, with the per-step launches of LORA_STEP; then the adapter
    switched to A without a gen_begin (the loop's epoch: every graph is
    captured anew) and again bit-equal to the eager steps; generate_simple
    through the graphs equal to the eager one; decode tok/s with each
    adapter beside none, in turns."""
    res = {}
    ids = mp.ids[:, :250]
    g, e = generator_pair(mp, top_k=1)
    for x in (g, e):
        x.lora = loras["Q"]
        x.gen_begin(ids)
    c0 = counts()
    got, ref = g.gen_tokens(16), e.gen_tokens(16)
    c = since(c0)
    if not np.array_equal(got, ref):
        raise AssertionError(f"phase 12 adapter Q: graph {got.tolist()} vs "
                             f"eager {ref.tolist()}")
    same_caches("adapter Q (phase 12)", g.cache, e.cache)
    require("phase 12 gen_tokens under Q (graphs and eager)", c,
            {k: 2 * v * 16 for k, v in LORA_STEP["Q"].items()})
    caps = captured(g._loop)
    for a, cc in caps.items():
        require(f"phase 12 adapter Q graph at attend_len {a}", cc,
                LORA_STEP["Q"])
    held = {a: entry.graph for a, entry in g._loop.graphs.items()}
    # the adapter changes between two gen_tokens calls of one sequence
    for x in (g, e):
        x.lora = loras["A"]
    c0 = counts()
    got, ref = g.gen_tokens(16), e.gen_tokens(16)
    c_a = since(c0)
    if not np.array_equal(got, ref):
        raise AssertionError(f"phase 12 Q -> A: graph {got.tolist()} vs "
                             f"eager {ref.tolist()}")
    same_caches("adapter Q -> A (phase 12)", g.cache, e.cache)
    if any(entry.graph is held.get(a)
           for a, entry in g._loop.graphs.items()):
        raise AssertionError("phase 12: a graph captured under adapter Q "
                             "replayed under adapter A")
    require("phase 12 gen_tokens under A (graphs and eager)", c_a,
            {k: 2 * v * 16 for k, v in LORA_STEP["A"].items()})
    for a, cc in captured(g._loop).items():
        require(f"phase 12 adapter A graph at attend_len {a}", cc,
                LORA_STEP["A"])
    log(f"  [12] gen_tokens(16) from 249 tokens under adapter Q, then 16 "
        f"more after switching to A: graphs bit-equal to the eager steps "
        f"(tokens {got[0, :6].tolist()}...), graphs under Q at attend_len "
        f"{list(caps)} dropped at the switch, launches a step Q "
        f"{LORA_STEP['Q']}, A {LORA_STEP['A']}")
    # a prefill under adapter A, and generate_simple through the graphs
    c0 = counts()
    g.gen_begin(ids)
    pre = since(c0)
    require("phase 12 prefill under adapter A", pre, LORA_PREFILL)
    res["prefill_A"] = {k: v for k, v in pre.items() if v}
    for name in ("Q", "A"):
        texts = []
        for x in (g, e):
            x.lora = loras[name]
            texts.append((x.generate_simple("Once upon a time",
                                            max_new_tokens=32),
                          x.sequence.copy()))
        if texts[0][0] != texts[1][0] or not np.array_equal(texts[0][1],
                                                            texts[1][1]):
            raise AssertionError(f"phase 12 generate_simple under {name}: "
                                 f"graph vs eager differ")
    log(f"  [12] generate_simple (32 tokens) under Q and A through the "
        f"graphs = eager; prefill of 249 tokens under A: {res['prefill_A']}")
    # decode tok/s, the sampled generator at the 1919-token context, with
    # no adapter, Q and A in turns
    gens = {}
    for name in ("none", "Q", "A"):
        x = generator_pair(mp)[0]
        x.lora = loras.get(name)
        x.gen_begin(mp.ids)
        x.gen_tokens(4)                     # captures the 2048 bucket
        gens[name] = x
    res["tps"] = time_turns(
        "generator decode (sampled, graphs, 1919-token context) by adapter",
        {k: (lambda n, x=x: (x.gen_tokens(n), x.gen_rewind(n)))
         for k, x in gens.items()}, 64, phase=12)
    # one replay of each one's graph traced: its device launches (the
    # low-rank terms are plain tensor code) and the device's idle share
    for name, x in gens.items():
        entry = next(iter(x._loop.graphs.values()), None)
        names, idle = (None, None) if entry is None else trace_step(
            entry.graph.replay)
        if names is None:
            log(f"  [12] adapter {name}: replay not traced (no graph or no "
                f"device activity in the trace: not measured)")
            continue
        res[f"trace_{name}"] = dict(launches=sum(names.values()), **idle)
        log(f"  [12] adapter {name}, one replayed step traced: "
            f"{sum(names.values())} device launches in "
            f"{idle['window_us']:.1f} us, device busy {idle['busy_us']:.1f} "
            f"us, idle {idle['idle_share']:.1%}")
    return res


def alt_generator_path(mp, lora):
    """ExLlamaAltGenerator on the 32-layer model under adapter Q, greedy,
    every token but printable ASCII disallowed (the byte tokenizer then
    decodes one character a token). From the text of a generate without
    stop conditions: a stop string first occurring at position i >= 6 and
    a stop token first occurring after it give the text before i, no stop
    string in it, and stream()'s chunks joined equal it; a stop token
    alone (first occurring at j >= 3) gives the text before j; K1 / K7 /
    K4 launched."""
    port = mp.port
    alt = port.ExLlamaAltGenerator(mp.model, mp.tok,
                                   port.ExLlamaCache(mp.model), seed=SEED)
    s = port.ExLlamaAltGenerator.Settings(temperature=1.0, top_k=1)
    s.lora = lora
    printable = range(32 + 4, 127 + 4)
    s.disallowed_tokens = [t for t in range(mp.cfg.vocab_size)
                           if t not in printable]
    prompt = "The adapter says:"
    c0 = counts()
    full = alt.generate(prompt, [], 32, s)
    toks = alt.sequence_ids[0, -32:].tolist()
    if len(full) != 32 or not all(t in printable for t in toks):
        raise AssertionError(f"phase 12 alt: {len(full)} characters, tokens "
                             f"{toks}")
    first = {}
    for j, t in enumerate(toks):
        first.setdefault(t, j)
    i = next((i for i in range(6, 30) if full.find(full[i:i + 2]) == i), 6)
    stop_str = full[i:i + 2]
    cut = full.find(stop_str)
    late = [t for t, j in first.items() if j > cut + 1] or [4]
    early = [t for t, j in first.items() if j >= 3]
    out = alt.generate(prompt, [stop_str, late[0]], 32, s)
    alt.begin_stream(prompt, [stop_str, late[0]], 32, s)
    chunks = []
    while True:
        chunk, eos = alt.stream()
        chunks.append(chunk)
        if eos:
            break
    by_token = None if not early else alt.generate(prompt, [early[0]], 32, s)
    c = since(c0)
    if out != full[:cut] or stop_str in out or "".join(chunks) != out:
        raise AssertionError(f"phase 12 alt: {out!r} / {''.join(chunks)!r} "
                             f"vs {full[:cut]!r} (stop {stop_str!r})")
    if early and by_token != full[:first[early[0]]]:
        raise AssertionError(f"phase 12 alt: stop token {early[0]}: "
                             f"{by_token!r}")
    require("phase 12 alt generator", c, {"q4_gemv": None,
                                          "layer_tail": None,
                                          "dense_gemv": None})
    log(f"  [12] alt generator under Q: {full!r}; stop string {stop_str!r} "
        f"and token {late[0]}: {out!r} ({len(chunks)} stream chunks, "
        f"joined equal); stop token {early[:1]} alone: {by_token!r}; "
        f"launches {({k: v for k, v in c.items() if v})}")
    return dict(text=full, out=out, chunks=len(chunks), by_token=by_token)


# the one-token routes a verify row is held against: the default (K1, K7,
# K4) and the separate kernels (K1, K3, K1, K1, K4)
ONE_TOKEN_ROUTES = (("fused", {}),
                    ("separate", dict(fuse_mlp=False, fuse_attn=False)))


def verify_rows_vs_steps(port, model, ids):
    """Every row of the verify forward, at the shapes the speculative run
    gives it (most of its rows only decide acceptance, so its emitted
    tokens cannot show them): after a prefill of ``ids``, for T = 4, 5, 9,
    one forward of the last token and the pattern's next T - 1 tokens (the
    n-gram proposer's draft) with last_id_only=False, then T one-token
    forwards of the same tokens on each of ONE_TOKEN_ROUTES, row i at the
    cursor base + i over the cache rows the T-row forward wrote (taken from
    the last row down, so none of those rows was overwritten yet). Each
    T-row forward launches VERIFY_STEP (per layer). Returns {T: (worst row
    against the default route's step, worst row of the two routes against
    each other)}, each over the step's logit scale."""
    layers = model.config.num_hidden_layers
    want = {k: v if k == "dense_gemv" else v * layers // 32
            for k, v in VERIFY_STEP.items()}
    tuning = model.config.tuning
    cache = port.ExLlamaCache(model)
    model.forward(ids[None, :-1], cache, preprocess_only=True)
    base = cache.current_seq_len
    out = {}
    for t in (4, 5, 9):
        chunk = np.concatenate([ids[-1:], ids[:t - 1]])[None]
        c0 = counts()
        rows = model.forward(chunk, cache, last_id_only=False)[0].float()
        require(f"phase 12 verify forward at T = {t}, {layers} layers",
                since(c0), want)
        if not torch.isfinite(rows).all():
            raise AssertionError(f"phase 12 verify T = {t}: non-finite rows")
        steps = {}
        for route, knobs in ONE_TOKEN_ROUTES:
            old = {k: getattr(tuning, k) for k in knobs}
            for k, v in knobs.items():
                setattr(tuning, k, v)
            try:
                steps[route] = [None] * t
                for i in reversed(range(t)):
                    cache.current_seq_len = base + i
                    steps[route][i] = model.forward(
                        chunk[:, i:i + 1], cache)[0, -1].float()
            finally:
                for k, v in old.items():
                    setattr(tuning, k, v)
        cache.current_seq_len = base

        def rel(a, b):
            return max(((x - y).abs().max() / y.abs().max()).item()
                       for x, y in zip(a, b))

        out[t] = (rel(rows, steps["fused"]),
                  rel(steps["separate"], steps["fused"]))
    del cache
    return out


def verify_rows(port, device, mp, ids):
    """verify_rows_vs_steps on a 2-layer full-width model (zero-mean
    weights, another seed, max_seq_len 2048) and on the 32-layer model.
    Each row within LORA_TOL of its one-token step or, where the two
    one-token routes sit further apart than that (32 layers of zero-mean
    random weights amplify a bf16 step of difference between any two
    routes to ~3% of the logit scale), within 1.5x their spread. Returns
    {label: {T: (worst row, spread)}}."""
    cfg = port.ExLlamaConfig()
    cfg.num_hidden_layers = 2
    cfg.max_seq_len = mp.cfg.max_seq_len
    two = port.ExLlama(cfg, params=centered(port.make_synthetic_params(
        cfg, 128, False, seed=SEED + 2, device=device, fast=True)),
        device=device)
    out = {"2 layers": verify_rows_vs_steps(port, two, ids)}
    del two
    out["32 layers"] = verify_rows_vs_steps(port, mp.model, ids)
    for label, by_t in out.items():
        for t, (err, spread) in by_t.items():
            if err > max(LORA_TOL, 1.5 * spread):
                raise AssertionError(
                    f"phase 12 verify forward, {label}, T = {t}: a row "
                    f"{err:.4f} of the logit scale from its one-token step "
                    f"(the two one-token routes {spread:.4f} apart)")
    return out


def speculative_path(mp, device):
    """SpeculativeGenerator on the 32-layer model: first every row of the
    verify forward against one-token steps (``verify_rows``); then
    NgramProposer, top-k 1, 128 tokens after a 64-token pattern repeated
    16 times; every emitted token within LORA_TOL of the best of the
    one-token kernel path teacher-forced over the same sequence
    (``forced_gaps``); the launches of each verify forward VERIFY_STEP;
    drafted / accepted / forwards and tok/s beside the generator's eager
    and graphed tok/s on the same prompt. Then a 4-layer draft model of the
    same width (another seed), 32 tokens: its acceptance rate; and the
    model as its own draft (max_draft 8), 32 tokens, where the drafts are
    the one-token path's greedy tokens, so that most tokens are emitted
    from rows 1..k of the verify forwards and held by ``forced_gaps``."""
    from exllama_tpu_torch.speculative import DraftModelProposer, NgramProposer

    port, model, tok = mp.port, mp.model, mp.tok
    rng = np.random.default_rng(SEED + 12)
    ids = np.tile(rng.integers(4, 260, size=64), 16).astype(np.int32)
    res = dict(rows=verify_rows(port, device, mp, ids))
    log(f"  [12] verify forward after {len(ids) - 1} tokens, every row vs a "
        f"one-token step over the same cache rows (limit {LORA_TOL}, or 1.5x "
        f"the two one-token routes' spread where that is larger): " + "; ".join(
            f"{label} " + ", ".join(f"T = {t} within {e:.4f} (routes {sp:.4f}"
                                    f" apart)" for t, (e, sp) in by_t.items())
            for label, by_t in res["rows"].items()))
    spec = port.SpeculativeGenerator(model, tok, port.ExLlamaCache(model),
                                     NgramProposer(), seed=SEED)
    spec.settings.top_k = 1
    verify = []

    def counted(input_ids, cache, **kw):
        c0 = counts()
        r = type(model).forward(model, input_ids, cache, **kw)
        t = np.asarray(input_ids).shape[1]
        if not kw.get("last_id_only", True) and t > 1:
            verify.append((t, since(c0)))
        return r

    model.forward = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = spec.generate_tokens(ids, 128)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        del model.forward
    toks = seq[len(ids):]
    if len(toks) != 128 or not verify:
        raise AssertionError(f"phase 12 speculative: {len(toks)} tokens, "
                             f"{len(verify)} verify forwards of 2+ rows")
    for t, c in verify:
        require(f"phase 12 verify forward at T = {t}", c, VERIFY_STEP)
    gaps = forced_gaps(model, ids[None], toks,
                       score=lambda logits, g: logits[0])
    if max(gaps) > LORA_TOL:
        raise AssertionError(f"phase 12 speculative: a token {max(gaps):.4f} "
                             f"below the one-token path's best")
    res.update(stats=dict(spec.stats), acceptance=spec.acceptance_rate,
               tps=128 / dt, max_gap=max(gaps),
               verify_rows=sorted({t for t, _ in verify}))
    # the generator on the same prompt, greedy: graphs and eager
    rates = {}
    for label, capture in (("graphs", True), ("eager", False)):
        g = generator_pair(mp, top_k=1)[0 if capture else 1]
        g.gen_begin(ids[None])
        g.gen_tokens(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.gen_tokens(128)
        torch.cuda.synchronize()
        rates[label] = 128 / (time.perf_counter() - t0)
    res["generator_tps"] = rates
    log(f"  [12] speculative (n-gram, top-k 1) after {len(ids)} tokens: 128 "
        f"tokens in {dt:.3f} s = {res['tps']:.2f} tok/s; {spec.stats}, "
        f"acceptance {spec.acceptance_rate:.3f}, verify rows "
        f"{res['verify_rows']}, launches per verify forward {VERIFY_STEP}; "
        f"every token within {max(gaps):.4f} of the one-token path's best; "
        f"the generator on the same prompt: graphs "
        f"{rates['graphs']:.2f}, eager {rates['eager']:.2f} tok/s")
    # a draft model: 4 layers of the same width and vocab, another seed
    cfg4 = port.ExLlamaConfig()
    cfg4.num_hidden_layers = 4
    cfg4.max_seq_len = mp.cfg.max_seq_len
    draft = port.ExLlama(cfg4, params=centered(port.make_synthetic_params(
        cfg4, 128, False, seed=SEED + 1, device=device, fast=True)),
        device=device)
    dspec = port.SpeculativeGenerator(model, tok, port.ExLlamaCache(model),
                                      DraftModelProposer(draft, max_draft=4),
                                      seed=SEED)
    dspec.settings.top_k = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dseq = dspec.generate_tokens(ids, 32)
    torch.cuda.synchronize()
    ddt = time.perf_counter() - t0
    dgaps = forced_gaps(model, ids[None], dseq[len(ids):],
                        score=lambda logits, g: logits[0])
    if len(dseq) != len(ids) + 32 or max(dgaps) > LORA_TOL:
        raise AssertionError(f"phase 12 draft model: {len(dseq) - len(ids)} "
                             f"tokens, gap {max(dgaps):.4f}")
    res["draft"] = dict(stats=dict(dspec.stats),
                        acceptance=dspec.acceptance_rate, tps=32 / ddt,
                        max_gap=max(dgaps))
    log(f"  [12] draft model (4 layers, seed {SEED + 1}, max_draft 4): 32 "
        f"tokens in {ddt:.3f} s = {32 / ddt:.2f} tok/s; {dspec.stats}, "
        f"acceptance {dspec.acceptance_rate:.3f}; every token within "
        f"{max(dgaps):.4f} of the one-token path's best")
    del draft, dspec
    # the model as its own draft: it drafts the one-token path's greedy
    # tokens, so a verify row that agrees with its one-token step accepts
    sspec = port.SpeculativeGenerator(model, tok, port.ExLlamaCache(model),
                                      DraftModelProposer(model, max_draft=8),
                                      seed=SEED)
    sspec.settings.top_k = 1
    sseq = sspec.generate_tokens(ids, 32)
    sgaps = forced_gaps(model, ids[None], sseq[len(ids):],
                        score=lambda logits, g: logits[0])
    st = sspec.stats
    if len(sseq) != len(ids) + 32 or max(sgaps) > LORA_TOL:
        raise AssertionError(f"phase 12 self-draft: {len(sseq) - len(ids)} "
                             f"tokens, gap {max(sgaps):.4f}")
    if 2 * st["accepted"] < st["tokens"]:
        raise AssertionError(f"phase 12 self-draft: {st}: fewer than half "
                             f"the tokens came from drafted rows")
    res["self_draft"] = dict(stats=dict(st), acceptance=sspec.acceptance_rate,
                             max_gap=max(sgaps))
    log(f"  [12] the model as its own draft (max_draft 8): {st}, acceptance "
        f"{sspec.acceptance_rate:.3f}, {st['accepted']} of {st['tokens']} "
        f"tokens from rows 1..k of the verify forwards; every token within "
        f"{max(sgaps):.4f} of the one-token path's best")
    del sspec
    return res


def lora_and_generators(device, launches):
    """Phase 12: the LoRA adapters, the alt generator and speculative
    decoding. Returns its results; adds every launch of the phase (its
    sub-phases count by difference) to ``launches``."""
    import exllama_tpu_torch as port

    out = {}
    zero_counts()
    with tempfile.TemporaryDirectory() as root:
        full = port.ExLlamaConfig()
        files = write_adapters(full, root)
        t0 = time.time()
        out["vs_cpu"] = lora_vs_cpu(device, files)
        log("  [12] 2 layers at full width, zero-mean weights, 64-token "
            "prefill + 4 decode steps, card vs CPU (limit "
            f"{LORA_TOL}; each adapter first moves the card's logits by > "
            f"{3 * LORA_TOL}): " + "; ".join(
                f"{k}: moved {v['moved']:.4f}, within {v['err']:.4f}"
                + (f", without the fold's permutation moved "
                   f"{v['unfolded_moved']:.4f}" if "unfolded_moved" in v
                   else "") + f", launches a step {v['step']}"
                for k, v in out["vs_cpu"].items())
            + f" ({time.time() - t0:.1f} s)")
        mp = MainPath(device)
        mp.use_model(port.ExLlama(mp.cfg, params=centered(mp.model.params),
                                  device=device))
        loras = {n: port.ExLlamaLora(mp.model, *f) for n, f in files.items()}
    out["generator"] = lora_generators(mp, loras)
    out["alt"] = alt_generator_path(mp, loras["Q"])
    out["speculative"] = speculative_path(mp, device)
    out["mp"], out["lora_q"] = mp, loras["Q"]
    c = counts()
    launches.update({k: launches.get(k, 0) + v for k, v in c.items()})
    return out


# -------------------------------------------------------------- phase 13

SERVE_SLOTS = 8
SERVE_NEW = 64
SERVE_LATE_STEP = 24        # the twelfth request is submitted at this step
# per batched decode step on the 32-layer model (8 rows; with or without a
# slot under adapter Q, which keeps K7: K1 on qkv without its norm) and per
# 64-token admission chunk (64 rows: K2 on qkv, o, gate|up and down; K3's
# prefill path)
SERVE_STEP = {"q4_gemv": 32, "layer_tail": 32, "dense_gemv": 1,
              "flash_attn": 0, "q4_mlp": 0, "q4_dequant_matmul": 0,
              "head_argmax": 0, "kv_commit": 0}
SERVE_CHUNK = {"q4_dequant_matmul": 128, "flash_attn": 32, "q4_gemv": 0,
               "layer_tail": 0, "dense_gemv": 0, "q4_mlp": 0}
# per speculative verify step (lookahead 4: T = 5 rows at each of the 8
# cursors, 40 rows: K2 on qkv, o, gate|up and down; K3's split-KV decode at
# 5 rows a slot; K4 on the lm_head's 40 rows)
SERVE_SPEC = {"q4_dequant_matmul": 128, "flash_attn": 32, "q4_gemv": 0,
              "layer_tail": 0, "dense_gemv": 1, "q4_mlp": 0,
              "head_argmax": 0, "kv_commit": 0}


def tag_tokenizer():
    """The byte tokenizer with a decode that is injective per token
    (``<id>`` pieces): every token of the 32,000-token vocabulary shows in
    the text, so a stop string can be cut from any output."""
    from exllama_tpu_torch.parallel import worlds

    return worlds.tag_tokenizer()


def serve_specs(vocab):
    """The twelve requests: prompts of 32-512 tokens from a seed, 64 new
    tokens each; even ones greedy (top-k 1, penalty 1.0), odd ones sampled
    (temperature 0.8, top-k 40, top-p 0.65, penalty 1.15); 2, 5 and 9
    under adapter Q; 4 and 8 with a stop string (cut from their text when
    alone); 11 submitted mid-flight."""
    from exllama_tpu_torch.ops.sampling import SamplerSettings

    rng = np.random.default_rng(SEED + 13)
    specs = []
    for i in range(12):
        n = int(rng.integers(32, 513))
        greedy = i % 2 == 0
        specs.append(dict(
            prompt=rng.integers(4, vocab, size=n).astype(np.int32),
            settings=SamplerSettings(temperature=1.0, top_k=1, top_p=0.0,
                                     token_repetition_penalty_max=1.0)
            if greedy else SamplerSettings(
                temperature=0.8, top_k=40, top_p=0.65,
                token_repetition_penalty_max=1.15),
            greedy=greedy, lora=i in (2, 5, 9), stop=i in (4, 8),
            late=i == 11, stop_string=None))
    return specs


def serve_engine(mp, lora, capture=True, **kw):
    """An 8-slot engine on the phase's model with adapter Q registered
    (``kw``: the speculative settings); every admission chunk's, decode
    step's and verify step's launches recorded apart."""
    from exllama_tpu_torch.serve import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        mp.model if capture else eager_twin(mp.model), mp.tok,
        max_slots=SERVE_SLOTS, prefill_bucket=64, attn_bucket=256, seed=SEED,
        **kw)
    eng.lora_id = eng.register_lora(lora)
    eng.counted = {"chunk": [], "step": [], "spec": []}

    def counted(kind, fn):
        def call(*a):
            c0 = counts()
            out = fn(*a)
            eng.counted[kind].append(since(c0))
            return out
        return call

    eng._prefill_chunk = counted("chunk", eng._prefill_chunk)
    eng._run_decode = counted("step", eng._run_decode)
    eng._step_spec = counted("spec", eng._step_spec)
    return eng


def serve_submit(eng, spec):
    return eng.submit(spec["prompt"], SERVE_NEW, settings=spec["settings"],
                      stop_tokens=(-1,),
                      stop_strings=(spec["stop_string"],)
                      if spec["stop_string"] else (),
                      lora_id=eng.lora_id if spec["lora"] else -1)


def serve_scenario(eng, specs):
    """All twelve requests through ``eng`` (the twelfth submitted at step
    SERVE_LATE_STEP); returns (requests, seconds, steps), fenced."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [None if s["late"] else serve_submit(eng, s) for s in specs]
    steps = 0
    while eng.has_work() or None in reqs:
        if steps == SERVE_LATE_STEP:
            reqs[11] = serve_submit(eng, specs[11])
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, steps


def forced_rows(mp, ids, toks, lora, **knobs):
    """The single-sequence generator's logits teacher-forced over ``toks``
    after ``ids`` (``model.forward`` on its cache at B = 1, under ``lora``,
    the tuning ``knobs`` set for the call): [len(toks), V] f32."""
    import exllama_tpu_torch as port

    tuning = mp.model.config.tuning
    old = {k: getattr(tuning, k) for k in knobs}
    for k, v in knobs.items():
        setattr(tuning, k, v)
    try:
        g = port.ExLlamaGenerator(mp.model, mp.tok,
                                  port.ExLlamaCache(mp.model), seed=SEED)
        g.lora = lora
        g.gen_begin(ids[None])
        rows = []
        for t in toks:
            rows.append(mp.model.forward(g.sequence[:, -1:], g.cache,
                                         lora=lora)[0, -1].float())
            g.gen_accept_token(np.array([[t]], np.int32))
    finally:
        for k, v in old.items():
            setattr(tuning, k, v)
    return torch.stack(rows)


def same_engine_state(a, b):
    """The two engines' caches and histories bit-equal."""
    for x, y in zip(a.cache._tensor_lists(), b.cache._tensor_lists()):
        for s, t in zip(x, y):
            if not torch.equal(s, t):
                raise AssertionError("phase 13: graph and eager caches "
                                     "differ")
    if not torch.equal(a._hist, b._hist):
        raise AssertionError("phase 13: graph and eager histories differ")


def greedy_step_rates(eng, specs):
    """The greedy-all 8-slot step: the scenario's first eight prompts, all
    greedy, without an adapter, 400 new tokens each, admitted into
    ``eng``; then the engine's whole ``step()`` timed (20 steps inside one
    attend-length bucket, fenced: the replay, the packed host read and the
    retire loop), its device step alone timed replayed (20 replays, fenced)
    and eager (5 steps), and one replay traced. Returns (ms a ``step()``,
    ms a replayed step, ms an eager step, device launches by name, idle
    share); the last two None where the trace shows no device activity."""
    for s in specs[:SERVE_SLOTS]:       # none finishes before the timing
        eng.submit(s["prompt"], 400, settings=specs[0]["settings"],
                   stop_tokens=(-1,))
    while eng.admitting or eng.queue:
        eng.step()
    if eng._sched_dirty:
        eng._upload(np.array([r is not None for r in eng.slot_req]))
    if eng.num_active != SERVE_SLOTS or not eng._greedy_all:
        raise AssertionError("phase 13: the greedy step is not 8 greedy rows")

    def bucket(steps_ahead):
        return -(-(int(eng.pos.max()) + 1 + steps_ahead) // eng.attn_bucket)

    while bucket(0) != bucket(21):
        eng.step()
    eng.step()                  # captures if this (epoch, bucket) is new
    n_graphs = len(eng.graphs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        eng.step()
    step_ms = (time.perf_counter() - t0) * 1e3 / 20
    if len(eng.graphs) != n_graphs or eng.num_active != SERVE_SLOTS:
        raise AssertionError("phase 13: a capture or a retired slot inside "
                             "the timed step() calls")
    cfg = eng.model.config
    al = min(cfg.max_seq_len, -(-(int(eng.pos.max()) + 1 + 30)
                                // eng.attn_bucket) * eng.attn_bucket)
    decode = eng._run_decode
    decode(al)                  # captures if this (epoch, bucket) is new

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            decode(al)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    graph_ms = timed(20)
    names, idle = trace_step(lambda: decode(al))
    eng.model.capture = False
    try:
        eager_ms = timed(5)
    finally:
        eng.model.capture = True
    return step_ms, graph_ms, eager_ms, names, idle


def spec_serving(mp, lora, specs, plain, limit):
    """The engine's speculative step on the card: the scenario's six greedy
    requests (one under adapter Q, two with stop strings) through an 8-slot
    engine with ``NgramProposer`` at lookahead 4, eager. Each verify forward
    runs T = 5 rows at eight different cursors, samples every position,
    accepts on the device and writes the history under a mask. Each
    request's tokens equal the plain engine's (``plain``, the scenario's
    graphed run) or, from where they part, lie within ``limit`` of the
    single-sequence generator's best, teacher-forced; no stop string leaks;
    every slot ends free; every verify step launches ``SERVE_SPEC``.
    Returns its results."""
    from exllama_tpu_torch.speculative import NgramProposer

    eng = serve_engine(mp, lora, capture=False,
                       spec_proposer=NgramProposer(), spec_lookahead=4)
    todo = [i for i, s in enumerate(specs) if s["greedy"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = {i: serve_submit(eng, specs[i]) for i in todo}
    eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if eng.num_active or len(eng.free) != SERVE_SLOTS:
        raise AssertionError(f"phase 13 spec: slots {eng.slot_req}")
    if not eng.counted["spec"]:
        raise AssertionError("phase 13 spec: no verify step ran")
    for c in eng.counted["spec"]:
        require("phase 13 verify step", c, SERVE_SPEC)
    for c in eng.counted["chunk"]:
        require("phase 13 spec chunk", c, SERVE_CHUNK)
    equal, gaps = [], {}
    for i, r in reqs.items():
        s = specs[i]
        if r.state != "done" or (s["stop"] and s["stop_string"] in r.text):
            raise AssertionError(f"phase 13 spec request {i}: {r.state}, "
                                 f"{r.text!r}")
        if not s["stop"] and len(r.new_tokens) != SERVE_NEW:
            raise AssertionError(f"phase 13 spec request {i}: "
                                 f"{len(r.new_tokens)} tokens")
        if r.new_tokens == plain[i].new_tokens:
            equal.append(i)
            continue
        toks = r.new_tokens
        rows = forced_rows(mp, r.prompt_ids, toks,
                           lora if s["lora"] else None)
        rows[:, mp.tok.bos_token_id] -= 10000.0
        pick = rows[torch.arange(len(toks)), torch.tensor(toks)]
        gaps[i] = ((rows.max(dim=1).values - pick)
                   / rows.abs().max(dim=1).values).max().item()
    if gaps and max(gaps.values()) > limit:
        raise AssertionError(f"phase 13 spec: tokens {gaps} of the logit "
                             f"scale below the generator's best (limit "
                             f"{limit:.4f})")
    st = dict(eng.spec_stats)
    n_tok = sum(len(r.new_tokens) for r in reqs.values())
    return dict(equal=equal, gaps=gaps, stats=st, tokens=n_tok,
                seconds=secs, tps=n_tok / secs,
                verify_steps=len(eng.counted["spec"]),
                plain_steps=len(eng.counted["step"]),
                chunks=len(eng.counted["chunk"]),
                per_verify_step={k: v for k, v in
                                 eng.counted["spec"][0].items() if v})


def api_round_trip(mp):
    """serve.api on 127.0.0.1:0 over a fresh 8-slot engine: four JSON and
    four SSE clients at once, greedy, 16 tokens, the SSE prompts the JSON
    ones (``worlds.api_clients``): every answer 200, each stream ends in
    [DONE] and its deltas join to the JSON text of its prompt; /health
    answers. Returns the texts' lengths."""
    from exllama_tpu_torch.parallel import worlds
    from exllama_tpu_torch.serve import api as serve_api

    api, httpd, _ = serve_api.make_server(mp.model, mp.tok,
                                          max_slots=SERVE_SLOTS)
    try:
        results = worlds.api_clients(httpd.server_address, 4, 16)
        status, body = worlds.http_call(httpd.server_address, "GET",
                                        "/health")
        health = (status, json.loads(body))
    finally:
        httpd.shutdown()
        api.shutdown()
    if len(results) != 8 or any(s != 200 for s, _ in results.values()):
        raise AssertionError(f"phase 13 api: {results}")
    if health[0] != 200 or health[1]["status"] != "ok":
        raise AssertionError(f"phase 13 api /health: {health}")
    lengths = []
    for i in range(4):
        text = json.loads(results[(i, False)][1])["choices"][0]["text"]
        joined, done = worlds.sse_text(results[(i, True)][1])
        if not done or joined != text or not text:
            raise AssertionError(f"phase 13 api stream {i}: {joined!r} vs "
                                 f"{text!r} (ended in [DONE]: {done})")
        lengths.append(len(text))
    return dict(health=health[1], text_chars=lengths)


def ws_round_trip(mp):
    """serve.ws's WsProtocol.handle driven in process by a fake connection
    (``worlds.WsConn``: an async iterator of messages, a list of sent
    frames): echo, getConfig, estimateToken, oneShotInfer and streamInfer
    (greedy, 8 tokens each, the same prompt: the stream joins to the
    one-shot text)."""
    import asyncio

    import exllama_tpu_torch as port
    from exllama_tpu_torch.parallel import worlds
    from exllama_tpu_torch.serve.ws import WsProtocol

    proto = WsProtocol(mp.model, mp.tok, port.ExLlamaCache(mp.model))
    greedy = dict(maxNew=8, top_k=1, temperature=1.0, rep_pen=1.0)
    conn = worlds.WsConn([
        dict(action="echo", request_id="a"),
        dict(action="getConfig", request_id="b"),
        dict(action="estimateToken", request_id="c",
             text="count these tokens"),
        dict(action="oneShotInfer", request_id="d", text="one shot", **greedy),
        dict(action="streamInfer", request_id="e", text="one shot", **greedy)])
    asyncio.run(proto.handle(conn))
    out = conn.sent
    stream = [f for f in out if f["request_id"] == "e"]
    one = next(f for f in out if f["request_id"] == "d")
    ok = (out[0] == {"action": "echo", "request_id": "a"}
          and out[1]["response"]["layers"] == mp.cfg.num_hidden_layers
          and out[1]["response"]["max_seq_len"] == mp.cfg.max_seq_len
          and out[2]["response"] == len("count these tokens")
          and one["utilContext"].startswith("one shot") and one["response"]
          and stream[-1].get("eos") is True
          and "".join(f["response"] for f in stream)
          == stream[-1]["fullResponse"] == one["response"])
    if not ok:
        raise AssertionError(f"phase 13 ws: {out}")
    return dict(frames=len(out), stream_frames=len(stream),
                chars=len(one["response"]))


def webui_round_trip(mp):
    """The web UI's make_server with a temporary sessions directory: GET
    /, /api/populate, and a streamed /api/userinput (8 response tokens)."""
    import http.client

    from exllama_tpu_torch.webui import app as webui_app

    with tempfile.TemporaryDirectory() as sdir:
        httpd, _ = webui_app.make_server(mp.model, mp.tok, s_dir=sdir)
        webui_app.session.max_response_tokens = 8
        try:
            def req(method, path, body=None):
                conn = http.client.HTTPConnection(*httpd.server_address,
                                                  timeout=600)
                conn.request(method, path,
                             None if body is None else json.dumps(body),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                data = r.read()
                conn.close()
                return r.status, data

            s1, index = req("GET", "/")
            s2, state = req("GET", "/api/populate")
            s3, stream = req("POST", "/api/userinput",
                             {"user_input": "hi there"})
            s4, after = req("GET", "/api/populate")
        finally:
            httpd.shutdown()
    packets = [json.loads(x) for x in stream.decode().splitlines()
               if x.strip()]
    cmds = [p["cmd"] for p in packets]
    hist = json.loads(after)["history"]
    if ((s1, s2, s3, s4) != (200,) * 4 or b"exllama_tpu_torch" not in index
            or json.loads(state)["max_seq_len"] != mp.cfg.max_seq_len
            or cmds[0] != "begin_stream" or "append" not in cmds
            or hist[-2]["text"] != "hi there"
            or hist[-1]["author"] != "Chatbort"):
        raise AssertionError(f"phase 13 webui: {(s1, s2, s3, s4)} {cmds} "
                             f"{hist[-2:]}")
    return dict(packets=len(packets))


def serving_path(mp, lora, launches, card):
    """Phase 13: the continuous-batching engine and its front ends on the
    32-layer model of phase 12 (zero-mean weights, adapter Q); ``card`` (the
    card's name and power limit) is printed beside its numbers. Returns its
    results; adds every launch of the phase to ``launches``."""
    import gc

    res = {}
    zero_counts()
    mp.tok = tag_tokenizer()
    specs = serve_specs(mp.cfg.vocab_size)
    t_phase = time.time()

    # each greedy request alone in an 8-slot engine (graphs); the stop
    # strings are cut from their texts
    alone = serve_engine(mp, lora)
    solo = {}
    for i, s in enumerate(specs):
        if not s["greedy"]:
            continue
        r = serve_submit(alone, s)
        alone.run()
        solo[i] = list(r.new_tokens)
        if s["stop"]:
            toks = r.new_tokens
            text = mp.tok.decode(toks)
            j = next(j for j in range(16, SERVE_NEW - 2)
                     if text.find(mp.tok.decode(toks[j:j + 2]))
                     == len(mp.tok.decode(toks[:j])))
            s["stop_string"] = mp.tok.decode(toks[j:j + 2])
            s["stop_at"] = j
    del alone
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}
    for label, capture in (("graphs", True), ("eager", False)):
        eng = serve_engine(mp, lora, capture)
        reqs, secs, steps = serve_scenario(eng, specs)
        runs[label] = (eng, reqs, secs, steps)
    (g, greqs, gsec, gsteps), (e, ereqs, esec, esteps) = (runs["graphs"],
                                                         runs["eager"])
    for i, (a, b) in enumerate(zip(greqs, ereqs)):
        if a.new_tokens != b.new_tokens:
            raise AssertionError(f"phase 13 request {i}: graph "
                                 f"{a.new_tokens} vs eager {b.new_tokens}")
    same_engine_state(g, e)
    if (g.num_active or len(g.free) != SERVE_SLOTS
            or not g.graphs and g.cache.device.type == "cuda"):
        raise AssertionError(f"phase 13: slots {g.slot_req}, free {g.free}")
    for kind, want in (("step", SERVE_STEP), ("chunk", SERVE_CHUNK)):
        for c in g.counted[kind] + e.counted[kind]:
            require(f"phase 13 {kind}", c, want)
    n_tok = sum(len(r.new_tokens) for r in greqs)
    for i, r in enumerate(greqs):
        s = specs[i]
        if r.state != "done" or any(x in r.text for x in ([s["stop_string"]]
                                                          if s["stop"] else [])):
            raise AssertionError(f"phase 13 request {i}: {r.state}, stop "
                                 f"string in {r.text!r}")
        if s["stop"]:
            j = s["stop_at"]
            if (r.new_tokens != solo[i][:j + 2]
                    or r.text != mp.tok.decode(solo[i][:j])):
                raise AssertionError(f"phase 13 request {i} (stop string at "
                                     f"{j}): {r.new_tokens} / {r.text!r}")
        elif s["greedy"] and r.new_tokens != solo[i]:
            raise AssertionError(f"phase 13 greedy request {i}: batched "
                                 f"{r.new_tokens} vs alone {solo[i]}")
        elif len(r.new_tokens) != SERVE_NEW:
            raise AssertionError(f"phase 13 request {i}: "
                                 f"{len(r.new_tokens)} tokens")
    res["scenario"] = dict(
        tokens=n_tok, graph_s=gsec, eager_s=esec, graph_steps=gsteps,
        graph_tps=n_tok / gsec, eager_tps=n_tok / esec,
        chunks=len(g.counted["chunk"]), steps=len(g.counted["step"]),
        graphs=len(g.graphs))
    log(f"  [13] 12 requests (6 greedy, 6 sampled; 3 under adapter Q, 2 with "
        f"a stop string, 1 admitted at step {SERVE_LATE_STEP}) through 8 "
        f"slots: {n_tok} tokens; graphs {gsec:.3f} s = {n_tok / gsec:.1f} "
        f"tok/s ({gsteps} steps, {len(g.graphs)} graphs captured), eager "
        f"{esec:.3f} s = {n_tok / esec:.1f} tok/s; tokens, caches and "
        f"histories of the two bit-equal; greedy requests bit-equal alone "
        f"and batched (the stop-string ones up to their stop); launches "
        f"per batched step {SERVE_STEP} ({len(g.counted['step'])} steps), "
        f"per 64-token admission chunk {SERVE_CHUNK} "
        f"({len(g.counted['chunk'])} chunks) [{card}]")
    del e, runs
    gc.collect()
    torch.cuda.empty_cache()

    # the greedy tokens against the single-sequence generator, teacher-
    # forced; the limit from the spread of two correct one-token routes
    # (the default's K7, the separate K1 / K3) over the first 16 tokens
    gaps, spread = {}, 0.0
    for i, s in enumerate(specs):
        if not s["greedy"]:
            continue
        toks = greqs[i].new_tokens
        lo = lora if s["lora"] else None
        rows = forced_rows(mp, s["prompt"], toks, lo)
        scale = rows.abs().max(dim=1).values
        banned = rows.clone()
        banned[:, mp.tok.bos_token_id] -= 10000.0     # as the engine bans it
        pick = banned[torch.arange(len(toks)), torch.tensor(toks)]
        gaps[i] = ((banned.max(dim=1).values - pick) / scale).max().item()
        sep = forced_rows(mp, s["prompt"], toks[:16], lo, fuse_mlp=False,
                          fuse_attn=False)
        spread = max(spread, ((sep - rows[:16]).abs().max(dim=1).values
                              / scale[:16]).max().item())
    limit = max(LORA_TOL, 1.5 * spread)
    if max(gaps.values()) > limit:
        raise AssertionError(f"phase 13: greedy tokens {gaps} of the logit "
                             f"scale below the generator's best (limit "
                             f"{limit:.4f}, routes {spread:.4f} apart)")
    res["forced"] = dict(gaps=gaps, spread=spread, limit=limit)
    log(f"  [13] greedy requests teacher-forced on the single-sequence "
        f"generator: worst token {max(gaps.values()):.4f} of the logit scale "
        f"below its best (limit {limit:.4f}: 0.03 or 1.5x the {spread:.4f} "
        f"between the default and the separate one-token routes)")

    sp = spec_serving(mp, lora, specs, greqs, limit)
    res["spec"] = sp
    log(f"  [13] speculative serving (NgramProposer, lookahead 4, eager): "
        f"the 6 greedy requests, {sp['tokens']} tokens in "
        f"{sp['seconds']:.3f} s = {sp['tps']:.1f} tok/s; {sp['verify_steps']} "
        f"verify steps at T = 5 x 8 slots, each launching "
        f"{sp['per_verify_step']}; drafted {sp['stats']['drafted']}, "
        f"accepted {sp['stats']['accepted']}; requests {sp['equal']} equal "
        f"to the plain engine's tokens, the others teacher-forced within "
        f"{sp['gaps']} (limit {limit:.4f}) [{card}]")
    gc.collect()
    torch.cuda.empty_cache()

    step_ms, graph_ms, eager_ms, names, idle = greedy_step_rates(g, specs)
    res["greedy_step"] = dict(step_ms=step_ms, graph_ms=graph_ms,
                              eager_ms=eager_ms, step_tps=8e3 / step_ms,
                              graph_tps=8e3 / graph_ms,
                              eager_tps=8e3 / eager_ms)
    log(f"  [13] the greedy-all 8-slot step: the engine's step() (replay, "
        f"packed host read, retire loop) {step_ms:.3f} ms = "
        f"{8e3 / step_ms:.1f} tok/s; its device step alone replayed "
        f"{graph_ms:.3f} ms = {8e3 / graph_ms:.1f} tok/s, eager "
        f"{eager_ms:.3f} ms = {8e3 / eager_ms:.1f} tok/s [{card}]")
    if names is None:
        log("  [13] replay not traced (no device activity in the trace: not "
            "measured)")
    else:
        res["trace"] = dict(launches=sum(names.values()), **idle)
        log(f"  [13] one replayed greedy-all 8-slot step traced: "
            f"{sum(names.values())} device launches in "
            f"{idle['window_us']:.1f} us, busy {idle['busy_us']:.1f} us, "
            f"idle {idle['idle_share']:.1%} [{card}]")
    del g
    gc.collect()
    torch.cuda.empty_cache()

    res["api"] = api_round_trip(mp)
    res["ws"] = ws_round_trip(mp)
    res["webui"] = webui_round_trip(mp)
    log(f"  [13] front ends on the card: api {res['api']}, ws {res['ws']}, "
        f"webui {res['webui']}")
    c = counts()
    launches.update({k: launches.get(k, 0) + v for k, v in c.items()})
    res["cs"] = bench_step(
        "-cs 8", ["--synthetic", "7b", "-cs", "8"], {},
        {k: None for k in ("q4_gemv", "layer_tail", "dense_gemv",
                           "q4_dequant_matmul", "flash_attn")},
        launches)["streams"]
    log(f"  [13] benchmark -cs 8: {res['cs']['tokens']} tokens in "
        f"{res['cs']['seconds']:.3f} s = {res['cs']['tps']:.1f} tok/s "
        f"({time.time() - t_phase:.1f} s in the phase) [{card}]")
    return res


# -------------------------------------------------------------- phase 14

PAR_SEED = SEED + 14
WORLDS = "exllama_tpu_torch.parallel.worlds:"
SEVEN_B = dict(hidden_size=4096, intermediate_size=11008,
               num_attention_heads=32, num_key_value_heads=32, head_dim=128,
               num_hidden_layers=32, vocab_size=32000)
PAR_LEN = 1024                 # max_seq_len of the tp and engine models
PAR_PROMPT, PAR_STEPS = 512, 32
TP4_LAYERS, TP4_STEPS = 8, 8   # tp = 4: four ranks on one card, depth cut
SP_CONTEXT, SP_STEPS = 2048, 4
ENGINE_SLOTS, ENGINE_NEW = 8, 32
# the front ends over tp = 2: 4 JSON + 4 SSE clients, 16 greedy tokens each;
# ws and the web UI 8 tokens a generation; a follower that misses the stop
# message fails its relay after RELAY_S seconds, inside the world's timeout.
# Their model's depth is cut to FRONT_LAYERS (the checks compare ranks with
# each other and with direct calls on the same ranks, not with a reference)
# to keep the script inside its time limit on a slow host
FRONT_CLIENTS, FRONT_NEW, FRONT_GEN_NEW, RELAY_S = 4, 16, 8, 300
FRONT_LAYERS = 16
PAR_DEVICE = "cuda"            # where the ranks run their tensors
PAR_BACKEND = "gloo"           # NCCL refuses two ranks on one device
# the collectives the parallel paths need from the backend on CUDA tensors
PAR_NEEDS = ("all_reduce_sum_f32", "all_reduce_max_f32",
             "all_reduce_sum_int32", "all_gather_into_tensor")


def par_fields(layers=32, length=PAR_LEN):
    return dict(SEVEN_B, num_hidden_layers=layers, max_seq_len=length,
                max_input_len=length, max_attention_size=length ** 2)


def per_layer(layers, **per):
    """Launches a step or prefill at ``layers`` layers: {kernel: n a layer}
    times the depth (``"head"`` entries: once)."""
    return {k: (n if k in ("dense_gemv", "head_argmax") else n * layers)
            for k, n in per.items()}


def tp_want(layers):
    """Per-rank launches under tp (phase 7's separate route: no K6 / K7):
    a decode step K1 4 a layer (qkv, o, gate|up, down), K3 1, K4 1; the
    greedy head's step K5 1 instead of K4; a prefill K2 4 a layer, K3 1."""
    step = per_layer(layers, q4_gemv=4, flash_attn=1, dense_gemv=1,
                     layer_tail=0, q4_mlp=0, head_argmax=0)
    argmax = dict(step, dense_gemv=0, head_argmax=1)
    prefill = per_layer(layers, q4_dequant_matmul=4, flash_attn=1,
                        layer_tail=0, q4_mlp=0)
    return step, argmax, prefill


def need(name, got, want):
    """``require`` on a rank's counts, which list only what moved."""
    require(name, {k: got.get(k, 0) for k in want}, want)


def rel_rows(a, b):
    """max |a - b| over max |b|, per row, worst row."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b).max(axis=-1)
                  / np.abs(b).max(axis=-1)).max())


def whole_reference(spec, device):
    """The unsharded model of ``spec`` on the card, teacher-forced through
    the same prompt, steps and greedy-head token: the default route, and
    the separate route (fusions off; tp runs the same kernels split). The
    spread of the two routes sets the limit: phase 13's rule,
    max(0.03, 1.5 x spread). Returns (default run, separate run, limit)."""
    from exllama_tpu_torch.parallel import worlds

    model = worlds.build_model(spec, None, device)
    forced = np.concatenate([spec["forced"], np.full(
        (1, 1), spec["argmax_token"], np.int32)], axis=1)
    runs = []
    for fuse in (True, False):
        model.config.tuning.fuse_mlp = model.config.tuning.fuse_attn = fuse
        runs.append(worlds.forced_run(model, spec["prompt"], forced, 1))
    spread = max(rel_rows(runs[1]["prefill"], runs[0]["prefill"]),
                 rel_rows(runs[1]["steps"], runs[0]["steps"]))
    del model
    torch.cuda.empty_cache()
    return runs[0], runs[1], max(LORA_TOL, 1.5 * spread)


def check_tp(label, ranks, ref, limit, layers):
    """Every rank: the same bits; prefill and steps within ``limit`` of the
    unsharded default route; the greedy head's pick within it too; the
    per-rank launches of tp_want. Returns the worst reading."""
    step, argmax, prefill = tp_want(layers)
    n = len(ranks[0]["steps"])
    worst = max(rel_rows(ranks[0]["prefill"], ref["prefill"]),
                rel_rows(ranks[0]["steps"], ref["steps"][:n]))
    if worst > limit:
        raise AssertionError(f"phase 14 {label}: logits {worst:.4f} of the "
                             f"scale from the unsharded model (limit "
                             f"{limit:.4f})")
    row = ref["steps"][n][0]
    pick = ranks[0]["argmax"][0]
    gap = (row.max() - row[pick]) / np.abs(row).max()
    if gap > limit:
        raise AssertionError(f"phase 14 {label}: greedy head picked {pick}, "
                             f"{gap:.4f} of the scale below the best")
    for r in ranks:
        if (not np.array_equal(r["prefill"], ranks[0]["prefill"])
                or not np.array_equal(r["steps"], ranks[0]["steps"])
                or r["tokens"] != ranks[0]["tokens"]
                or r["argmax"] != ranks[0]["argmax"]):
            raise AssertionError(f"phase 14 {label}: rank {r['rank']} "
                                 f"differs from rank 0")
        need(f"phase 14 {label} prefill, rank {r['rank']}",
             r["per_prefill"], prefill)
        for c in r["per_step"]:
            need(f"phase 14 {label} decode step, rank {r['rank']}", c, step)
        need(f"phase 14 {label} greedy-head step, rank {r['rank']}",
             r["per_argmax"], argmax)
    return worst


def shard_shape_cases(device, timer, res):
    """K1 and K3 at the shard shapes of tp = 2 and 4 on Llama-7B, held
    against their plain versions and timed beside their bounds (phase 3's
    recorder): o at K = 4096 / tp; down at K = 5504 (tp = 2) and 2816 (tp =
    4: 2752 padded to whole groups); qkv at N = 12288 / tp with the input
    norm; K3's decode at past 2000 on 32 / tp heads."""
    from exllama_tpu_torch.formats.gptq import dequantize_t, tp_chunk
    from exllama_tpu_torch.ops import attention, quant

    gen = torch.Generator(device=device).manual_seed(PAR_SEED)
    record = make_recorder(timer, res)
    for tp in (2, 4):
        for nm, k, n, norm in (("o", 4096 // tp, 4096, False),
                               ("down", tp_chunk(11008, tp, 128), 4096, False),
                               ("qkv", 4096, 12288 // tp, True)):
            qt = random_qt(gen, k, n, 128, False, device)
            w = dequantize_t(qt)
            nw = ((torch.rand(k, generator=gen, device=device) + 0.5)
                  .bfloat16() if norm else None)
            x = torch.randn((1, k), generator=gen, device=device).bfloat16()
            got = quant.q4_gemv(x, qt, nw, 1e-6)
            ref = quant.q4_gemv_plain(x, qt, nw, 1e-6)
            label = f"tp{tp} {nm} {k}->{n} g128 M=1" + (" norm" if norm
                                                       else "")
            err, rel = check_close(f"q4_gemv {label}", got, ref,
                                   TOL["q4_gemv"])
            record("q4_gemv", label, err, rel,
                   lambda: quant.q4_gemv(x, qt, nw, 1e-6),
                   lambda: quant.q4_gemv_plain(x, qt, nw, 1e-6),
                   lambda: torch.matmul(x, w),
                   q4_bytes(k, n, 128) + 2 * k + 2 * n
                   + (2 * k if norm else 0), 2 * k * n)
            del w
        heads, d, past, alen = 32 // tp, 128, 2000, 2048
        q = torch.randn((1, 1, heads, d), generator=gen,
                        device=device).bfloat16()
        kc, vc = (torch.randn((1, heads, alen, d), generator=gen,
                              device=device).bfloat16() for _ in range(2))
        new_kv = tuple(torch.randn((1, 1, heads, d), generator=gen,
                                   device=device).bfloat16()
                       for _ in range(2))
        got = attention.attend(q, kc, vc, past, alen, None, new_kv)
        ref = attention.attend_plain(q, kc, vc, past, alen, None, new_kv)
        label = f"tp{tp} decode past={past} {heads} heads"
        err, rel = check_close(f"flash_attn {label}", got, ref,
                               TOL["flash_attn"])
        qh, ks, vs = q.transpose(1, 2), kc[:, :, :past], vc[:, :, :past]
        record("flash_attn", label, err, rel,
               lambda: attention.attend(q, kc, vc, past, alen, None, new_kv),
               lambda: attention.attend_plain(q, kc, vc, past, alen, None,
                                              new_kv),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qh, ks, vs),
               2 * q.numel() * 2 + 2 * past * heads * d * 2
               + 2 * heads * d * 2, 4 * d * heads * (past + 1), iters=10)


def engine_reference(spec, device, results):
    """The unsharded engine on the same model and requests, and the
    sharded engine's tokens teacher-forced on the unsharded model: each
    within phase 13's limit of the best (0.03, or 1.5x the spread of the
    default and separate one-token routes over the first 16 tokens).
    Returns (requests equal to the unsharded engine's, worst gap, limit)."""
    from types import SimpleNamespace

    from exllama_tpu_torch.parallel import worlds
    from exllama_tpu_torch.tokenizer import FakeTokenizer

    model = worlds.build_model(spec, None, device)
    ref = unsharded_engine_tokens(model, spec)
    mp = SimpleNamespace(model=model, tok=FakeTokenizer())
    gaps, spread, equal = [], 0.0, 0
    for i, prompt in enumerate(spec["prompts"]):
        toks = results[0]["tokens"][i]
        equal += toks == ref[i]
        rows = forced_rows(mp, prompt, toks, None)
        scale = rows.abs().max(dim=1).values
        banned = rows.clone()
        banned[:, mp.tok.bos_token_id] -= 10000.0
        pick = banned[torch.arange(len(toks)), torch.tensor(toks)]
        gaps.append(((banned.max(dim=1).values - pick) / scale).max().item())
        sep = forced_rows(mp, prompt, toks[:16], None, fuse_mlp=False,
                          fuse_attn=False)
        spread = max(spread, ((sep - rows[:16]).abs().max(dim=1).values
                              / scale[:16]).max().item())
    del model
    torch.cuda.empty_cache()
    return equal, max(gaps), max(LORA_TOL, 1.5 * spread)


def unsharded_engine_tokens(model, spec):
    """The unsharded engine's greedy tokens for ``spec``'s requests."""
    from exllama_tpu_torch.ops.sampling import SamplerSettings
    from exllama_tpu_torch.serve import ContinuousBatchingEngine
    from exllama_tpu_torch.tokenizer import FakeTokenizer

    eng = ContinuousBatchingEngine(model, FakeTokenizer(),
                                   max_slots=spec["slots"],
                                   prefill_bucket=spec["bucket"],
                                   attn_bucket=spec["attn_bucket"])
    greedy = SamplerSettings(temperature=1.0, top_k=1, top_p=0.0,
                             token_repetition_penalty_max=1.0)
    reqs = [eng.submit(p, spec["new"], settings=greedy, stop_tokens=(-1,))
            for p in spec["prompts"]]
    eng.run()
    return [list(r.new_tokens) for r in reqs]


def causal_attention(q, k, v):
    """Full causal attention in f32, plain: q [B, T, H, D], k / v [B, T,
    Hkv, D] -> [B, T, H, D]."""
    from exllama_tpu_torch.ops import full_f32_matmul

    b, t, h, d = q.shape
    hkv = k.shape[2]
    qf = q.reshape(b, t, hkv, h // hkv, d)
    with full_f32_matmul():
        s = torch.einsum("bthgd,bshd->bhgts", qf, k) / math.sqrt(d)
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        o = torch.einsum("bhgts,bshd->bthgd", p, v)
    return o.reshape(b, t, h, d)


def check_front_ends(ranks, card) -> dict:
    """Phase 14's front ends over tp = 2 (``worlds.front_ends``, one result
    a rank): serve.api's answers (200, each stream joins to its JSON text),
    every request's tokens the same on both ranks and bit for bit those of
    the same requests submitted directly to an engine on every rank, both
    ranks the same steps with tp's launches a step (K1 128, K3 32, K4 1)
    and an admission chunk (K2 128, K3 32), one relay message a step;
    serve.ws and the web UI through the mirrored generator: rank 0's text
    that of the same calls made directly on every rank, every rank the
    same sequence; the beam-search refusal on rank 0, the follower's loop
    ended. Logs the relay's cost. Returns the readings, and rank 0's
    launch counts under ``counted``."""
    api = [r["api"] for r in ranks]
    lead = api[0]
    bad = [t for t in lead["texts"] if t["status"] != [200, 200]
           or not t["done"] or t["stream"] != t["json"] or not t["json"]]
    if bad or lead["health"][0] != 200:
        raise AssertionError(f"phase 14 api over tp = 2: {bad} "
                             f"{lead['health']}")
    step = per_layer(FRONT_LAYERS, q4_gemv=4, flash_attn=1, dense_gemv=1,
                     layer_tail=0, q4_mlp=0)
    chunk = per_layer(FRONT_LAYERS, q4_dequant_matmul=4, flash_attn=1,
                      layer_tail=0, q4_mlp=0)
    for r in api:
        if (r["tokens"] != lead["tokens"] or r["direct"] != lead["tokens"]
                or r["req_ids"] != lead["req_ids"]
                or r["steps"] != lead["steps"]
                or r.get("follow_steps", r["steps"]) != r["steps"]
                or r["messages"] != lead["steps"] + 1):
            raise AssertionError(
                f"phase 14 api over tp = 2: a rank's tokens, steps or "
                f"messages differ: tokens {r['tokens']} direct "
                f"{r['direct']} vs rank 0 {lead['tokens']}; steps "
                f"{r['steps']} / {lead['steps']}, messages {r['messages']}")
        for c in r["per_step"]:
            need("phase 14 api step", c, step)
        for c in r["per_chunk"]:
            need("phase 14 api admission chunk", c, chunk)
    if len(lead["tokens"]) != 2 * FRONT_CLIENTS or any(
            len(t) != FRONT_NEW for t in lead["tokens"]):
        raise AssertionError(f"phase 14 api: {lead['tokens']}")
    gens = {}
    for part in ("ws", "webui"):
        rs = [r[part] for r in ranks]
        got = rs[0]["frames"] if part == "ws" else rs[0]["texts"]
        if (got != rs[0]["direct"] or not got
                or any(r["direct"] != got or r["sequence"]
                       != rs[0]["sequence"] for r in rs)
                or any(r["follow"]["errors"] for r in rs[1:])):
            raise AssertionError(f"phase 14 {part} over tp = 2: rank 0 "
                                 f"{got} vs direct {rs[0]['direct']}")
        gens[part] = rs[0]
    if [f for f in gens["ws"]["frames"] if f.get("eos")
            and not f["fullResponse"]] or not all(gens["webui"]["texts"]):
        raise AssertionError("phase 14 ws / webui over tp = 2: an empty "
                             "response")
    beams = ranks[0]["beams"]["raised"] or ""
    if (not beams.startswith("NotImplementedError")
            or ranks[1]["beams"]["errors"] != [beams]):
        raise AssertionError(f"phase 14 beam refusal over the relay: "
                             f"{ranks[0]['beams']} / {ranks[1]['beams']}")
    cost = {part: dict(messages=r["messages"],
                       ms_a_message=1e3 * r["relay_s"] / r["messages"],
                       seconds=r["seconds"])
            for part, r in (("api", lead), ("ws", gens["ws"]),
                            ("webui", gens["webui"]))}
    cost["api"]["messages_a_step"] = (lead["messages"] - 1) / lead["steps"]
    log(f"  [14] serve.api over tp = 2 ({FRONT_LAYERS} layers at 7B width, "
        f"rank 0 "
        f"serving on 127.0.0.1:0, the other rank following): "
        f"{FRONT_CLIENTS} JSON + {FRONT_CLIENTS} SSE clients at once, "
        f"greedy, {FRONT_NEW} tokens: every answer 200, each stream joined "
        f"to its JSON text, every request's tokens on both ranks equal bit "
        f"for bit to the same requests submitted directly to an engine on "
        f"both ranks; {lead['steps']} steps on each rank, a step "
        f"{lead['per_step'][0]}, an admission chunk {lead['per_chunk'][0]}; "
        f"relay {cost['api']['messages']} messages "
        f"({cost['api']['messages_a_step']:.3f} a step, and the stop), "
        f"{cost['api']['ms_a_message']:.3f} ms a message on rank 0; "
        f"{lead['seconds']:.2f} s served [{card}]")
    log(f"  [14] serve.ws and the web UI over tp = 2 through the mirrored "
        f"generator: rank 0's frames / texts equal the same calls made "
        f"directly on both ranks, both ranks the same sequence "
        f"({len(gens['ws']['sequence'][0])} / "
        f"{len(gens['webui']['sequence'][0])} tokens); ws "
        f"{cost['ws']['messages']} messages, "
        f"{cost['ws']['ms_a_message']:.3f} ms a message; web UI "
        f"{cost['webui']['messages']} messages, "
        f"{cost['webui']['ms_a_message']:.3f} ms a message; beam search "
        f"refused on rank 0 ({beams[:60]}...), the follower stopped [{card}]")
    return dict(relay=cost, steps=lead["steps"], per_step=lead["per_step"][0],
                per_chunk=lead["per_chunk"][0],
                counted=lead["per_step"] + lead["per_chunk"])


def gloo_coverage() -> dict:
    """Which collectives gloo runs on CUDA tensors here, each in a world of
    two ranks on the one card: the collectives in one world, the
    point-to-point ring in a world of its own (gloo's TCP transport may
    abort the process on a device pointer rather than raise). A probe that
    took its world down reads "aborted the process"."""
    from exllama_tpu_torch.parallel.launch import run_world
    from exllama_tpu_torch.parallel.worlds import PROBES

    cov = {}
    for probes in (PROBES[:-1], PROBES[-1:]):
        with tempfile.TemporaryDirectory() as tmp:
            note = os.path.join(tmp, "probes")
            spec = dict(device=PAR_DEVICE, probes=probes, log=note)
            try:
                cov.update(run_world(WORLDS + "collectives", 2, (spec,),
                                     backend=PAR_BACKEND, timeout=240,
                                     collective_timeout=60)[0])
            except Exception as e:      # noqa: BLE001 - the finding itself
                lines = (open(note).read().splitlines()
                         if os.path.exists(note) else [])
                for line in lines:
                    if ": " in line:
                        k, v = line.split(": ", 1)
                        cov[k] = v
                last = lines[-1] if lines else ""
                if last.startswith("start "):
                    cov[last[6:]] = "aborted the process"
                cov.setdefault("world", str(e).strip().splitlines()[-1][:200])
    return cov


def parallel_path(device, card, launches, res):
    """Phase 14: tensor, sequence and data parallelism as ranks of gloo
    worlds on the one card (``parallel.launch.run_world``: one process a
    rank, ``torch.multiprocessing`` spawn, a file store; NCCL refuses two
    ranks on one device). Which collectives gloo runs on CUDA tensors; tp =
    2 on the 32-layer 7B (a 512-token prompt, 32 teacher-forced steps, one
    greedy-head step), sp = 2 (steps at a 2,048-token context; the ring
    prefill, its passes host-staged) and the front ends over tp = 2
    (``check_front_ends``) in one world of two;
    tp = 4 (8 layers: the uneven down split) and the engine at dp = 2 x tp
    = 2 (8 slots, four greedy requests) in one world of four; each route
    held against the unsharded port on the card within phase 13's rule,
    with its per-rank launches; the shard shapes' kernel times (filed in
    ``res`` beside phase 3's cases). Rank 0's launches go into
    ``launches``. Returns the phase's numbers."""
    from exllama_tpu_torch.parallel.launch import run_world

    out = {}
    t0 = time.time()
    cov = gloo_coverage()
    out["gloo_cuda"] = cov
    log(f"  [14] gloo on CUDA tensors (torch {torch.__version__}, 2 ranks "
        f"on one card): {json.dumps(cov)} ({time.time() - t0:.1f} s)")
    missing = [k for k in PAR_NEEDS if cov.get(k) != "ok"]
    if missing:
        raise AssertionError(f"phase 14: gloo cannot run {missing} on CUDA "
                             f"tensors: {cov}")

    rng = np.random.default_rng(PAR_SEED)

    def ids(*shape):
        return rng.integers(4, SEVEN_B["vocab_size"], shape).astype(np.int32)

    tp2 = dict(cfg=par_fields(), tuning={}, tp=2, gs=128, seed=PAR_SEED,
               fast=True, centered=True, device=PAR_DEVICE,
               prompt=ids(1, PAR_PROMPT), forced=ids(1, PAR_STEPS),
               argmax_token=int(ids(1)[0]))
    tp4 = dict(tp2, cfg=par_fields(TP4_LAYERS), tp=4, seed=PAR_SEED + 1,
               prompt=ids(1, PAR_PROMPT), forced=ids(1, TP4_STEPS),
               argmax_token=int(ids(1)[0]))
    sp2 = dict(cfg=par_fields(length=SP_CONTEXT), tuning={}, gs=128,
               seed=PAR_SEED + 2, fast=True, centered=True, device=PAR_DEVICE,
               prompt=ids(1, SP_CONTEXT - SP_STEPS), forced=ids(1, SP_STEPS),
               reference=True, separate=True)
    engine = dict(cfg=par_fields(), tuning={}, tp=2, dp=2, gs=128,
                  seed=PAR_SEED + 3, fast=True, centered=True, device=PAR_DEVICE,
                  slots=ENGINE_SLOTS, bucket=64, attn_bucket=256,
                  prompts=[ids(int(n)) for n in rng.integers(32, 129, 4)],
                  new=ENGINE_NEW)
    front = dict(cfg=par_fields(FRONT_LAYERS), tuning={}, tp=2, gs=128,
                 seed=PAR_SEED + 4,
                 fast=True, centered=True, device=PAR_DEVICE,
                 slots=SERVE_SLOTS, clients=FRONT_CLIENTS, new=FRONT_NEW,
                 gen_new=FRONT_GEN_NEW, relay_timeout=RELAY_S)

    t0 = time.time()
    ref2, sep2, lim2 = whole_reference(tp2, device)
    ref4, sep4, lim4 = whole_reference(tp4, device)
    log(f"  [14] unsharded references on the card ({time.time() - t0:.1f} "
        f"s): 32 layers, decode step median "
        f"{statistics.median(ref2['ms']):.3f} ms default / "
        f"{statistics.median(sep2['ms']):.3f} ms separate (eager); limits "
        f"{lim2:.4f} (32 layers), {lim4:.4f} ({TP4_LAYERS} layers) [{card}]")

    qkv = [(rng.standard_normal((1, SP_CONTEXT, heads, 128)) * 0.4)
           .astype(np.float32) for heads in (32, 32, 32)]
    runs = [("tp2", "tp_forward", tp2), ("sp2", "sp_decode", sp2),
            ("ring", "sp_ops",
             dict(device=PAR_DEVICE, cases={"ring": ("ring", *qkv)})),
            ("front", "front_ends", front)]
    t0 = time.time()
    two = run_world(WORLDS + "run_all", 2, (runs,),
                    backend=PAR_BACKEND, timeout=600)
    secs_two = time.time() - t0
    tp_ranks = [r["tp2"] for r in two]
    w2 = check_tp("tp = 2", tp_ranks, ref2, lim2, 32)
    ms = [statistics.median(r["ms"]) for r in tp_ranks]
    out["tp2"] = dict(worst=w2, limit=lim2, step_ms=ms,
                      per_step=tp_ranks[0]["per_step"][0],
                      per_prefill=tp_ranks[0]["per_prefill"],
                      per_argmax=tp_ranks[0]["per_argmax"],
                      shapes=tp_ranks[0]["shapes"])
    log(f"  [14] tp = 2, 32 layers at 7B width, {PAR_PROMPT}-token prompt + "
        f"{PAR_STEPS} teacher-forced steps + one greedy-head step: logits "
        f"within {w2:.4f} of the unsharded model's scale (limit {lim2:.4f}), "
        f"both ranks the same bits and tokens; per rank a step "
        f"{out['tp2']['per_step']}, a prefill {out['tp2']['per_prefill']}, "
        f"the greedy step {out['tp2']['per_argmax']}; layer-0 shapes "
        f"{out['tp2']['shapes']}; decode step median per rank "
        f"{', '.join(f'{m:.3f}' for m in ms)} ms (eager, gloo all-reduces "
        f"through the host; one card shared by both ranks: not a scaling "
        f"figure) [{card}]")

    sp_ranks = [r["sp2"] for r in two]
    sp_spread = rel_rows(sp_ranks[0]["separate"], sp_ranks[0]["reference"])
    sp_lim = max(LORA_TOL, 1.5 * sp_spread)
    for r in sp_ranks:
        worst = rel_rows(r["steps"], r["reference"])
        if worst > sp_lim or not np.array_equal(r["steps"],
                                                sp_ranks[0]["steps"]):
            raise AssertionError(f"phase 14 sp = 2: {worst:.4f} of the scale "
                                 f"from the unsharded steps (limit "
                                 f"{sp_lim:.4f}), or the ranks differ")
        for c in r["per_step"]:
            need("phase 14 sp = 2 step", c, per_layer(
                32, q4_gemv=4, flash_attn=0, layer_tail=0, dense_gemv=0))
    out["sp2"] = dict(worst=rel_rows(sp_ranks[0]["steps"],
                                     sp_ranks[0]["reference"]),
                      limit=sp_lim, positions=sp_ranks[0]["positions"],
                      step_ms=[statistics.median(r["ms"]) for r in sp_ranks],
                      per_step=sp_ranks[0]["per_step"][0])
    log(f"  [14] sp = 2, 32 layers, {SP_STEPS} steps at a {SP_CONTEXT}-token "
        f"context ({out['sp2']['positions']} positions a rank): within "
        f"{out['sp2']['worst']:.4f} of the unsharded steps (limit "
        f"{sp_lim:.4f}), both ranks the same bits; per rank a step "
        f"{out['sp2']['per_step']} (attention and head plain), median "
        f"{', '.join(f'{m:.3f}' for m in out['sp2']['step_ms'])} ms [{card}]")
    want = causal_attention(*(torch.from_numpy(a).to(device)
                              for a in qkv)).cpu().numpy()
    got = np.concatenate([r["ring"]["ring"] for r in two], axis=1)
    err = float(np.abs(got - want).max())
    if err > 3e-3:
        raise AssertionError(f"phase 14 ring prefill: {err} (limit 3e-3)")
    times = [r["ring"]["timing"]["ring"] for r in two]
    out["ring"] = dict(err=err, timing=times)
    ring_ms = ", ".join(f"{t['ring_ms']:.3f}" for t in times)
    pass_ms = ", ".join(f"{t['pass_ms']:.3f}" for t in times)
    log(f"  [14] ring prefill attention at T = {SP_CONTEXT} over 2 ranks, "
        f"f32 blocks, each pass host-staged (CUDA -> host -> gloo "
        f"batch_isend_irecv -> CUDA; the direct probe above reads "
        f"{cov.get('batch_isend_irecv')!r}): within {err:.2g} of full "
        f"causal attention (limit 3e-3); per rank the whole ring {ring_ms} "
        f"ms, one pass of its two K / V blocks ({times[0]['pass_bytes']} "
        f"bytes) {pass_ms} ms (median of 3) [{card}]")
    out["front"] = check_front_ends([r["front"] for r in two], card)
    for c in out["front"].pop("counted"):
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    del two
    t0 = time.time()
    four = run_world(WORLDS + "run_all", 4,
                     ([("tp4", "tp_forward", tp4),
                       ("engine", "engine_tokens", engine)],),
                     backend=PAR_BACKEND, timeout=600)
    secs_four = time.time() - t0
    tp4_ranks = [r["tp4"] for r in four]
    w4 = check_tp("tp = 4", tp4_ranks, ref4, lim4, TP4_LAYERS)
    out["tp4"] = dict(worst=w4, limit=lim4, shapes=tp4_ranks[0]["shapes"],
                      per_step=tp4_ranks[0]["per_step"][0],
                      step_ms=[statistics.median(r["ms"]) for r in tp4_ranks])
    log(f"  [14] tp = 4, {TP4_LAYERS} layers at 7B width (depth cut: four "
        f"ranks on one card): within {w4:.4f} (limit {lim4:.4f}); "
        f"layer-0 shapes {out['tp4']['shapes']} (down's 2752 rows a rank "
        f"padded to 2816); per rank a step {out['tp4']['per_step']} [{card}]")

    eng = [r["engine"] for r in four]
    for r in eng:
        if r["tokens"] != eng[0]["tokens"] or r["free"] != ENGINE_SLOTS:
            raise AssertionError(f"phase 14 engine: rank {r['rank']} "
                                 f"differs or holds slots")
        for c in r["per_step"]:
            need("phase 14 engine step", c, per_layer(
                32, q4_gemv=4, flash_attn=1, dense_gemv=1, layer_tail=0,
                q4_mlp=0))
        for c in r["per_chunk"]:
            need("phase 14 engine admission chunk", c,
                 per_layer(32, q4_dequant_matmul=4, flash_attn=1))
    t0 = time.time()
    equal, gap, elim = engine_reference(engine, device, eng)
    if gap > elim:
        raise AssertionError(f"phase 14 engine: a token {gap:.4f} of the "
                             f"scale below the unsharded best (limit "
                             f"{elim:.4f})")
    n_tok = sum(len(t) for t in eng[0]["tokens"])
    out["engine"] = dict(equal=equal, gap=gap, limit=elim, tokens=n_tok,
                         seconds=eng[0]["seconds"], rows=[r["rows"]
                                                          for r in eng],
                         per_step=eng[0]["per_step"][0],
                         per_chunk=eng[0]["per_chunk"][0])
    log(f"  [14] engine at dp = 2 x tp = 2, {ENGINE_SLOTS} slots (each "
        f"replica 4 of them: {out['engine']['rows']}), four greedy requests "
        f"of {ENGINE_NEW} tokens: every rank the same tokens, {equal} of 4 "
        f"requests equal to the unsharded engine's, every token within "
        f"{gap:.4f} of the unsharded model's best, teacher-forced (limit "
        f"{elim:.4f}); per rank a step {out['engine']['per_step']}, an "
        f"admission chunk {out['engine']['per_chunk']}; {n_tok} tokens in "
        f"{eng[0]['seconds']:.2f} s (eager) [{card}] "
        f"({time.time() - t0:.1f} s of references)")
    out["world_seconds"] = dict(two_ranks=secs_two, four_ranks=secs_four)

    t0 = time.time()
    mine = {}
    shard_shape_cases(device, Timer(device), mine)
    for k, cases in mine.items():
        res[k].extend(cases)
    out["shard_kernels"] = mine
    log(f"  [14] shard-shape kernels ({time.time() - t0:.1f} s) [{card}]")
    for r in (tp_ranks[0], sp_ranks[0], tp4_ranks[0], eng[0]):
        for c in ([r.get("per_prefill", {})] + r["per_step"]
                  + r.get("per_chunk", []) + [r.get("per_argmax", {})]):
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
    return out


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
    "head_argmax": ("exllama_tpu_torch/csrc/head_argmax.cu",
                    "exllama_tpu/ops/dense.py:81", "lm_head 4096->32000 M=1"),
    "q4_mlp": ("exllama_tpu_torch/csrc/q4_mlp.cu",
               "exllama_tpu/ops/mlp.py:153", "g128 M=1"),
    "layer_tail": ("exllama_tpu_torch/csrc/layer_tail.cu",
                   "exllama_tpu/ops/attn_block.py:91",
                   "layer_tail B=1 past=2000"),
    "kv_commit": ("exllama_tpu_torch/csrc/kv_commit.cu",
                  "exllama_tpu/ops/attention.py:173", "L=32 B=1 Hkv=32 [1]"),
    "q4_gemv_a8": ("exllama_tpu_torch/csrc/q4_gemv.cu",
                   "exllama_tpu/ops/quant.py:333", "a8 qkv g128 M=1 norm"),
    "q4_prefill_a8": ("exllama_tpu_torch/csrc/q4_prefill_a8.cu",
                      "exllama_tpu/ops/quant.py:776", "o g128 M=1919"),
    "w8_matmul": ("exllama_tpu_torch/csrc/w8_matmul.cu",
                  "exllama_tpu/ops/quant.py:1273", "gateup M=1919"),
    "q4_matmul_glu": ("exllama_tpu_torch/csrc/q4_matmul.cu",
                      "exllama_tpu/ops/quant.py:654", "down g128 M=1919"),
}
# the same kernels over a quantized KV cache, listed beside the bf16 ones
for _kind in KV_KINDS:
    for _name, _case in (("flash_attn", "decode past=2000"),
                         ("layer_tail", "layer_tail B=1 past=2000"),
                         ("kv_commit", "L=32 B=1 Hkv=32 [1]")):
        SOURCES[f"{_name}_{_kind}"] = (*SOURCES[_name][:2], f"{_kind} {_case}")
# and their f32-scale builds (-DSCALE_F32=1), the cases of f32_scale_cases
for _name, _case in (("q4_gemv", "qkv g128 M=1 norm"),
                     ("q4_dequant_matmul", "4096->22016 g128 M=1919"),
                     ("q4_mlp", "g128 M=1"),
                     ("layer_tail", "layer_tail B=1 past=2000"),
                     ("q4_gemv_a8", "a8 qkv g128 M=1 norm"),
                     ("q4_prefill_a8", "4096->4096 g128 M=1919"),
                     ("q4_matmul_glu", "11008->4096 g128 M=1919")):
    SOURCES[f"{_name}_f32"] = (*SOURCES[_name][:2], _case)


# -------------------------------------------------------------- phase 15

P15_NEW = 16            # tokens a generator route decodes in a run
P15_FRONT = 8           # response tokens of a web UI / websocket / chatbot
# turn


def graphs_held(*owners) -> int:
    """Graphs held by ``owners``: caches (the forward's chunk graphs),
    decode loops and engines (``.graphs``), generators (their cache's and
    their loop's)."""
    n = 0
    for o in owners:
        for x in (o, getattr(o, "cache", None), getattr(o, "_loop", None),
                  getattr(o, "_beam_store", None),
                  getattr(o, "scratch", None)):
            n += len(getattr(x, "graphs", None) or ())
    return n


def run_mode(model, capture, fn):
    """``fn()`` with ``model.capture`` set (False: every step eagerly), the
    card synchronised after; returns (its result, the launches during it)."""
    model.capture = capture
    try:
        c0 = counts()
        out = fn()
        torch.cuda.synchronize()
        return out, since(c0)
    finally:
        model.capture = True


def same_run(label, got, ref, c_graph, c_eager):
    """Graph and eager runs of one route from the same state: the tokens
    (np arrays or lists) and tensors (caches, histories) bit-equal, and
    the launches equal (each replay adds the captured step's counts, the
    eager run counts its own)."""
    if len(got["tokens"]) != len(ref["tokens"]) or any(
            not np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(got["tokens"], ref["tokens"])):
        raise AssertionError(f"phase 15 {label}: graph tokens "
                             f"{got['tokens']} vs eager {ref['tokens']}")
    if len(got["tensors"]) != len(ref["tensors"]) or any(
            not torch.equal(a, b)
            for a, b in zip(got["tensors"], ref["tensors"])):
        raise AssertionError(f"phase 15 {label}: graph and eager state "
                             f"differ")
    if ({k: v for k, v in c_graph.items() if v}
            != {k: v for k, v in c_eager.items() if v}):
        raise AssertionError(f"phase 15 {label}: launches graph {c_graph} "
                             f"vs eager {c_eager}")
    if not got["graphs"]:
        raise AssertionError(f"phase 15 {label}: no graph captured")


def cache_tensors(cache):
    return [t for ts in cache._tensor_lists() for t in ts]


def turns15(model, run, n):
    """``run()`` (n tokens) under graphs and eagerly in turns, A B B A,
    fenced; the faster of each as tok/s."""
    best = {}
    for capture in (True, False, False, True):
        model.capture = capture
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
        finally:
            model.capture = True
        dt = time.perf_counter() - t0
        key = "graphs" if capture else "eager"
        best[key] = min(best.get(key, dt), dt)
    return {k: n / v for k, v in best.items()}


def single_token_route(mp, lora, label, **settings):
    """gen_single_token, P15_NEW tokens after a 64-token prompt (its
    63-row prefill one chunk), on a fresh cache; a second turn on the same
    generator with a new temperature and top-p and another prompt of the
    same length. Returns the two runs' results and the generator."""
    port = mp.port

    def make():
        g = port.ExLlamaGenerator(mp.model, mp.tok,
                                  port.ExLlamaCache(mp.model), seed=SEED)
        g.lora = lora
        for k, v in settings.items():
            setattr(g.settings, k, v)
        return g

    def turn(g, ids):
        g.gen_begin(ids)
        toks = [g.gen_single_token() for _ in range(P15_NEW)]
        return dict(tokens=toks, graphs=graphs_held(g),
                    tensors=cache_tensors(g.cache) + [g._seq_buf])

    ids1, ids2 = mp.ids[:, :64], mp.ids[:, 64:128]
    runs = {}
    for capture in (True, False):
        g = make()
        r1, c1 = run_mode(mp.model, capture, lambda: turn(g, ids1))
        g.settings.temperature, g.settings.top_p = 0.7, 0.9
        r2, c2 = run_mode(mp.model, capture, lambda: turn(g, ids2))
        runs[capture] = (g, r1, c1, r2, c2)
    (g, r1, c1, r2, c2), (e, q1, d1, q2, d2) = runs[True], runs[False]
    same_run(f"{label} turn 1", r1, q1, c1, d1)
    same_run(f"{label} turn 2 (temperature 0.7, top-p 0.9)", r2, q2, c2, d2)
    new = r2["graphs"] - r1["graphs"]
    if new:
        raise AssertionError(f"phase 15 {label}: the second turn captured "
                             f"{new} graphs")
    return dict(captures=[r1["graphs"], new], launches_turn=c1,
                tokens=[int(t[0, 0]) for t in r1["tokens"][:6]]), g


def webui_replies(mp, modes, grow=False):
    """One web-UI server (a fresh session), one streamed /api/userinput a
    mode, ``model.capture`` set per reply; with ``grow`` the i-th user
    input is 12 i characters longer than the first. Returns [(reply text,
    seconds, graphs held after it)], the session generator's sequence, its
    cache's tensors and its graphs."""
    import http.client

    from exllama_tpu_torch.webui import app as webui_app
    from exllama_tpu_torch.webui import session as webui_session

    out = []
    with tempfile.TemporaryDirectory() as sdir:
        httpd, _ = webui_app.make_server(mp.model, mp.tok, s_dir=sdir)
        webui_app.session.max_response_tokens = P15_FRONT
        try:
            for i, capture in enumerate(modes):
                conn = http.client.HTTPConnection(*httpd.server_address,
                                                  timeout=600)
                mp.model.capture = capture
                try:
                    t0 = time.perf_counter()
                    more = ", and further" * i if grow else ""
                    conn.request("POST", "/api/userinput", json.dumps(
                        {"user_input": f"hello there{more}, number {i}"}),
                        {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    data = r.read()
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                finally:
                    mp.model.capture = True
                    conn.close()
                if r.status != 200:
                    raise AssertionError(f"phase 15 webui: {r.status}")
                text = "".join(p.get("text", "") for p in (
                    json.loads(x) for x in data.decode().splitlines()
                    if x.strip()) if p.get("cmd") == "append")
                out.append((text, dt,
                            graphs_held(webui_session.generator)))
            gen = webui_session.generator
            state = (gen.sequence_actual.copy(), cache_tensors(gen.cache),
                     graphs_held(gen))
        finally:
            httpd.shutdown()
    return out, state


def ws_streams(mp, proto, modes):
    """One greedy streamInfer of P15_FRONT tokens a mode on ``proto``
    (``serve.ws.WsProtocol``), ``model.capture`` set per message. Returns
    [(the frames, seconds)]."""
    import asyncio

    from exllama_tpu_torch.parallel import worlds

    out = []
    for i, capture in enumerate(modes):
        msg = dict(action="streamInfer", request_id=f"s{i}",
                   text=f"stream number {i % 2}", maxNew=P15_FRONT, top_k=1,
                   temperature=1.0, rep_pen=1.0)
        conn = worlds.WsConn([msg])
        mp.model.capture = capture
        try:
            t0 = time.perf_counter()
            asyncio.run(proto.handle(conn))
            torch.cuda.synchronize()
            out.append((conn.sent, time.perf_counter() - t0))
        finally:
            mp.model.capture = True
    return out


def chatbot_turns(mp, g, lines):
    """The chatbot example's loop (examples/example_chatbot.py) on ``g``:
    its sampler settings, a persona prompt, then per line the user's turn
    fed and up to P15_FRONT response tokens by gen_single_token, broken on
    a newline or on the model speaking for the user. Returns the response
    tokens a line."""
    tok = mp.tok
    s = g.settings
    s.temperature, s.top_k, s.top_p = 0.95, 20, 0.65
    s.token_repetition_penalty_max = 1.15
    s.token_repetition_penalty_sustain = mp.cfg.max_seq_len // 2
    g.gen_begin(tok.encode("This is a conversation between User and a "
                           "curious chatbot named Chatbort.\n"))
    out = []
    for line in lines:
        g.gen_feed_tokens(tok.encode(f"User: {line}\nChatbort:"))
        toks = []
        for _ in range(P15_FRONT):
            tid = int(g.gen_single_token()[0, 0])
            toks.append(tid)
            if tid in (tok.eos_token_id, tok.newline_token_id):
                break
        out.append(toks)
    return out


def front_end_routes(mp, res):
    """A web UI reply, a websocket streamInfer and the chatbot loop, each
    graphed and eagerly from the same state, then timed in turns."""
    port = mp.port
    # web UI: a fresh server for each mode, one reply each
    (got, g_state), c_g = run_mode(mp.model, True,
                                   lambda: webui_replies(mp, [True]))
    (ref, e_state), c_e = run_mode(mp.model, False,
                                   lambda: webui_replies(mp, [False]))
    same_run("web UI reply", dict(tokens=[g_state[0]], tensors=g_state[1],
                                  graphs=g_state[2]),
             dict(tokens=[e_state[0]], tensors=e_state[1], graphs=0), c_g,
             c_e)
    if got[0][0] != ref[0][0] or not got[0][0]:
        raise AssertionError(f"phase 15 web UI: {got[0][0]!r} vs "
                             f"{ref[0][0]!r}")
    # in turns, each user input longer than the last: a reply replays the
    # graphs of the chunk rows (16, 32, 64) and buckets it has seen and
    # captures the others, whose cost its time includes
    timed, _ = webui_replies(mp, [True, True, False, False, True], grow=True)
    # the tag tokenizer decodes each token to one "<id>"
    tps = [text.count("<") / dt for text, dt, _ in timed]
    held = [0] + [n for _, _, n in timed]
    res["webui"] = dict(graphs=g_state[2], tokens=got[0][0].count("<"),
                        turns_ms=[dt * 1e3 for _, dt, _ in timed],
                        new_graphs=[b - a for a, b in zip(held, held[1:])],
                        reply_s={"graphs": min(timed[1][1], timed[4][1]),
                                 "eager": min(timed[2][1], timed[3][1])},
                        tps={"graphs": max(tps[1], tps[4]),
                             "eager": max(tps[2], tps[3])})
    # websocket: one protocol on a cache of its own a mode
    from exllama_tpu_torch.serve.ws import WsProtocol

    runs = {}
    for capture in (True, False):
        proto = WsProtocol(mp.model, mp.tok, port.ExLlamaCache(mp.model))
        frames, c = run_mode(mp.model, capture,
                             lambda: ws_streams(mp, proto, [capture])[0][0])
        gen = proto.generator
        runs[capture] = (dict(tokens=[json.dumps(frames)],
                              tensors=cache_tensors(gen.cache),
                              graphs=graphs_held(gen)), c, proto)
    same_run("websocket streamInfer", runs[True][0], runs[False][0],
             runs[True][1], runs[False][1])
    timed = ws_streams(mp, runs[True][2], [True, False, False, True])
    tps = [frames[-1]["fullResponse"].count("<") / dt
           for frames, dt in timed]
    res["ws"] = dict(graphs=runs[True][0]["graphs"],
                     stream_s={"graphs": min(timed[0][1], timed[3][1]),
                               "eager": min(timed[1][1], timed[2][1])},
                     tps={"graphs": max(tps[0], tps[3]),
                          "eager": max(tps[1], tps[2])})
    del runs
    # the chatbot loop: two user lines, graphed and eager generators
    lines = ["hi there", "tell me more"]
    runs = {}
    for capture in (True, False):
        g = port.ExLlamaGenerator(mp.model, mp.tok,
                                  port.ExLlamaCache(mp.model), seed=SEED)
        toks, c = run_mode(mp.model, capture,
                           lambda: chatbot_turns(mp, g, lines))
        runs[capture] = (dict(tokens=[np.asarray(t) for t in toks]
                              + [g.sequence_actual],
                              tensors=cache_tensors(g.cache) + [g._seq_buf],
                              graphs=graphs_held(g)), c, g)
    same_run("chatbot loop", runs[True][0], runs[False][0], runs[True][1],
             runs[False][1])
    g = runs[True][2]
    base = g.sequence.shape[1]
    n = P15_FRONT

    def chat_run():
        for _ in range(n):
            g.gen_single_token()
        g.gen_rewind(n)

    res["chatbot"] = dict(graphs=runs[True][0]["graphs"],
                          tokens=[len(t) for t in runs[True][0]["tokens"][:2]],
                          tps=turns15(mp.model, chat_run, n))
    if g.sequence.shape[1] != base:
        raise AssertionError("phase 15 chatbot: the timed turns moved the "
                             "sequence")


def speculative_route(mp, res):
    """SpeculativeGenerator with the n-gram proposer at top-k 1: 32
    tokens after a 256-token repeating prompt graphed and eagerly (fresh
    caches, one seed), then 128 tokens after phase 12's 1,024-token
    prompt in turns."""
    from exllama_tpu_torch.speculative import NgramProposer

    port = mp.port
    rng = np.random.default_rng(SEED + 12)
    pattern = rng.integers(4, 260, size=64)
    runs = {}
    for capture in (True, False):
        spec = port.SpeculativeGenerator(mp.model, mp.tok,
                                         port.ExLlamaCache(mp.model),
                                         NgramProposer(), seed=SEED)
        spec.settings.top_k = 1
        ids = np.tile(pattern, 4).astype(np.int32)
        seq, c = run_mode(mp.model, capture,
                          lambda: spec.generate_tokens(ids, 32))
        runs[capture] = (dict(tokens=[seq], tensors=cache_tensors(spec.cache),
                              graphs=graphs_held(spec)), c, spec)
    same_run("speculative generator", runs[True][0], runs[False][0],
             runs[True][1], runs[False][1])
    spec = runs[True][2]
    ids = np.tile(pattern, 16).astype(np.int32)
    tps = turns15(mp.model, lambda: spec.generate_tokens(ids, 128), 128)
    res["speculative"] = dict(graphs=graphs_held(spec),
                              stats=dict(spec.stats), tps=tps)


def cfg_beam_routes(device, res):
    """CFG (alpha 0.3, top-k 1, P15_NEW tokens) and beam search with 3
    beams alive (top-k 3, top-p off, beam length 4) on phase 4's 2-layer
    full-width model, graphed and eagerly from one seed: tokens, caches
    and launches equal; the beam steps at 3 rows replay the graphs on the
    kept beam cache."""
    import exllama_tpu_torch as port

    cfg = port.ExLlamaConfig()
    cfg.num_hidden_layers = 2
    cfg.max_seq_len = 128
    model = port.ExLlama(cfg, params=port.make_synthetic_params(
        cfg, 128, False, seed=1, device=device, fast=True), device=device)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, size=(1, 24)).astype(np.int32)
    prompts = ["a cheerful story about", "a sad and dull report on"]

    def cfg_run():
        g = _generator(model, batch=2, top_k=1)
        g.generate_cfg(prompts, 0.3, P15_NEW)
        return dict(tokens=[g.sequence], tensors=cache_tensors(g.cache),
                    graphs=graphs_held(g))

    def beam_run():
        g = _generator(model, top_k=3, top_p=0.0, beams=3, beam_length=4)
        g.gen_begin(ids)
        g.begin_beam_search()
        rows = []
        step = g._beam_step

        def counted(n_out):
            rows.append(g._beam_seqs.shape[0])
            return step(n_out)

        g._beam_step = counted
        toks = [int(g.beam_search()[0, 0]) for _ in range(P15_NEW)]
        held = graphs_held(g)
        g.end_beam_search()
        return dict(tokens=[np.asarray(toks), g.sequence], graphs=held,
                    tensors=cache_tensors(g.cache), rows=rows)

    for label, fn in (("CFG", cfg_run), ("beams at 3", beam_run)):
        got, c_g = run_mode(model, True, fn)
        ref, c_e = run_mode(model, False, fn)
        same_run(label, got, ref, c_g, c_e)
        res[label] = dict(graphs=got["graphs"], launches=c_g)
        if label == "beams at 3":
            if 3 not in got["rows"]:
                raise AssertionError(f"phase 15 beams: no step at 3 rows "
                                     f"({got['rows']})")
            res[label]["steps_at_3"] = got["rows"].count(3)


def engine_routes(mp, lora, res):
    """The engine's six greedy requests of phase 13 (prompts of 32-512
    tokens: 64-token admission chunks; one under adapter Q; no stop
    strings) through its speculative step (n-gram, lookahead 4), graphed
    then eagerly, then graphed again (replays only): tokens, slot caches
    and histories bit-equal, each chunk SERVE_CHUNK and each verify step
    SERVE_SPEC in every run."""
    import gc

    from exllama_tpu_torch.speculative import NgramProposer

    specs = [dict(s, stop=False, stop_string=None)
             for s in serve_specs(mp.cfg.vocab_size) if s["greedy"]]
    runs, engines = [], {}
    for capture in (True, False, True):
        eng = engines.get(capture)
        if eng is None:
            eng = engines[capture] = serve_engine(
                mp, lora, capture, spec_proposer=NgramProposer(),
                spec_lookahead=4)
        seen = {k: len(v) for k, v in eng.counted.items()}

        def go():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [serve_submit(eng, s) for s in specs]
            eng.run()
            torch.cuda.synchronize()
            return reqs, time.perf_counter() - t0

        graphs0 = len(eng.graphs) + len(eng.scratch.graphs)
        (reqs, secs), c = run_mode(mp.model, capture, go)
        new = {k: v[seen[k]:] for k, v in eng.counted.items()}
        for kind, want in (("spec", SERVE_SPEC), ("chunk", SERVE_CHUNK)):
            if not new[kind]:
                raise AssertionError(f"phase 15 engine: no {kind} ran")
            for cc in new[kind]:
                require(f"phase 15 engine {kind} (capture {capture})", cc,
                        want)
        n_tok = sum(len(r.new_tokens) for r in reqs)
        runs.append(dict(
            tokens=[r.new_tokens for r in reqs], secs=secs, tps=n_tok / secs,
            graphs=len(eng.graphs) + len(eng.scratch.graphs) - graphs0,
            launches=c, spec=len(new["spec"]), chunks=len(new["chunk"]),
            tensors=cache_tensors(eng.cache) + [eng._hist]))
        if len(runs) == 2:
            g, e = runs
            same_run("engine, admission chunks and speculative step",
                     g, dict(e, graphs=0), g["launches"], e["launches"])
            for r in runs:
                r.pop("tensors")
            del engines[False], eng
            gc.collect()
            torch.cuda.empty_cache()
    if runs[2]["tokens"] != runs[0]["tokens"]:
        raise AssertionError("phase 15 engine: the second graphed run "
                             "differs")
    # one verify step's graph alone (the slots are free by now: a replay
    # writes rows that no request reads): ms a replay, fenced, and a trace
    eng = engines[True]
    graph = eng.graphs[max((k for k in eng.graphs if len(k) == 3),
                           key=lambda k: k[1])].graph
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        graph.replay()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e2
    names, idle = trace_step(graph.replay)
    res["engine_verify_step"] = dict(
        replay_ms=step_ms, launches=None if names is None
        else sum(names.values()), top=kernel_times(graph.replay),
        **(idle or {}))
    res["engine"] = dict(
        tokens=sum(len(t) for t in runs[0]["tokens"]),
        verify_steps=runs[0]["spec"], chunks=runs[0]["chunks"],
        graphs=[runs[0]["graphs"], runs[2]["graphs"]],
        tps={"graphs (captures)": runs[0]["tps"], "eager": runs[1]["tps"],
             "graphs (replays)": runs[2]["tps"]})
    del engines, runs
    gc.collect()
    torch.cuda.empty_cache()


def kernel_times(step, top=6):
    """One call of ``step`` traced by torch.profiler: [(kernel name, its
    device time in us)] of the ``top`` largest totals, or None where the
    trace shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:70]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us()
    return sorted(by.items(), key=lambda kv: -kv[1])[:top] or None


def graphs_path(mp, lora, device, launches, card):
    """Phase 15: every route the JAX package runs compiled, graphed and
    eagerly from the same state on phase 12's zero-mean 32-layer model
    (adapter Q) and phase 4's 2-layer model. Returns its results; adds its
    launches to ``launches``."""
    import gc

    res = {}
    zero_counts()
    t_phase = time.time()
    gc.collect()                # what earlier phases left goes first
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    allocated0 = torch.cuda.memory_allocated()
    greedy, g = single_token_route(mp, lora, "gen_single_token greedy (Q)",
                                   top_k=1)
    sampled, s = single_token_route(mp, None, "gen_single_token sampled")
    for name, r, gen in (("greedy", greedy, g), ("sampled", sampled, s)):
        def one_run(gen=gen):
            for _ in range(P15_NEW):
                gen.gen_single_token()
            gen.gen_rewind(P15_NEW)
        r["tps"] = turns15(mp.model, one_run, P15_NEW)
        res[f"gen_single_token {name}"] = r
        turn = {k: v for k, v in r["launches_turn"].items() if v}
        log(f"  [15] gen_single_token {name}: {P15_NEW} tokens after a "
            f"64-token prompt, graphs = eager bit for bit (tokens, cache, "
            f"history) and in launches ({turn}); "
            f"captures per turn {r['captures']} (turn 2: temperature 0.7, "
            f"top-p 0.9, another prompt of the same length); tok/s in turns "
            f"graphs {r['tps']['graphs']:.2f}, eager {r['tps']['eager']:.2f} "
            f"[{card}]")
    del g, s
    front_end_routes(mp, res)
    w, ws, cb = res["webui"], res["ws"], res["chatbot"]
    log(f"  [15] web UI reply ({w['tokens']} tokens, /api/userinput "
        f"streamed): graphs = eager (text, session sequence, cache), "
        f"{w['graphs']} graphs; a reply in turns graphs "
        f"{w['reply_s']['graphs'] * 1e3:.1f} ms, eager "
        f"{w['reply_s']['eager'] * 1e3:.1f} ms (tok/s "
        f"{w['tps']['graphs']:.2f} / {w['tps']['eager']:.2f}; five replies "
        f"to user inputs 12 characters apart, graphs graphs eager eager "
        f"graphs: ms {[round(x, 1) for x in w['turns_ms']]}, graphs "
        f"captured {w['new_graphs']}); websocket "
        f"streamInfer ({P15_FRONT} tokens): graphs = eager (frames, "
        f"cache), {ws['graphs']} graphs; a stream in turns graphs "
        f"{ws['stream_s']['graphs'] * 1e3:.1f} ms, eager "
        f"{ws['stream_s']['eager'] * 1e3:.1f} ms (tok/s "
        f"{ws['tps']['graphs']:.2f} / {ws['tps']['eager']:.2f}); chatbot "
        f"loop (2 lines, "
        f"{cb['tokens']} tokens): graphs = eager, {cb['graphs']} graphs, "
        f"tok/s in turns graphs {cb['tps']['graphs']:.2f}, eager "
        f"{cb['tps']['eager']:.2f} [{card}]")
    speculative_route(mp, res)
    sp = res["speculative"]
    log(f"  [15] speculative generator (n-gram, top-k 1): 32 tokens after "
        f"256 graphs = eager (sequence, cache, launches); 128 tokens after "
        f"1,024 in turns graphs {sp['tps']['graphs']:.2f}, eager "
        f"{sp['tps']['eager']:.2f} tok/s ({sp['graphs']} graphs, "
        f"{sp['stats']}) [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    cfg_beam_routes(device, res)
    log(f"  [15] phase 4's 2-layer model: CFG ({P15_NEW} tokens, B = 2) and "
        f"beams (3 alive, {res['beams at 3']['steps_at_3']} steps at 3 "
        f"rows) graphs = eager (tokens, cache, launches); graphs "
        f"{res['CFG']['graphs']} / {res['beams at 3']['graphs']}")
    gc.collect()
    torch.cuda.empty_cache()
    engine_routes(mp, lora, res)
    en = res["engine"]
    log(f"  [15] engine, the six greedy requests through the speculative "
        f"step: {en['tokens']} tokens, {en['chunks']} admission chunks, "
        f"{en['verify_steps']} verify steps, graphs captured in the first / "
        f"the second graphed run {en['graphs']}; graphs = "
        f"eager (tokens, slot caches, histories, launches: {SERVE_CHUNK} a "
        f"chunk, {SERVE_SPEC} a verify step); tok/s graphs (with captures) "
        f"{en['tps']['graphs (captures)']:.1f}, eager "
        f"{en['tps']['eager']:.1f}, graphs (replays) "
        f"{en['tps']['graphs (replays)']:.1f} [{card}]")
    vs = res["engine_verify_step"]
    log(f"  [15] one replayed verify step (8 slots x 5 rows, the last "
        f"bucket): {vs['replay_ms']:.3f} ms"
        + ("; trace: no device activity (not measured)"
           if vs["launches"] is None else
           f"; traced: {vs['launches']} device launches, busy "
           f"{vs['busy_us']:.1f} of {vs['window_us']:.1f} us, idle "
           f"{vs['idle_share']:.1%}; the most device time: "
           + "; ".join(f"{us:.0f} us {name}" for name, us in vs["top"] or ()))
        + f" [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    res["reserved_bytes"] = dict(before=reserved0,
                                 after=torch.cuda.memory_reserved())
    res["allocated_bytes"] = dict(before=allocated0,
                                  after=torch.cuda.memory_allocated())
    log(f"  [15] memory reserved by the allocator (graph pools included): "
        f"{reserved0} bytes before the phase, "
        f"{res['reserved_bytes']['after']} after; allocated {allocated0} "
        f"before, {res['allocated_bytes']['after']} after (the web UI's "
        f"session keeps its cache and generator) "
        f"({time.time() - t_phase:.1f} s in the phase) [{card}]")
    c = counts()
    launches.update({k: launches.get(k, 0) + v for k, v in c.items()})
    return res


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
        f"{torch.version.cuda}, {torch.cuda.device_count()} device; the CPU "
        f"references on {torch.get_num_threads()} torch threads, "
        f"{os.cpu_count()} CPUs)")
    log(smi)

    secs = kernels.build()
    log(f"[2 build] {len(kernels.LIBRARIES)} libraries (12 kernels; K1, K6, "
        f"K7 once per GEMV mode, K7 again for the quantized KV caches, K3 "
        f"again for head_dim 256, and every 4-bit kernel once more for f32 "
        f"scales) built and loaded in {secs:.1f} s")

    log("[3 kernels] kernel vs plain on the card, medians of L2-cold runs")
    t0 = time.time()
    timer = Timer(device)
    res = {}
    kernel_cases(device, timer, res)
    fused_cases(device, timer, res)
    turbo_cases(device, timer, res)
    kv_cases(device, timer, res)
    kv_commit_cases(device, timer, res)
    k7_sweep_cases(device)
    crossover = {}
    gemv_tc_cases(device, timer, res, crossover)
    groupsize_cases(device, timer, res)
    xla_route = head_dim_cases(device, timer, res)
    f32_scale_cases(device, timer, res)
    log("  f32-scale builds beside their bf16 builds (kernel_ms / bf16_ms): "
        + "; ".join(f"{k} {c['case']} {c['ms']:.4f} / {c['bf16_ms']:.4f}"
                    for k in F32_KERNELS for c in res[f"{k}_f32"]))
    log(f"[3 kernels] all agree ({time.time() - t0:.1f} s)")
    parents_after3 = parent_launches()   # the parents' timings, phase 3 only

    t0 = time.time()
    worst, worst_turbo, worst_kv, features = model_vs_cpu(device)
    log(f"[4 model] 2 layers at 7B width, 64-token prefill + {PHASE4_STEPS} "
        f"decode steps, "
        f"default and fuse_qkv + K8 commit: card vs CPU logits within "
        f"{worst:.4f} of the logit scale (limit 0.03), greedy head agrees; "
        f"prefill + 4 steps under the W4A8 modes: "
        + ", ".join(f"{k} within {v:.4f} (limit {TURBO_MODEL_TOL[k]})"
                    for k, v in worst_turbo.items())
        + "; under a quantized KV cache, both configurations, each decode "
        "step from the CPU's cache state: "
        + ", ".join(f"{k} prefill within {v[0]:.4f} (limit "
                    f"{KV_MODEL_TOL[k][0]}), decode within {v[1]:.4f} (limit "
                    f"{KV_MODEL_TOL[k][1]})" for k, v in worst_kv.items())
        + f" ({time.time() - t0:.1f} s)")
    log(f"[4 model] generator features, card vs CPU (teacher-forced gaps "
        f"over the logit scale, limit 0.03): beam search top-k 1 = the "
        f"card's greedy, gap {features['beams top-k 1']:.4f}; 3 beams "
        f"(top-k 3): gap to the card's own 3rd best "
        f"{features['beams at B = 3'][0]:.4f}, "
        f"{features['beams at B = 3'][1]} of "
        f"{features['beams at B = 3'][2]} steps at B = 3 (K1 2, K7 2, K4 1 "
        f"each); CFG alpha 0.3: {features['cfg'][1]} tokens, gap "
        f"{features['cfg'][0]:.4f}, K7 at B = 2 a step; constraints: card / "
        f"CPU tokens {features['constraints'][0]}, gap "
        f"{features['constraints'][1]:.4f}")
    t0 = time.time()
    shaped = shapes_model_vs_cpu(device)
    log("[4 model] 2 layers at full width, attn_impl auto, 64-token prefill "
        f"+ {PHASE4_MODEL_STEPS} decode steps, card vs CPU logits: "
        + "; ".join(
            f"{k} within {w:.4f} (limit 0.03; launches {c})"
            for k, (w, c) in shaped.items()) + f" ({time.time() - t0:.1f} s)")
    xla_route += shaped["head_dim 100"][1]["attend_xla"]
    t0 = time.time()
    knobbed = knob_models_vs_cpu(device)
    log("[4 model] 2 layers at full width, 64-token prefill + "
        f"{PHASE4_MODEL_STEPS} decode steps, card vs CPU logits: "
        + "; ".join(
            f"{k} within {w:.4f} (limit 0.03; launches {c})"
            for k, (w, c) in knobbed.items()) + f" ({time.time() - t0:.1f} s)")

    log("[5 main path] Llama-7B shapes, 32 layers, g128, bf16 KV, "
        "max_seq_len 2048, default configuration")
    t0 = time.time()
    mp = MainPath(device)
    launches = {}
    zero_counts()
    fused = main_path(mp)
    c5 = counts()
    log(f"  launches in this phase: {c5}")
    require("phase 5", c5, {k: None for k in (
        "q4_gemv", "q4_dequant_matmul", "flash_attn", "dense_gemv", "q4_mlp",
        "layer_tail")})
    require("phase 5 decode step", fused["per_decode_step"], {
        "q4_gemv": 32, "layer_tail": 32, "flash_attn": 0, "dense_gemv": 1})
    launches.update({k: launches.get(k, 0) + v for k, v in c5.items()})
    log(f"[5 main path] done ({time.time() - t0:.1f} s)")

    log("[6 greedy] 1919-token prompt, then 128 tokens through "
        "forward_chunk(head_mode=\"argmax\")")
    t0 = time.time()
    runs = {}
    for label, knobs, want in (
            ("commit_impl=auto", dict(commit_impl="auto"),
             {"q4_gemv": 32, "layer_tail": 32, "head_argmax": 1,
              "kv_commit": 0, "dense_gemv": 0}),
            ("fuse_qkv, commit_impl=pallas",
             dict(qkv_fuse=True, commit_impl="pallas"),
             {"q4_gemv": 0, "layer_tail": 32, "head_argmax": 1,
              "kv_commit": 1, "dense_gemv": 0})):
        zero_counts()
        runs[label] = greedy(mp, label, profile=True, **knobs)
        c6 = counts()
        require(f"phase 6 {label}", runs[label]["per_decode_step"], want)
        require(f"phase 6 {label}", c6, {
            k: None for k, n in want.items() if n})
        launches.update({k: launches.get(k, 0) + v for k, v in c6.items()})
    log(f"[6 greedy] done ({time.time() - t0:.1f} s)")

    log("[7 separate kernels] request 1 with fuse_mlp, fuse_attn off and "
        "commit_impl=\"xla\" (the first slice's configuration)")
    t0 = time.time()
    mp.set_tuning(fuse_mlp=False, fuse_attn=False, commit_impl="xla")
    zero_counts()
    separate = mp.request1("separate")
    c7 = counts()
    require("phase 7", c7, {k: None for k in (
        "q4_gemv", "q4_dequant_matmul", "flash_attn", "dense_gemv")})
    require("phase 7 decode step", separate["per_decode_step"], {
        "q4_gemv": 128, "flash_attn": 32, "layer_tail": 0, "q4_mlp": 0})
    launches.update({k: launches.get(k, 0) + v for k, v in c7.items()})
    mp.set_tuning(fuse_mlp=True, fuse_attn=True, commit_impl="auto")
    log(f"  decode tok/s, one card, one run: fused "
        f"{fused['decode_tps']:.2f}, separate {separate['decode_tps']:.2f}; "
        f"greedy " + ", ".join(f"{k} {v['decode_tps']:.2f}"
                               for k, v in runs.items()))
    log(f"[7 separate kernels] done ({time.time() - t0:.1f} s)")

    log("[8 matmul modes] request 1 under pallas_a8t (+ int8 image), "
        "pallas_a8x2, pallas_a8t with prefill_w8=off, exact with "
        "EXL_GLU_FUSE=1; request 2 under pallas_a8")
    t0 = time.time()
    turbo = turbo_path(mp, fused, launches)
    log(f"[8 matmul modes] done ({time.time() - t0:.1f} s)")

    log("[9 quantized KV cache] request 1 under the configs of "
        "model_init.make_config for --kv_int8, --kv_int4, --turbo and --turbo "
        "--turbo_prefill; greedy fuse_qkv + K8 decode under the first three")
    t0 = time.time()
    fused["greedy"] = runs["fuse_qkv, commit_impl=pallas"]["decode_tps"]
    fused["a8 greedy"] = turbo[
        "fuse_qkv, commit_impl=pallas, pallas_a8"]["decode_tps"]
    kv_path(mp, fused, launches)
    log(f"[9 quantized KV cache] done ({time.time() - t0:.1f} s)")
    del mp

    log("[10 benchmark] python -m exllama_tpu_torch.benchmark on the card, "
        "each run between a zeroing and a reading of the launch counters")
    t0 = time.time()
    bench = benchmark_path(launches)
    log("  phase 10 results: " + json.dumps(bench, default=str))
    log(f"[10 benchmark] done ({time.time() - t0:.1f} s)")

    log("[11 compiled decode] gen_tokens and the benchmark's greedy loop "
        "through captured CUDA graphs (one per attend-length bucket) on the "
        "32-layer model, against the same step run eagerly")
    t0 = time.time()
    mp = MainPath(device)
    zero_counts()
    graphs = compiled_decode(mp)
    c11 = counts()
    launches.update({k: launches.get(k, 0) + v for k, v in c11.items()})
    eager_idle = runs["fuse_qkv, commit_impl=pallas"]["step_idle"]
    log("  device idle share within one step: " + ", ".join(
        f"{k} replay {graphs[f'{k}_replay']['idle_share']:.1%}"
        for k in ("sampled", "greedy") if f"{k}_replay" in graphs)
        + ("" if eager_idle is None else
           f"; phase 6's eager greedy step {eager_idle['idle_share']:.1%}"))
    del mp
    log(f"[11 compiled decode] done ({time.time() - t0:.1f} s)")

    log("[12 adapters and generators] LoRA adapters Q (q, v) and A (all "
        "seven projections) against the CPU on 2-layer full-width models "
        "and through the generator's graphs on the 32-layer model; the alt "
        "generator; speculative decoding")
    t0 = time.time()
    p12 = lora_and_generators(device, launches)
    tps = p12["generator"]["tps"]
    spec = p12["speculative"]
    log(f"  decode tok/s by adapter (sampled, graphs, 1919-token context, "
        f"in turns): none {tps['none']:.2f}, Q {tps['Q']:.2f}, A "
        f"{tps['A']:.2f} (phase 11, the same step without an adapter: "
        f"{graphs['sampled_tps']['graph']:.2f}); speculative "
        f"{spec['tps']:.2f} tok/s (acceptance {spec['acceptance']:.3f}) "
        f"beside the generator's {spec['generator_tps']['graphs']:.2f} "
        f"(graphs) / {spec['generator_tps']['eager']:.2f} (eager); verify "
        f"rows vs one-token steps within "
        f"{max(e for r in spec['rows'].values() for e, _ in r.values()):.4f}"
        f"; self-draft acceptance "
        f"{spec['self_draft']['acceptance']:.3f}")
    log(f"[12 adapters and generators] done ({time.time() - t0:.1f} s)")

    log("[13 serving] the continuous-batching engine (8 slots, 64-token "
        "admission chunks, 256-key buckets) on phase 12's 32-layer model; "
        "its HTTP, websocket and web-UI front ends; benchmark -cs 8")
    t0 = time.time()
    mp12, lora_q = p12.pop("mp"), p12.pop("lora_q")
    p13 = serving_path(mp12, lora_q, launches, smi)
    log("  phase 13 results: " + json.dumps(p13, default=str))
    log(f"[13 serving] done ({time.time() - t0:.1f} s)")

    log("[14 parallel] tensor, sequence and data parallelism as ranks of "
        f"{PAR_BACKEND} worlds on the one card (parallel.launch, backend "
        f"{PAR_BACKEND}: NCCL refuses two ranks on one device): tp = 2 (32 "
        f"layers), sp = 2 and its ring prefill, the front ends over tp = 2, "
        f"tp = 4 ({TP4_LAYERS} layers), the engine at dp = 2 x tp = 2")
    t0 = time.time()
    p14 = parallel_path(device, smi, launches, res)
    log("  phase 14 results: " + json.dumps(p14, default=str))
    log(f"[14 parallel] done ({time.time() - t0:.1f} s)")

    log("[15 compiled steps] every route the JAX package runs compiled, "
        "graphed and eagerly from the same state: gen_single_token, the web "
        "UI, the websocket server, the chatbot loop, the speculative "
        "generator, CFG and beams, the engine's admission chunks and "
        "speculative step")
    t0 = time.time()
    p15 = graphs_path(mp12, lora_q, device, launches, smi)
    del mp12, lora_q
    log("  phase 15 results: " + json.dumps(p15, default=str))
    log(f"[15 compiled steps] done ({time.time() - t0:.1f} s)")

    # K3's prefill path beside its decode path (the summary names decode)
    log("  flash_attn prefill T=1919: " + "; ".join(
        f"{kname} kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
        f"library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f}"
        for kname in ("flash_attn", "flash_attn_int8", "flash_attn_int4")
        for r in res[kname] if "prefill T=1919" in r["case"]))
    log("  flash_attn at the verify forward's shapes: " + "; ".join(
        f"{r['case']} kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
        f"library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f}"
        for r in res["flash_attn"] if r["case"].startswith("verify")))
    summary = []
    for kname, (src, replaces, rep_case) in SOURCES.items():
        r = next(c for c in res[kname] if c["case"].startswith(rep_case))
        lib = r["library_ms"]
        log(f"  {kname} ({r['case']}): kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms "
            f"{'n/a' if lib is None else f'{lib:.4f}'} bound_ms "
            f"{r['bound_ms']:.4f} launches {launches[kname]}")
        entry = dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=launches[kname],
            max_abs_err=max(c["max_abs_err"] for c in res[kname]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=lib, case=r["case"],
        )
        entry.update({key: r[key] for key in EXTRA_TIMES if key in r})
        if kname == "q4_gemv_a8":       # K9 inside the fused kernels
            entry["launches_in_q4_mlp"] = launches["q4_mlp_a8"]
            entry["launches_in_layer_tail"] = launches["layer_tail_a8"]
        if kname.startswith("layer_tail_"):     # K7 over a quantized cache:
            a8 = launches["layer_tail_a8_" + kname[11:]]   # exact + a8 GEMVs
            entry["launches"] += a8
            entry["launches_a8"] = a8
        summary.append(entry)
    # the tensor-core route at M = 18 beside the kernels' headline cases
    for entry in summary:
        if entry["name"] in ("q4_gemv", "q4_gemv_a8"):
            entry["m18"] = [
                {k: c.get(k) for k in ("case", "ms", "plain_ms",
                                       "library_ms", "bound_ms", "parent_ms",
                                       "k2_ms")}
                for c in res[entry["name"]] if " M=18" in c["case"]
                and "g128" in c["case"]]
    log(f"  K1 vs K2 (ms): {json.dumps(crossover)}")
    moved = {k: v - parents_after3[k] for k, v in parent_launches().items()
             if v != parents_after3[k]}
    if moved:
        raise AssertionError(f"parents launched after phase 3 (a wrapper "
                             f"reached them): {moved}")
    log(f"  the parents of K1 (the mma.sync route), K2 (the ring's Exact "
        f"mode) and K4 (the stream-K loop): {parents_after3} launches, all "
        f"in phase 3's parent timings")
    log(f"  phase 5 request 2 prefill {fused['request2_prefill_ms']:.3f} ms, "
        f"request 3 decode step {fused['request3_decode_step_ms']:.3f} ms; "
        f"the einsum attention route (head_dim 100) ran {xla_route} times")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
