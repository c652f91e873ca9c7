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
     output by more than 3x its limit (w8_cases); K4 at M = 1, 2, 8, 16, 32
     and K5 at M = 1, 2, 8, 32 on the 4096 x 32000 lm_head and at V = 32001
     (an odd vocab), two calls on the same inputs bit-equal; K12 at 33,
     127 and 1919 rows beside K2 alone and K2 +
     the plain silu*up, after up negated and a dropped silu have each moved
     the plain output by more than 3x its 1e-2 (turbo_cases); K3, K7 and K8
     over an int8 and an int4 KV
     cache at the same shapes (2e-2 / 5e-2 as over bf16, K8 bit-equal),
     after an independent f32 reference has shown that per-key K or V
     scales replaced by their mean, the V scale also applied to the
     softmax denominator, and swapped int4 halves each move the output by
     more than 3x the limit (kv_cases); K1 and K9 (a8, a8x2) on their
     tensor-core route at M = 2, 4, 16, 18, 32 on the four projections,
     with the K1-vs-K2 crossover at M = 2..64 (gemv_tc_cases); K1, K9, K2,
     K10 and K12 at groupsize 256 and groupsize = K (groupsize_cases); K3
     at head_dim 256, decode and prefill, over bf16 / int8 / int4 caches,
     and head_dim 100 on the einsum route's own counter (head_dim_cases);
  4. a 2-layer model at full 7B width built from one seed on the card and on
     the CPU: teacher-forced prefill + decode logits compared, in the default
     configuration and with fuse_qkv + commit_impl="pallas", and the greedy
     head's tokens held against the CPU logits; then the same comparison
     under matmul_impl="pallas_a8x2" and "pallas_a8t", and under an int8
     and an int4 KV cache in both configurations; then 2-layer full-width
     models at groupsize 256, at head_dim 256 and at head_dim 100
     (OpenLlama-3B, attn_impl "auto": the einsum route) against the CPU;
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
     with prompt and decode tokens/s, peak memory and the cache's bytes.

Each of phases 5-9 sets every launch counter to 0 just before it drives its
path and reads them just after; a kernel its path must run that shows no
launch fails the run. The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``. Needs exactly
one visible CUDA device.
"""

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


def q4_bytes(k, n, gs):
    """Packed nibbles plus bf16 scales and zero-scales of a K x N tensor."""
    return k * n // 2 + 2 * (k // gs) * n * 2


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
EXTRA_TIMES = ("separate_ms", "k2_ms", "library_int8_ms")


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
            nbytes = q4_bytes(k, n, gs) + m * k * 2 + m * n * 2
            record("q4_dequant_matmul", f"{nm} g{gs} M={m}", err, rel,
                   lambda: quant.q4_dequant_matmul(x, qt),
                   lambda: quant._q4_matmul_plain(x, qt),
                   lambda: torch.matmul(x, w), nbytes, 2 * m * k * n)
        del w
    # K2 at the edges of its 128 x 128 tile: the smallest M it takes (33),
    # M = 127 / 129 around a tile, and an N that is not a multiple of 128
    for m, k, n in ((33, 4096, 4096), (129, 4096, 4096), (1919, 4096, 4168)):
        qt = random_qt(gen, k, n, 128, False, device)
        w = dequantize_t(qt)
        x = torch.randn((m, k), generator=gen, device=device).bfloat16()
        got = quant.q4_dequant_matmul(x, qt)
        ref = quant._q4_matmul_plain(x, qt)
        err, rel = check_close(f"q4_dequant_matmul {k}->{n} M={m}", got, ref,
                               TOL["q4_dequant_matmul"])
        record("q4_dequant_matmul", f"edge {k}->{n} g128 M={m}", err, rel,
               lambda: quant.q4_dequant_matmul(x, qt),
               lambda: quant._q4_matmul_plain(x, qt),
               lambda: torch.matmul(x, w),
               q4_bytes(k, n, 128) + m * k * 2 + m * n * 2, 2 * m * k * n)
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
    # runs the scalar loads
    for v in (32000, 32001):
        w = (torch.randn((4096, v), generator=gen, device=device)
             * 0.02).bfloat16()
        for m in (1, 2, 8, 16, 32):
            x = torch.randn((m, 4096), generator=gen,
                            device=device).bfloat16()
            got = dense.dense_gemv(x, w)
            ref = dense.dense_gemv_plain(x, w)
            err, rel = check_close(f"dense_gemv V={v} M={m}", got, ref,
                                   TOL["dense_gemv"])
            if not torch.equal(got, dense.dense_gemv(x, w)):
                raise AssertionError(f"dense_gemv V={v} M={m}: two calls "
                                     f"on the same inputs differ")
            record("dense_gemv", f"lm_head 4096->{v} M={m}", err, rel,
                   lambda: dense.dense_gemv(x, w),
                   lambda: dense.dense_gemv_plain(x, w),
                   lambda: torch.matmul(x, w), 4096 * v * 2 + m * 4096 * 2
                   + m * v * 4, 2 * m * 4096 * v)
        del w


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
    # same bf16 cast points on both sides
    for gs in (128, 32):
        gateup = random_qt(gen, hidden, 2 * inter, gs, False, device)
        down = random_qt(gen, inter, hidden, gs, False, device)
        nw = norm_w()
        for m in (1, 18):
            h = rnd(m, 1, hidden)
            got = mlp.q4_mlp(h, nw, gateup, down, eps)
            ref = mlp.q4_mlp_plain(h, nw, gateup, down, eps)
            err, rel = check_close(f"q4_mlp g{gs} M={m}", got, ref,
                                   TOL["q4_mlp"])

            def separate():
                a = rms_norm(h, nw, eps)
                mid = mlp.silu_mul(quant.q4_matmul(a, gateup), inter)
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
            mid = mlp.silu_mul(quant.q4_matmul(rms_norm(h1, nw, eps), gateup),
                               inter)
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

    # K8: exact -- a copy of bf16 rows; one launch for all 32 layers, with
    # the caches' pointer array built once, as ExLlamaCache does
    n_layers, b, hkv, past = 32, 1, 32, 1919
    caches = [rnd(b, hkv, s_max, d) for _ in range(2 * n_layers)]
    plain = [c.clone() for c in caches]
    nk, nv = rnd(n_layers, b, 1, hkv, d), rnd(n_layers, b, 1, hkv, d)
    kcs, vcs = caches[:n_layers], caches[n_layers:]
    ptrs = attention.kv_ptr_array(kcs, vcs)
    attention.commit_kv_cache(kcs, vcs, nk, nv, past, impl="pallas",
                              ptrs=ptrs)
    attention.commit_kv_cache(plain[:n_layers], plain[n_layers:], nk, nv,
                              past, impl="xla")
    err = max((g.float() - r.float()).abs().max().item()
              for g, r in zip(caches, plain))
    if err != 0.0:
        raise AssertionError(f"kv_commit: differs from the plain writes by "
                             f"{err}")
    rows = 2 * n_layers * b * hkv * d * 2
    record("kv_commit", f"L={n_layers} B={b} Hkv={hkv}", err, 0.0,
           lambda: attention.commit_kv_cache(kcs, vcs, nk, nv, past,
                                             impl="pallas", ptrs=ptrs),
           lambda: attention.commit_kv_cache(kcs, vcs, nk, nv, past,
                                             impl="xla"),
           None, 2 * rows, 0)


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
                            (1, "pallas_a8", gu32, dn32)):
        h = rnd(m, 1, hidden)
        got = mlp.q4_mlp(h, nw, gu, dn, eps, impl)
        ref = mlp.q4_mlp_plain(h, nw, gu, dn, eps, impl)
        tag = f"{impl[7:]} g{gu.groupsize} M={m}"
        err, rel = check_close(f"q4_mlp_a8 {tag}", got, ref, TOL["q4_mlp_a8"])

        def separate():
            a = rms_norm(h, nw, eps)
            mid = mlp.silu_mul(quant.q4_matmul(a, gu, impl), inter)
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

        # ---- K8: bytes and scales bit-equal to the plain quantized writes;
        # an all-zero row and half-way values among the rows
        n_layers, b, hkv, cur = 32, 1, 32, 1919
        caches = [quantized_cache(gen, kind, b, hkv, s_max, d, device)
                  for _ in range(n_layers)]
        lists = [[c[i] for c in caches] for i in range(4)]   # k, v, ks, vs
        plain = [[t.clone() for t in ts] for ts in lists]
        nk, nv = rnd(n_layers, b, 1, hkv, d), rnd(n_layers, b, 1, hkv, d)
        nk[0, 0, 0, 0] = 0
        nk[0, 0, 0, 1] = ((torch.arange(d, device=device) % 14 - 7) + 0.5) * 0.5
        nk[0, 0, 0, 1, 0] = 63.5 if kind == "int8" else 3.5   # the scale: 0.5
        ptrs = attention.kv_ptr_array(*lists)
        attention.commit_kv_cache(lists[0], lists[1], nk, nv, cur, lists[2],
                                  lists[3], impl="pallas", ptrs=ptrs)
        attention.commit_kv_cache(plain[0], plain[1], nk, nv, cur, plain[2],
                                  plain[3], impl="xla")
        n_diff = sum(int((g != r).sum()) for gs_, rs_ in zip(lists, plain)
                     for g, r in zip(gs_, rs_))
        if n_diff:
            raise AssertionError(f"kv_commit_{kind}: {n_diff} bytes / scales "
                                 f"differ from the plain quantized writes")
        if not (lists[2][0][:, :, cur] > 0).all():
            raise AssertionError(f"kv_commit_{kind}: no scale written")
        rows = 2 * n_layers * b * hkv
        nbytes = (rows * d * 2 + rows * (d // 2 if kind == "int4" else d)
                  + rows * 4)
        record(f"kv_commit_{kind}", f"{kind} L={n_layers} B={b} Hkv={hkv}",
               0.0, 0.0,
               lambda: attention.commit_kv_cache(
                   lists[0], lists[1], nk, nv, cur, lists[2], lists[3],
                   impl="pallas", ptrs=ptrs),
               lambda: attention.commit_kv_cache(
                   lists[0], lists[1], nk, nv, cur, lists[2], lists[3],
                   impl="xla"),
               None, nbytes, 0)
        del caches, lists, plain


# ------------------------------- phase 3: the tensor-core GEMV, new shapes

GEMV_MS = (2, 4, 16, 18, 32)        # rows of the tensor-core route's sweep
CROSSOVER_MS = (2, 4, 8, 16, 24, 32, 33, 48, 64)


def gemv_tc_cases(device, timer, res, crossover):
    """K1 and K9 (a8, a8x2) on their tensor-core route at 2..32 rows, at the
    four Llama-7B projections (qkv with the RMSNorm prologue), each against
    its plain version with kernel / plain / library / bound times; and the
    K1-vs-K2 crossover: both kernels at M = 2..32, K2 alone at 33..64
    (K1 takes at most 32 rows), on the qkv and down shapes, into
    ``crossover`` {shape: {M: {"q4_gemv": ms, "q4_dequant_matmul": ms}}}."""
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
            record("q4_gemv", tag, err, rel,
                   lambda: quant.q4_gemv(x, qt, nw, eps),
                   lambda: quant.q4_gemv_plain(x, qt, nw, eps),
                   lambda: torch.matmul(x, w), nbytes, 2 * m * k * n,
                   iters=10)
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


# --------------------------------------------------------------- phase 4

def model_vs_cpu(device):
    """2 layers at full 7B width, one seed, on the card and on the CPU, in
    the default configuration and with fuse_qkv + the K8 commit. Returns the
    worst logit difference over the logit scale."""
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
        np.int32) for _ in range(8)]
    worst = 0.0
    for qkv_fuse, commit in ((False, "auto"), (True, "pallas")):
        cfg.tuning.fuse_qkv = qkv_fuse
        cfg.tuning.commit_impl = commit
        c_cpu, c_gpu = port.ExLlamaCache(cpu_model), port.ExLlamaCache(gpu_model)
        # 3% of the logit scale: the kernels round at other places than the
        # CPU plain path (see tests/test_torch_model.py for the JAX package's
        # own 2.1% spread between its two paths)
        for i, tok in enumerate(steps):
            ref = cpu_model.forward(tok, c_cpu, last_id_only=i > 0)
            got = gpu_model.forward(tok, c_gpu, last_id_only=i > 0).cpu()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if not torch.isfinite(got).all() or rel > 0.03:
                raise AssertionError(
                    f"fuse_qkv={qkv_fuse} commit={commit} step {i}: card vs "
                    f"CPU logits rel {rel:.4f}")
            worst = max(worst, rel)
        # the greedy head (K5) on the card against the CPU logits of the
        # same state: its token's logit is within the same 3% of the max
        tok = torch.as_tensor(steps[-1], device=device)
        kw = dict(attend_len=cfg.max_seq_len, last_token_only=True,
                  preprocess_only=False, heads=cfg.num_attention_heads,
                  kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
                  eps=cfg.rms_norm_eps, qkv_fuse=qkv_fuse, commit_impl=commit)
        c_gpu.current_seq_len -= 1
        c_cpu.current_seq_len -= 1
        pick = forward_chunk(gpu_model.params, c_gpu, tok,
                             c_gpu.current_seq_len, None, head_mode="argmax",
                             **kw).cpu()
        ref = forward_chunk(cpu_model.params, c_cpu, tok.cpu(),
                            c_cpu.current_seq_len, None, **kw)[0, 0]
        gap = (ref.max() - ref[pick.reshape(-1)[0].long()]).item()
        if gap > 0.03 * ref.abs().max().item():
            raise AssertionError(f"greedy head: token logit {gap:.3g} below "
                                 f"the CPU max")
    cfg.tuning.fuse_qkv = False
    cfg.tuning.commit_impl = "auto"
    return (worst, turbo_model_vs_cpu(cfg, cpu_params, steps[:5], device),
            kv_model_vs_cpu(cfg, cpu_model, gpu_model, steps[:3]))


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
    """Phase 4's comparison (64-token prefill, then 4 teacher-forced decode
    steps, card vs CPU logits within 3% of the logit scale) for each of
    SHAPE_MODELS in the default configuration (attn_impl "auto"). Returns
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
            np.int32) for _ in range(4)]
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
    vs CPU. Returns {kind: (worst prefill, worst decode)}."""
    import exllama_tpu_torch as port

    worst = {}
    for kind, (lim_prefill, lim_decode) in KV_MODEL_TOL.items():
        cfg.tuning.kv_cache_dtype = kind
        worst[kind] = [0.0, 0.0]
        for qkv_fuse, commit in ((False, "auto"), (True, "pallas")):
            cfg.tuning.fuse_qkv = qkv_fuse
            cfg.tuning.commit_impl = commit
            c_cpu = port.ExLlamaCache(cpu_model)
            c_gpu = port.ExLlamaCache(gpu_model)
            assert c_gpu.k[0].dtype == torch.int8 and c_gpu.k_scale
            for i, tok in enumerate(steps):
                ref = cpu_model.forward(tok, c_cpu, last_id_only=i > 0)
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
                for dst, src in zip(c_gpu._tensor_lists(),
                                    c_cpu._tensor_lists()):
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
# exact mode's 3%. a8t quantizes every prefill activation to int8, so a
# bf16 step of difference between kernel and plain version can draw
# another int8 rounding downstream; at this depth it stays inside the same
# 3% (0.44% measured on an H100).
TURBO_MODEL_TOL = {"pallas_a8x2": 0.03, "pallas_a8t": 0.03}


def turbo_model_vs_cpu(cfg, cpu_params, steps, device):
    """The same 2-layer model under "pallas_a8x2" and "pallas_a8t" (int8
    images attached on both sides): prefill + 4 decode steps, card vs CPU.
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
        cpu_model = port.ExLlama(cfg, params=params, device="cpu")
        gpu_model = port.ExLlama(cfg, params=params.to(device), device=device)
        if impl == "pallas_a8t":
            assert gpu_model.params.layers[0].down.w8 is not None
        c_cpu = port.ExLlamaCache(cpu_model)
        c_gpu = port.ExLlamaCache(gpu_model)
        worst[impl] = 0.0
        for i, tok in enumerate(steps):
            ref = cpu_model.forward(tok, c_cpu, last_id_only=i > 0)
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
    return out


def zero_counts():
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def counts():
    return {k: getattr(fn, attr)
            for k, (fn, attr) in launch_counters().items()}


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
    return r1


def greedy(mp, label, **knobs):
    """Phase 6: bench.py's greedy decode -- the prompt prefilled, then 128
    tokens through forward_chunk(head_mode="argmax") at attend_len
    max_seq_len, each token fed back on the card without a host sync."""
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
    return dict(decode_tps=128 / dt, host_s=t_host, per_decode_step=per_step)


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
                  "exllama_tpu/ops/attention.py:173", "L=32 B=1"),
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
                         ("kv_commit", "L=32 B=1")):
        SOURCES[f"{_name}_{_kind}"] = (*SOURCES[_name][:2], f"{_kind} {_case}")


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
    log(f"[2 build] {len(kernels.LIBRARIES)} libraries (12 kernels; K1, K6, "
        f"K7 once per GEMV mode, K7 again for the quantized KV caches, K3 "
        f"again for head_dim 256) built "
        f"and loaded in {secs:.1f} s")

    log("[3 kernels] kernel vs plain on the card, medians of L2-cold runs")
    t0 = time.time()
    timer = Timer(device)
    res = {}
    kernel_cases(device, timer, res)
    fused_cases(device, timer, res)
    turbo_cases(device, timer, res)
    kv_cases(device, timer, res)
    k7_sweep_cases(device)
    crossover = {}
    gemv_tc_cases(device, timer, res, crossover)
    groupsize_cases(device, timer, res)
    xla_route = head_dim_cases(device, timer, res)
    log(f"[3 kernels] all agree ({time.time() - t0:.1f} s)")

    t0 = time.time()
    worst, worst_turbo, worst_kv = model_vs_cpu(device)
    log(f"[4 model] 2 layers at 7B width, 64-token prefill + 8 decode steps, "
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
    t0 = time.time()
    shaped = shapes_model_vs_cpu(device)
    log("[4 model] 2 layers at full width, attn_impl auto, 64-token prefill "
        "+ 4 decode steps, card vs CPU logits: " + "; ".join(
            f"{k} within {w:.4f} (limit 0.03; launches {c})"
            for k, (w, c) in shaped.items()) + f" ({time.time() - t0:.1f} s)")
    xla_route += shaped["head_dim 100"][1]["attend_xla"]

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
        runs[label] = greedy(mp, label, **knobs)
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

    # K3's prefill path beside its decode path (the summary names decode)
    log("  flash_attn prefill T=1919: " + "; ".join(
        f"{kname} kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
        f"library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f}"
        for kname in ("flash_attn", "flash_attn_int8", "flash_attn_int4")
        for r in res[kname] if "prefill T=1919" in r["case"]))
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
                {k: c[k] for k in ("case", "ms", "plain_ms", "library_ms",
                                   "bound_ms")}
                for c in res[entry["name"]] if " M=18" in c["case"]
                and "g128" in c["case"]]
    log(f"  K1 vs K2 (ms): {json.dumps(crossover)}")
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
