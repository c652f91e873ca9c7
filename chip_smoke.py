#!/usr/bin/env python3
"""Smoke run of exllama_tpu_torch on one NVIDIA H100: build, check, measure.

    python3 chip_smoke.py

Phases, one line or block of output each; any failure exits non-zero:

  1. device: the card's name and its nvidia-smi name / power limit;
  2. build: every CUDA kernel under exllama_tpu_torch/csrc, compiled by nvcc
     in parallel (the build seconds are printed);
  3. each kernel against its plain PyTorch version on the card at the shapes
     of the Llama-7B main path, with its time beside the plain version, one
     PyTorch library call computing the same function where there is one
     (timed here only; the port never calls it), the least time the card
     could take and, for the fused kernels K6/K7, the port's own chain of
     separate kernels for the same work; K7's attention is also held at
     its own scale, with no residual and planted keys (k7_attention_cases);
  4. a 2-layer model at full 7B width built from one seed on the card and on
     the CPU: teacher-forced prefill + decode logits compared, in the default
     configuration and with fuse_qkv + commit_impl="pallas", and the greedy
     head's tokens held against the CPU logits;
  5. the main path at full width, in the default configuration (the JAX
     package's: fuse_mlp, fuse_attn, commit_impl="auto"): a 32-layer
     Llama-7B-shape model (random weights from a seed) answering three
     generate_simple requests, with prompt and decode tokens/s, peak memory
     and every kernel's launch count;
  6. greedy decode as bench.py drives it: 128 tokens through
     forward_chunk(head_mode="argmax") after the 1919-token prompt, once with
     commit_impl="auto" and once with fuse_qkv + commit_impl="pallas";
  7. the separate-kernel configuration of the first slice (fusions off) on
     request 1, so fused and separate decode tokens/s come from one run.

Each of phases 5-7 sets every launch counter to 0 just before it drives its
path and reads them just after; a kernel its path must run that shows no
launch fails the run. The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``. Needs exactly
one visible CUDA device.
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
# kernel vs plain, max |difference| over max |plain| (reasons in kernel_cases
# and fused_cases); head_argmax: plain max logit minus the plain logit at the
# kernel's token, over max |plain logit|; kv_commit: exact
TOL = {"q4_gemv": 1e-2, "q4_dequant_matmul": 1e-2, "flash_attn": 2e-2,
       "dense_gemv": 1e-4, "head_argmax": 1e-4, "q4_mlp": 2e-2,
       "layer_tail": 2e-2, "kv_commit": 0.0}


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


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
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


def make_recorder(timer, res):
    def record(kernel, label, err, rel, k_fn, p_fn, l_fn, nbytes, flops,
               iters=15, s_fn=None):
        kms = timer(k_fn, iters)
        pms = timer(p_fn, max(3, iters // 3))
        lms = None if l_fn is None else timer(l_fn, iters)
        sms = None if s_fn is None else timer(s_fn, iters)
        b, by = bound_ms(nbytes, flops)
        r = dict(case=label, max_abs_err=err, rel_err=rel, ms=kms,
                 plain_ms=pms, library_ms=lms, bound_ms=b, bound_by=by)
        if s_fn is not None:
            r["separate_ms"] = sms
        res.setdefault(kernel, []).append(r)
        log(f"  {kernel:18s} {label:34s} err {err:.3g} (rel {rel:.2g} <= "
            f"{TOL[kernel]:g})  "
            f"kernel_ms {kms:.4f}  plain_ms {pms:.4f}  library_ms "
            f"{'n/a' if lms is None else f'{lms:.4f}'}  "
            + ("" if sms is None else f"separate_ms {sms:.4f}  ")
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
    w = rnd(hidden, vocab, scale=0.02)
    nw = norm_w()
    for m in (1, 2):
        x = rnd(m, hidden)
        ids = dense.head_argmax(x, nw, w, eps)
        xn = rms_norm(x, nw, eps)
        logits = dense.dense_gemv_plain(xn, w)
        gap = (logits.amax(1)
               - logits.gather(1, ids.long()).reshape(-1)).max().item()
        scale = logits.abs().max().item()
        if not gap <= TOL["head_argmax"] * scale:
            raise AssertionError(f"head_argmax M={m}: token logit {gap:.3g} "
                                 f"below the max (scale {scale:.3g})")
        record("head_argmax", f"lm_head 4096->32000 M={m}", gap, gap / scale,
               lambda: dense.head_argmax(x, nw, w, eps),
               lambda: dense.head_argmax_plain(x, nw, w, eps),
               lambda: torch.argmax(torch.matmul(xn, w), dim=-1),
               hidden * vocab * 2 + m * hidden * 2 + hidden * 2 + m * 4,
               2 * m * hidden * vocab)
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
    attention.commit_kv_cache(kcs, vcs, nk, nv, past, "pallas", ptrs)
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
                                             "pallas", ptrs),
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
    scores far below every key), the pad bias left out (no mask), and one
    key split lost (keys 256-511, K7's second split at 8 splits, given the
    pad bias)."""
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
        margins = {}
        for fault, fargs in faults.items():
            moved = (attn_block.attn_block_o_plain(*fargs).float()
                     - ref.float()).abs().max().item()
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
    return worst


# ----------------------------------------------------------- phases 5-7

def launch_counters():
    from exllama_tpu_torch.ops import attention, attn_block, dense, mlp, quant

    return {"q4_gemv": quant.q4_gemv,
            "q4_dequant_matmul": quant.q4_dequant_matmul,
            "flash_attn": attention.attend,
            "dense_gemv": dense.dense_gemv,
            "head_argmax": dense.head_argmax,
            "q4_mlp": mlp.q4_mlp,
            "layer_tail": attn_block.layer_tail,
            "kv_commit": attention.kv_commit}


def zero_counts():
    for f in launch_counters().values():
        f.launches = 0


def counts():
    return {k: f.launches for k, f in launch_counters().items()}


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
    timer = Timer(device)
    res = {}
    kernel_cases(device, timer, res)
    fused_cases(device, timer, res)
    log(f"[3 kernels] all agree ({time.time() - t0:.1f} s)")

    t0 = time.time()
    worst = model_vs_cpu(device)
    log(f"[4 model] 2 layers at 7B width, 64-token prefill + 8 decode steps, "
        f"default and fuse_qkv + K8 commit: card vs CPU logits within "
        f"{worst:.4f} of the logit scale (limit 0.03), greedy head agrees "
        f"({time.time() - t0:.1f} s)")

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
        if "separate_ms" in r:
            entry["separate_ms"] = r["separate_ms"]
        summary.append(entry)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
