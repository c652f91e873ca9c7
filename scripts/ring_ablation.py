#!/usr/bin/env python3
"""Where the time of the ring kernel goes (exllama_tpu_torch/csrc/q4_ring.cuh:
K2, K10, K11 and K12), how its W8 mode (K11) and the lm_head GEMV K4
(csrc/dense_stream.cuh) fare at other ring depths, and where the decode
layer kernel K7 (csrc/layer_tail.cu) spends its time, on one CUDA card.

    python3 scripts/ring_ablation.py [--out FILE] [--only VARIANT ...]
                                     [--parent CSRC_DIR]

Builds copies of the kernel sources with parts of the work cut out or the
geometry changed, each into its own git-ignored directory
(exllama_tpu_torch/_build/ablation/), and times K2, K10, K11 and K12 at
Llama-7B shapes (M = 1919; K12 also at 33 rows) or K4 (lm_head 4096 x
32000 at M = 1, 2, 32) with each copy, one process a copy, in turns (the
whole kernels first and last):

  full           the kernels as they are;
  no_conversion  the producers copy but convert no weight slab and form no
                 Glu activation: copies and products (K11 converts nothing
                 anyway);
  no_products    the consumers multiply nothing: copies and conversion;
  copies         neither: the copies and the hand-overs alone;
  no_glu_form    K12 without its activation forming (the rest as is);
  w8_ring7, w8_ahead3, w8_ring7_ahead3
                 K11 with a 7-slab ring and / or 3 slabs in flight ahead of
                 the one handed over (as it is: 6 and 2);
  dense_stages3, dense_stages8, dense_rows64
                 K4 with a 3- or an 8-slab ring (as it is: 5), or with units
                 of 64 rows and a 4-slab ring (as it is: 32 rows);
  dense_2_per_sm K4 on two blocks an SM (as it is: one);
  dense_no_x, dense_no_products, dense_no_finish, dense_copies
                 K4 without its copies of x, without its products, without
                 the end of each tile's range (no partial sums, no ticket,
                 no output), or with none of the three: the weight's copies
                 alone;
  dense_no_split K4 on one block a column tile (125 at V = 32000), its K
                 not split (as it is: one block an SM, stream-K);
  k7_attention_only, k7_qkv_only, k7_o_only, k7_gateup_only, k7_down_only
                 K7 (layer_step and layer_tail at B = 1 and 2, past = 2000,
                 exact GEMVs, bf16 KV) with every other phase (and its
                 weights' prefetch) cut out, its grid barriers kept;
  k7_barriers_only
                 K7 with every phase cut out: the launch and its barriers;
  k7_no_grid_sync
                 K7 with each grid barrier replaced by a block barrier (its
                 results are wrong; its time is read);
  k7_tc_rows1    K7 and K6 with their one-row GEMV phases on the
                 tensor-core GEMV (as they are: the streaming GEMV,
                 csrc/q4_stream.cuh);
  k7_stream_stages4, k7_one_block_an_sm, k7_occ3
                 the streaming GEMV with a 4-slab ring (as it is: 3); K7
                 and K6 on one block an SM (as they are: up to four, two
                 at their shared memory); on three blocks an SM
                 (__launch_bounds__ 3: fewer registers);
  k7_stream_no_x, k7_stream_no_products, k7_no_prefetch
                 the streaming GEMV without forming x (garbage x), without
                 its products, or without putting a phase's first weights
                 in flight before the grid barrier;
  k1_tc_rows1    K1 at one row on the tensor-core route (as it is: the
                 streaming GEMV);
  tc_part_m_stride, tc_plan_ungrouped, mlp_glu_runtime, k7_combine_phase
                 the 2..32-row paths of K1, K6 and K7 with one change each:
                 the tensor-core GEMV's split partials strided by M rows
                 (as it is: by the padded MP); its splits in K6 / K7
                 planned without regard to groups (timing only: the a8
                 modes then quantize a cut group in parts; as it is: at
                 group boundaries); the MLP's silu(gate)*up choice made at
                 run time (as it is: at compile time, per row tile); K7's
                 key splits merged in a phase of their own after a grid
                 barrier (as it is: by each pair's last block);
  sk_tid_guard, sk_uncapped, sk_noinline
                 the stream-K header shared by K4, K5 and the one-row GEMV
                 (csrc/stream_k.cuh) with its tile combine's stores and
                 loads guarded by tid < BN (as it is: no guard, every
                 thread holds a column), with the grid not capped at the
                 unit count (timing only: a grid above it would hang), or
                 with its tile combine out of line;
  k5_unit_norm, k5_no_finish
                 K5 norming x unit by unit in the ring's slabs at every row
                 count (as it is: the whole rows once a block at <= 8
                 rows); K5 without its end (the block's key reduction, the
                 atomics, the last block's ids).

--parent DIR adds the variant "parent": the decode kernels (K1, K4-K7)
built from DIR, another checkout's exllama_tpu_torch/csrc, and timed
through this tree's wrappers (their C signatures must agree; K5's older
one, without K4's scratch, is called as it is), so that a change is timed
against its parent in the same call.

The "full" and "parent" runs also time K5 (head_argmax) at M = 1, 2, 8, 32
and V = 32000 / 32001 beside torch.argmax(torch.matmul(...)), K7 over int8
and int4 caches, in a8, at B = 2 beside its separate chain (K1, K3 and
plain tensor code), and K1 / K6 at one row and at 18 (K6 also in a8). K4 is also timed through its C launcher alone ("launcher": the output and
scratch allocated once, no Python checks), to tell the kernel's time from
the wrapper's.

A cut-out copy computes garbage; only its time is read. One JSON line per
copy: {"variant": ..., "ms": {case: median ms}}. Times are chip_smoke's
Timer (L2 flushed, fenced, the card spun first).
"""

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from exllama_tpu_torch import kernels  # noqa: E402

RING, DENSE, SK = "q4_ring.cuh", "dense_stream.cuh", "stream_k.cuh"
TAIL, FUSED, GEMV = "layer_tail.cu", "fused_layer.cuh", "q4_gemv.cu"
STREAM, TC, HEAD = "q4_stream.cuh", "q4_gemv_tc.cuh", "head_argmax.cu"
RING_STEMS = ("q4_matmul", "q4_prefill_a8", "w8_matmul")
_NO_CONVERSION = [
    (RING, "if constexpr (!T::W8) cv.slab(", "if constexpr (false) cv.slab("),
    (RING, "if constexpr (MODE == Mode::Glu) form_glu<T>(",
     "if constexpr (false) form_glu<T>("),
]
_NO_PRODUCTS = [
    (RING, "for (int kk = 0; kk < BK / 32; ++kk)", "for (int kk = 0; kk < 0; ++kk)"),
    (RING, "for (int kk = 0; kk < BK / 16; ++kk)", "for (int kk = 0; kk < 0; ++kk)"),
]
_W8_RING7 = [(RING, "static constexpr int RING = INT8 ? 6 : 4;",
              "static constexpr int RING = W8 ? 7 : INT8 ? 6 : 4;")]
_W8_AHEAD3 = [(RING, "static constexpr int AHEAD = 2;",
               "static constexpr int AHEAD = W8 ? 3 : 2;")]


def _dense_stages(n):
    return [(DENSE, "constexpr int STAGES = 5;", f"constexpr int STAGES = {n};")]


_DENSE_NO_X = [(DENSE, "for (int i = tid; i < XROWS * (ROWS / 8); i += THREADS) {",
                "for (int i = tid; i < 0; i += THREADS) {")]
_DENSE_NO_PRODUCTS = [
    (DENSE, "    else\n      tc_unit<MB, ALIGNED>(c, ws, reinterpret_cast<const bf16*>(slab + W_SLAB),",
     "    else if (u < 0)\n      tc_unit<MB, ALIGNED>(c, ws, reinterpret_cast<const bf16*>(slab + W_SLAB),")]
_DENSE_NO_FINISH = [(DENSE, "if (u + 1 < u1 && (u + 1) % KU) continue;", "continue;")]


# K7's phases, each cut out (with the prefetch of its first weights) by
# these patches (the bf16-cache build)
_K7_CUT = {
    "qkv": [(TAIL, "    fused::gemv_phase<MB, GEMV_MODE>(x, p.qkv,",
             "    if (false) fused::gemv_phase<MB, GEMV_MODE>(x, p.qkv,")],
    "attention": [(TAIL, "  attention_phase<0>(p, reinterpret_cast<float*>(smem));",
                   "  if (false) attention_phase<0>(p, reinterpret_cast<float*>(smem));")],
    "o": [(TAIL, "  fused::gemv_phase<MB, GEMV_MODE>(\n      xo, p.o,",
           "  if (false) fused::gemv_phase<MB, GEMV_MODE>(\n      xo, p.o,"),
          (TAIL, "  fused::gemv_prefetch<MB>(p.o,", "  if (false) fused::gemv_prefetch<MB>(p.o,")],
    "gateup": [(FUSED, "  gemv_phase<MB, MODE>(\n      xa, gu,",
                "  if (false) gemv_phase<MB, MODE>(\n      xa, gu,"),
               (TAIL, "  fused::gemv_prefetch<MB>(p.gu,", "  if (false) fused::gemv_prefetch<MB>(p.gu,")],
    "down": [(FUSED, "  gemv_phase<MB, MODE>(\n      xb, dn,",
              "  if (false) gemv_phase<MB, MODE>(\n      xb, dn,"),
             (FUSED, "  gemv_prefetch<MB>(dn,", "  if (false) gemv_prefetch<MB>(dn,")],
}


def _k7_only(*keep):
    return [patch for name, patches in _K7_CUT.items() if name not in keep
            for patch in patches]


def _stream(old, new):
    return [(STREAM, old, new)]


K7_STEMS = ("layer_tail",)
DECODE_STEMS = ("q4_gemv", "dense_gemv", "head_argmax", "q4_mlp", "q4_mlp_a8",
                "layer_tail", "layer_tail_kvq", "layer_tail_a8", "flash_attn")
SK_STEMS = ("dense_gemv", "head_argmax", "q4_gemv")
ROWS_STEMS = ("q4_gemv", "q4_mlp", "q4_mlp_a8", "layer_tail", "flash_attn")
# K7's key splits merged as before PR 9's last-block merge: a phase of
# its own, one warp a (batch row, head), after a grid barrier
_K7_COMBINE_PHASE = [
    (TAIL, """    if (threadIdx.x == 0)
      last_split = atomicAdd(p.gsc.ticket + bh, 1u) == (unsigned)(p.nsplit - 1);""",
     """    if (threadIdx.x == 0)
      last_split = 0;"""),
    (TAIL, """template <int MB>
__global__ void __launch_bounds__(THREADS, 2) layer_tail_kernel(""",
     """__device__ void combine_phase(const TailParams& p) {
  const int lane = threadIdx.x & 31;
  const int G = p.H / p.Hkv;
  const int gw = blockIdx.x * WARPS + (threadIdx.x >> 5);
  for (int it = gw; it < p.B * p.H; it += gridDim.x * WARPS) {
    const int b = it / p.H, head = it - b * p.H;
    const int hk = head / G, j = head - hk * G;
    const float* base = p.part + ((size_t)(b * p.Hkv + hk) * p.nsplit * G + j) * (D + 2);
    const size_t stride = (size_t)G * (D + 2);
    float mm = MASK_VALUE;
    for (int sp = 0; sp < p.nsplit; ++sp) mm = fmaxf(mm, __ldcg(base + sp * stride + D));
    float ll = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sp = 0; sp < p.nsplit; ++sp) {
      const float* ps = base + sp * stride;
      const float f = expf(__ldcg(ps + D) - mm);
      ll += f * __ldcg(ps + D + 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] += f * __ldcg(ps + lane * 4 + e);
    }
    if (ll == 0.f) ll = 1.f;
    bf16* dst = p.attn_scr + (size_t)b * p.H * D + (size_t)head * D + lane * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = f2bf(a[e] / ll);
  }
}

template <int MB>
__global__ void __launch_bounds__(THREADS, 2) layer_tail_kernel("""),
    (TAIL, """  fused::gemv_prefetch<MB>(p.o, p.H * D, p.gs, smem);
  fused::grid_sync(p.bar, epoch);""", """  fused::grid_sync(p.bar, epoch);
  combine_phase(p);
  fused::gemv_prefetch<MB>(p.o, p.H * D, p.gs, smem);
  fused::grid_sync(p.bar, epoch);"""),
]
_TC_PART_M_STRIDE = [
    (TC, "float* mine = part + (size_t)item * MP * BN;",
     "float* mine = part + (size_t)item * M * BN;"),
    (TC, "const float* base = part + (size_t)cb * nsplit * MP * BN;",
     "const float* base = part + (size_t)cb * nsplit * M * BN;"),
    (TC, "__ldcg(reinterpret_cast<const float4*>(base + (size_t)s * MP * BN + i));",
     "__ldcg(reinterpret_cast<const float4*>(base + (size_t)s * M * BN + i));"),
]
_TC_PLAN_UNGROUPED = [
    (TC, "  const int ups = (groups + s - 1) / s * gu;",
     "  const int ups = (units + s - 1) / s;"),
]
_MLP_GLU_RUNTIME = [
    (FUSED, "  if constexpr (MB > 1) {\n    // ... except at 2..32 rows",
     "  if (M > 1) {\n    // ... except at 2..32 rows"),
]
_K7_TC_ROWS1 = [(FUSED, "static inline int fused_mb(int m) { return m <= 1 ? 1 : m <= 16 ? 16 : 32; }",
                 "static inline int fused_mb(int m) { return m <= 16 ? 16 : 32; }")]


# variant -> (libraries it builds and times, patches (header, old, new),
# names in exllama_tpu_torch.ops ("module.name") replaced while it is timed)
VARIANTS = {
    "full": (RING_STEMS + DECODE_STEMS, [], {}),
    "no_conversion": (RING_STEMS, _NO_CONVERSION, {}),
    "no_products": (RING_STEMS, _NO_PRODUCTS, {}),
    "copies": (RING_STEMS, _NO_CONVERSION + _NO_PRODUCTS, {}),
    "no_glu_form": (("q4_matmul",), _NO_CONVERSION[1:], {}),
    "w8_ring7": (("w8_matmul",), _W8_RING7, {}),
    "w8_ahead3": (("w8_matmul",), _W8_AHEAD3, {}),
    "w8_ring7_ahead3": (("w8_matmul",), _W8_RING7 + _W8_AHEAD3, {}),
    "dense_stages3": (("dense_gemv",), _dense_stages(3), {}),
    "dense_stages8": (("dense_gemv",), _dense_stages(8), {}),
    "dense_rows64": (("dense_gemv",), _dense_stages(4) + [
        (DENSE, "constexpr int ROWS = 32;", "constexpr int ROWS = 64;")], {}),
    "dense_2_per_sm": (("dense_gemv",), [], {
        "dense.dense_grid": lambda k, v, sms: (-(-v // 256), 2 * sms)}),
    "dense_no_x": (("dense_gemv",), _DENSE_NO_X, {}),
    "dense_no_products": (("dense_gemv",), _DENSE_NO_PRODUCTS, {}),
    "dense_no_finish": (("dense_gemv",), _DENSE_NO_FINISH, {}),
    "dense_copies": (("dense_gemv",),
                     _DENSE_NO_X + _DENSE_NO_PRODUCTS + _DENSE_NO_FINISH, {}),
    "dense_no_split": (("dense_gemv",), [], {
        "dense.dense_grid": lambda k, v, sms: (-(-v // 256), -(-v // 256))}),
    "k7_attention_only": (K7_STEMS, _k7_only("attention"), {}),
    "k7_qkv_only": (K7_STEMS, _k7_only("qkv"), {}),
    "k7_o_only": (K7_STEMS, _k7_only("o"), {}),
    "k7_gateup_only": (K7_STEMS, _k7_only("gateup"), {}),
    "k7_down_only": (K7_STEMS, _k7_only("down"), {}),
    "k7_barriers_only": (K7_STEMS, _k7_only(), {}),
    "k7_no_grid_sync": (K7_STEMS, [(FUSED, "  __threadfence();\n  __syncthreads();\n  epoch += 1;",
                                    "  __syncthreads();\n  return;\n  epoch += 1;")], {}),
    "k7_tc_rows1": (("layer_tail", "q4_mlp"), _K7_TC_ROWS1, {}),
    "k7_stream_stages4": (("layer_tail", "q4_mlp"), _stream(
        "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"), {}),
    "k7_stream_no_x": (("layer_tail", "q4_mlp"), _stream(
        "    if (warp == 0 && u + 1 < u1)  // unit u + 1's x, read after the next barrier",
        "    if (false)"), {}),
    "k7_no_prefetch": (("layer_tail", "q4_mlp"), [
        (FUSED, "  if constexpr (MB == 1) q4s::prefetch(w, K, gs, smem);", ""),
        (FUSED, "    q4s::gemv_stream<MODE>(src, w, K, gs, sc.part, sc.ticket, smem, epi, prefetched);",
         "    q4s::gemv_stream<MODE>(src, w, K, gs, sc.part, sc.ticket, smem, epi, false);")], {}),
    "k7_stream_no_products": (("layer_tail", "q4_mlp"), _stream(
        "    unit_products<MODE>(acc,", "    if (u < 0) unit_products<MODE>(acc,"), {}),
    "k7_one_block_an_sm": (("layer_tail", "q4_mlp"), [
        (FUSED, "constexpr int MAX_BLOCKS_PER_SM = 4;", "constexpr int MAX_BLOCKS_PER_SM = 1;")], {}),
    "k7_occ3": (("layer_tail", "q4_mlp"), [
        (TAIL, "__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 3)"),
        ("q4_mlp.cu", "__launch_bounds__(q4::THREADS, 2)", "__launch_bounds__(q4::THREADS, 3)")],
        {}),
    "k1_tc_rows1": (("q4_gemv",), [(GEMV, "  if (M == 1 && gs <= 128", "  if (false && gs <= 128")],
                    {"quant.gemv_tc_route": lambda m, gs: True}),
    "tc_part_m_stride": (ROWS_STEMS, _TC_PART_M_STRIDE, {}),
    "tc_plan_ungrouped": (ROWS_STEMS, _TC_PLAN_UNGROUPED, {}),
    "mlp_glu_runtime": (ROWS_STEMS, _MLP_GLU_RUNTIME, {}),
    "k7_combine_phase": (ROWS_STEMS, _K7_COMBINE_PHASE, {}),
    "sk_tid_guard": (SK_STEMS, [
        (SK, "    if (m < M) mine[m * BN] = v[m];", "    if (m < M && tid < BN) mine[m * BN] = v[m];"),
        (SK, "  for (int blk = first; blk <= last; ++blk) {",
         "  for (int blk = first; tid < BN && blk <= last; ++blk) {")], {}),
    "sk_uncapped": (SK_STEMS, [
        (SK, "grid = (int)min((long long)gridDim.x, U);", "grid = (int)gridDim.x;")], {}),
    "sk_noinline": (SK_STEMS, [
        (SK, "__device__ __forceinline__ bool finish_tile(",
         "__device__ __noinline__ bool finish_tile(")], {}),
    "k5_unit_norm": (("head_argmax",), [
        (HEAD, "  if constexpr (MB <= 8) {", "  if constexpr (false) {")], {}),
    "k5_no_finish": (("head_argmax",), [
        (HEAD, "  // the block's best key per row: the warp's, then the block's, one atomic",
         "  return;")], {}),
}
SRC, OUT_DIR = kernels.CSRC, kernels.BUILD_DIR / "ablation"
LIBRARIES = dict(kernels.LIBRARIES)
PARENT_SRC = OUT_DIR / "parent.src"   # where --parent's sources are copied


def point_at(variant):
    """Make the package build and load this copy's libraries."""
    d = OUT_DIR / variant
    kernels.CSRC, kernels.BUILD_DIR = d, d / "_b"
    kernels.LIBRARIES = {k: LIBRARIES[k] for k in VARIANTS[variant][0]}


def build(variants):
    procs = []
    for v in variants:
        d = OUT_DIR / v
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(PARENT_SRC if v == "parent" else SRC, d)
        libs, patches, _ = VARIANTS[v]
        for header, old, new in patches:
            src = (d / header).read_text()
            if old not in src:
                raise SystemExit(f"{v}: '{old}' is not in {header}; update "
                                 f"the ablation patches")
            (d / header).write_text(src.replace(old, new))
        (d / "_b").mkdir()
        point_at(v)
        for lib in libs:
            stem, flags = LIBRARIES[lib]
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", str(d),
                   "-o", str(kernels._target(lib)), str(d / f"{stem}.cu")]
            log = open(d / "_b" / f"{lib}.log", "w")
            procs.append((v, lib, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = set()
    for v, lib, p in procs:
        if p.wait() != 0:
            failed.add(v)
            print(f"# nvcc failed for {v} {lib}, not timed:\n"
                  + (OUT_DIR / v / "_b" / f"{lib}.log").read_text()[-2000:],
                  file=sys.stderr)
    if "full" in failed:
        raise SystemExit("the kernels as they are do not build")
    return [v for v in variants if v not in failed]


def time_ring(timer, gen, dev, stems, ms):
    import chip_smoke as cs
    from exllama_tpu_torch.formats.gptq import w8_col_scale, with_w8
    from exllama_tpu_torch.ops import quant

    for nm, k, n in (("o", 4096, 4096), ("qkv", 4096, 12288),
                     ("gateup", 4096, 22016), ("down", 11008, 4096)):
        qt = cs.random_qt(gen, k, n, 128, False, dev)
        qt = with_w8(qt) if nm != "o" and "w8_matmul" in stems else qt
        ws = w8_col_scale(qt) if qt.w8_scale is None else qt.w8_scale
        x = torch.randn((1919, k), generator=gen, device=dev).bfloat16()
        if "q4_matmul" in stems and nm != "qkv":
            ms[f"K2 {nm} M=1919"] = timer(
                lambda: quant.q4_dequant_matmul(x, qt), 10)
        if "q4_prefill_a8" in stems and nm != "qkv":
            ms[f"K10 {nm} M=1919"] = timer(
                lambda: quant.q4_prefill_a8(x, qt, ws), 10)
        if qt.w8 is not None:
            ms[f"K11 {nm} M=1919"] = timer(lambda: quant.w8_matmul(x, qt), 10)
        del qt
    if "q4_matmul" in stems:
        down = cs.random_qt(gen, 11008, 4096, 128, False, dev)
        for m in (33, 1919):
            x = torch.randn((m, 22016), generator=gen, device=dev).bfloat16()
            ms[f"K12 down M={m}"] = timer(
                lambda: quant.q4_matmul_glu(x, down, 11008, 11008), 10)


def time_dense(timer, gen, dev, ms):
    from exllama_tpu_torch.ops import dense, quant

    w = (torch.randn((4096, 32000), generator=gen, device=dev)
         * 0.02).bfloat16()
    w1 = (torch.randn((4096, 32001), generator=gen, device=dev)
          * 0.02).bfloat16()
    for m in (1, 2, 8, 16, 32):
        x = torch.randn((m, 4096), generator=gen, device=dev).bfloat16()
        ms[f"K4 lm_head M={m}"] = timer(lambda: dense.dense_gemv(x, w), 20)
    ms["K4 lm_head V=32001 M=1"] = timer(lambda: dense.dense_gemv(x[:1], w1),
                                         20)
    x1 = x[:1].contiguous()
    tiles, grid = dense.dense_grid(4096, 32000, kernels.sm_count(dev))
    part, ticket = quant.gemv_scratch(dev, grid * 2 * 256, tiles)
    out = torch.empty((1, 32000), dtype=torch.float32, device=dev)
    fn = kernels.launcher("dense_gemv")
    args = (x1.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(),
            ticket.data_ptr(), 1, 4096, 32000, grid, kernels.stream_of(x1))
    ms["K4 lm_head M=1 launcher"] = timer(lambda: fn(*args), 20)
    ms["torch.matmul lm_head M=1"] = timer(lambda: torch.matmul(x1, w), 20)


def time_head(timer, gen, dev, variant, ms):
    """K5 beside torch.argmax(torch.matmul(...)) on the normed rows."""
    import ctypes

    from exllama_tpu_torch.ops import dense
    from exllama_tpu_torch.ops.norms import rms_norm

    nw = (torch.rand(4096, generator=gen, device=dev) + 0.5).bfloat16()
    old = "void* part" not in (OUT_DIR / variant / "head_argmax.cu").read_text()
    for v in (32000, 32001):
        w = (torch.randn((4096, v), generator=gen, device=dev)
             * 0.02).bfloat16()
        for m in (1, 2, 8, 32):
            x = torch.randn((m, 4096), generator=gen, device=dev).bfloat16()
            if old:  # a source from before K5 took K4's scratch
                fn = kernels.launcher("head_argmax")
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
                    ctypes.c_float, ctypes.c_void_p]
                keys = torch.empty((m,), dtype=torch.int64, device=dev)
                ids = torch.empty((m,), dtype=torch.int32, device=dev)
                args = (x.data_ptr(), nw.data_ptr(), w.data_ptr(),
                        keys.data_ptr(), ids.data_ptr(), m, 4096, v, 1e-6,
                        kernels.stream_of(x))
                ms[f"K5 V={v} M={m}"] = timer(lambda: fn(*args), 20)
            else:
                ms[f"K5 V={v} M={m}"] = timer(
                    lambda: dense.head_argmax(x, nw, w, 1e-6), 20)
            if m in (1, 32):
                xn = rms_norm(x, nw, 1e-6)
                ms[f"argmax(matmul) V={v} M={m}"] = timer(
                    lambda: torch.argmax(torch.matmul(xn, w), dim=-1), 20)
        del w


def time_tail(timer, gen, dev, stems, ms):
    """K7 at Llama-7B shapes, past = 2000; with all its builds also over
    int8 / int4 caches, in a8, and at B = 2 (GQA 8) beside its chain."""
    import chip_smoke as cs
    from exllama_tpu_torch.ops import attention, attn_block, mlp, quant
    from exllama_tpu_torch.ops.norms import rms_norm
    from exllama_tpu_torch.ops.rope import rope_tables, slice_tables

    hidden, inter, heads, d, s_max, past, eps = 4096, 11008, 32, 128, 2048, 2000, 1e-6

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    o = cs.random_qt(gen, heads * d, hidden, 128, False, dev)
    gu = cs.random_qt(gen, hidden, 2 * inter, 128, False, dev)
    dn = cs.random_qt(gen, inter, hidden, 128, False, dev)
    nw = (torch.rand(hidden, generator=gen, device=dev) + 0.5).bfloat16()
    sin, cos = rope_tables(s_max, d, device=dev)
    sin_t, cos_t = slice_tables(sin, cos, past, 1)
    for b, hkv in ((1, 32), (2, 8)):
        qkv = cs.random_qt(gen, hidden, (heads + 2 * hkv) * d, 128, False, dev)
        h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
        kc, vc = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d)
        new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
        tail = (h, q, kc, vc, past, s_max, o, nw, gu, dn, eps, new_kv)
        ms[f"K7 layer_tail B={b}"] = timer(
            lambda: attn_block.layer_tail(*tail), 10)
        if b == 1:
            ms["K7 layer_step B=1"] = timer(lambda: attn_block.layer_step(
                h, qkv, nw, sin_t, cos_t, kc, vc, past, s_max, o, nw, gu, dn,
                eps, heads, hkv, d), 10)
        if b == 1 and "layer_tail_a8" in stems:
            ms["K7 layer_tail a8 B=1"] = timer(
                lambda: attn_block.layer_tail(*tail, impl="pallas_a8"), 10)
        if b == 1 and "layer_tail_kvq" in stems:
            for kind, qz in (("int8", attention.quantize_kv_rows),
                             ("int4", attention.quantize_kv_rows4)):
                (kq, ks), (vq, vs) = qz(kc), qz(vc)
                ms[f"K7 layer_tail B=1 {kind}"] = timer(
                    lambda: attn_block.layer_tail(
                        h, q, kq, vq, past, s_max, o, nw, gu, dn, eps, new_kv,
                        k_scale=ks, v_scale=vs), 10)
        if b > 1 and "flash_attn" in stems:
            def chain():
                attn = attention.attend(q, kc, vc, past, s_max, None, new_kv)
                h1 = h + quant.q4_matmul(attn.reshape(b, 1, heads * d), o)
                mid = mlp.silu_mul(quant.q4_matmul(rms_norm(h1, nw, eps), gu),
                                   inter)
                return h1 + quant.q4_matmul(mid, dn)
            ms[f"separate chain B={b}"] = timer(chain, 10)
        del kc, vc, qkv


def time_rows(timer, gen, dev, stems, ms):
    """K1 (qkv 4096 -> 12288, norm) and K6 at one row and at 18 rows (K6
    also in a8)."""
    import chip_smoke as cs
    from exllama_tpu_torch.ops import mlp, quant

    nw = (torch.rand(4096, generator=gen, device=dev) + 0.5).bfloat16()
    if "q4_gemv" in stems:
        qkv = cs.random_qt(gen, 4096, 12288, 128, False, dev)
        for m in (1, 18):
            x = torch.randn((m, 4096), generator=gen, device=dev).bfloat16()
            ms[f"K1 qkv M={m}"] = timer(
                lambda: quant.q4_gemv(x, qkv, nw, 1e-6), 15)
    if "q4_mlp" in stems:
        gu = cs.random_qt(gen, 4096, 22016, 128, False, dev)
        dn = cs.random_qt(gen, 11008, 4096, 128, False, dev)
        for m in (1, 18):
            h = torch.randn((1, m, 4096), generator=gen, device=dev).bfloat16()
            ms[f"K6 M={m}"] = timer(
                lambda: mlp.q4_mlp(h, nw, gu, dn, 1e-6), 15)
            if m > 1 and "q4_mlp_a8" in stems:
                ms[f"K6 a8 M={m}"] = timer(lambda: mlp.q4_mlp(
                    h, nw, gu, dn, 1e-6, impl="pallas_a8"), 15)


def time_variant(v):
    import importlib

    import chip_smoke as cs

    point_at(v)
    stems, _, names = VARIANTS[v]
    for name, value in names.items():
        mod, attr = name.split(".")
        setattr(importlib.import_module(f"exllama_tpu_torch.ops.{mod}"), attr,
                value)
    dev = torch.device("cuda")
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    ms = {}
    if set(stems) & set(RING_STEMS):
        time_ring(timer, gen, dev, stems, ms)
    if "dense_gemv" in stems:
        time_dense(timer, gen, dev, ms)
    if "head_argmax" in stems:
        time_head(timer, gen, dev, v, ms)
    if "layer_tail" in stems:
        time_tail(timer, gen, dev, stems, ms)
    time_rows(timer, gen, dev, stems, ms)
    print(json.dumps({"variant": v, "ms": ms}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS),
                    help="build and time these variants (and full) alone")
    ap.add_argument("--parent", help="another checkout's "
                    "exllama_tpu_torch/csrc, timed as the variant 'parent'")
    ap.add_argument("--time", help=argparse.SUPPRESS)   # one copy, in-process
    args = ap.parse_args()
    if args.parent:
        VARIANTS["parent"] = (DECODE_STEMS, [], {})
    if args.time:
        time_variant(args.time)
        return 0
    if not torch.cuda.is_available():
        print("ring_ablation: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    chosen = [v for v in VARIANTS if v != "full" and (
        not args.only or v in args.only)]
    if args.parent:
        if PARENT_SRC.exists():
            shutil.rmtree(PARENT_SRC)
        shutil.copytree(args.parent, PARENT_SRC)
        chosen.append("parent")
    chosen = build(["full", *chosen])[1:]
    print(f"# built {len(chosen) + 1} copies in {time.time() - t0:.1f} s",
          flush=True)
    lines = []
    for v in ["full", *chosen, "full"]:
        extra = ["--parent", args.parent] if v == "parent" else []
        r = subprocess.run([sys.executable, __file__, "--time", v, *extra],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            print(r.stdout + r.stderr[-3000:], file=sys.stderr)
            return 1
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
