#!/usr/bin/env python3
"""Where the time of the ring kernel goes (exllama_tpu_torch/csrc/q4_ring.cuh:
K10, K11, K12 and its Exact mode, K2's parent), how its W8 mode (K11) and the lm_head GEMV K4
(csrc/dense_stream.cuh) fare at other ring depths, and where the decode
layer kernel K7 (csrc/layer_tail.cu) spends its time, on one CUDA card.

    python3 scripts/ring_ablation.py [--out FILE] [--only VARIANT ...]
                                     [--parent CSRC_DIR]

Builds copies of the kernel sources with parts of the work cut out or the
geometry changed, each into its own git-ignored directory
(exllama_tpu_torch/_build/ablation/), and times K2's parent (the ring's
Exact mode: K2 itself runs csrc/q4_wgmma.cuh, which
scripts/k2_ablation.py takes apart), K10, K11 and K12 at
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
  k7_stream_stages4, k7_one_block_an_sm, k7_occ3
                 the streaming GEMV with a 4-slab ring (as it is: 3); K7
                 and K6 on one block an SM (as they are: up to four, two
                 at their shared memory); on three blocks an SM
                 (__launch_bounds__ 3: fewer registers);
  k7_stream_no_x, k7_stream_no_products, k7_no_prefetch
                 the streaming GEMV without forming x (garbage x), without
                 its products, or (one row) without putting a phase's
                 first weights in flight before the grid barrier;
  k1_tc_rows1    K1 at one row on the tensor-core route (as it is: the
                 streaming GEMV);
  k1_stream_rows K1 at 2..32 rows on the streaming GEMV, built at row
                 tiles 8, 16, 24 and 32 (as it is: the tensor-core route;
                 the streaming GEMV at one row only);
  mlp_glu_staged, rows16_at_2, rows32_two_blocks, rows_prefetch,
  rows_no_combine
                 K6 and K7 at 2..32 rows with silu(gate)*up formed as the
                 down phase stages each unit (as it is: once, in a pass of
                 its own between two grid barriers), with 2..8 rows in the
                 16-row tile (as it is: 8), with the 32-row tile built for
                 two blocks an SM (as it is: one), with the next phase's
                 weights put in flight before each barrier (as it is: at
                 one row only), or with split tiles not added up at all
                 (timing only: they are not written);
  rows32_bb2, rows32_bb2_two_blocks, rows_bb1, rows_bb1_16_24
                 the last block's combine of a split tile at 16..32 rows
                 reading BB blocks' partials at a time (as it is: one in
                 the exact mode, two at 16 / 24 and four at 32 rows in the
                 a8 modes): two at 16..32 rows in every mode (with the
                 32-row tile at two blocks an SM too), one in every mode,
                 or one at 16 / 24 and two at 32;
  tc_part_m_stride, k7_combine_phase
                 K1's tensor-core GEMV with its split partials strided by M
                 rows (as it is: by the padded MP); K7's key splits merged
                 in a phase of their own after a grid barrier (as it is: by
                 each pair's last block);
  k8_vec2, k8_vec4
                 K8's bf16 copy with two 16-byte vectors a thread in blocks
                 of 128, or four in blocks of 64 (as it is: one, 256);
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

--parent DIR adds the variant "parent": the decode kernels (K1, K4-K8)
built from DIR, another checkout's exllama_tpu_torch/csrc, and timed
through this tree's wrappers (their C signatures must agree; K5's older
one, without K4's scratch, and K8's, with the cursor by value, are called
as they are), so that a change is timed against its parent in the same
call.

The "full" and "parent" runs also time K5 (head_argmax) at M = 1, 2, 8, 32
and V = 32000 / 32001 beside torch.argmax(torch.matmul(...)), K7 over int8
and int4 caches, in a8, at B = 2 and 8 beside its separate chain (K1, K3
and plain tensor code), K1 on the four Llama-7B projections and K6 at 1,
2, 8, 18 and 32 rows (K6 also in a8 and a8x2 at 18, and beside its
separate chain -- K1 gate|up, silu(gate)*up, K1 down -- at 18, 24 and 32
rows), and K8 in each cache
format beside an empty launch. K4 is also timed through its C launcher
alone ("launcher": the output and scratch allocated once, no Python
checks), to tell the kernel's time from the wrapper's.

A cut-out copy computes garbage; only its time is read. One JSON line per
copy: {"variant": ..., "card": the card's name and power limit (nvidia-smi),
"ms": {case: median ms}}. Times are chip_smoke's
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
K8 = "kv_commit.cu"
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
    "o": [(TAIL, "  fused::gemv_phase<MB, GEMV_MODE>(xo, p.o,",
           "  if (false) fused::gemv_phase<MB, GEMV_MODE>(xo, p.o,"),
          (TAIL, "  fused::gemv_prefetch<MB, GEMV_MODE>(p.o,",
           "  if (false) fused::gemv_prefetch<MB, GEMV_MODE>(p.o,")],
    "gateup": [(FUSED, "  gemv_phase<MB, MODE>(xa, gu,",
                "  if (false) gemv_phase<MB, MODE>(xa, gu,"),
               (TAIL, "  fused::gemv_prefetch<MB, GEMV_MODE>(p.gu,",
                "  if (false) fused::gemv_prefetch<MB, GEMV_MODE>(p.gu,")],
    "down": [(FUSED, "  gemv_phase<MB, MODE>(xb, dn,",
              "  if (false) gemv_phase<MB, MODE>(xb, dn,"),
             (FUSED, "  gemv_prefetch<MB, MODE>(dn,", "  if (false) gemv_prefetch<MB, MODE>(dn,")],
}


def _k7_only(*keep):
    return [patch for name, patches in _K7_CUT.items() if name not in keep
            for patch in patches]


def _stream(old, new):
    return [(STREAM, old, new)]


K7_STEMS = ("layer_tail",)
DECODE_STEMS = ("q4_gemv", "dense_gemv", "head_argmax", "q4_mlp", "q4_mlp_a8",
                "q4_mlp_a8x2", "layer_tail", "layer_tail_kvq", "layer_tail_a8",
                "flash_attn", "kv_commit")
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
__global__ void __launch_bounds__(THREADS, q4s::min_blocks(MB))
    layer_tail_kernel(""",
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
__global__ void __launch_bounds__(THREADS, q4s::min_blocks(MB))
    layer_tail_kernel("""),
    (TAIL, """  fused::gemv_prefetch<MB, GEMV_MODE>(p.o, M, p.H * D, p.gs, smem);
  fused::grid_sync(p.bar, epoch);""", """  fused::grid_sync(p.bar, epoch);
  combine_phase(p);
  fused::gemv_prefetch<MB, GEMV_MODE>(p.o, M, p.H * D, p.gs, smem);
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
# the MLP's silu(gate)*up formed as the down phase stages each unit at
# 2..32 rows too (as it is: once, between two grid barriers): the slab
# keeps up's rows, and the loader and the forming read them
_MLP_GLU_STAGED = [
    (FUSED, "  if constexpr (MB > 1) {\n    // ... but at 2..32 rows it is formed once",
     "  if constexpr (false) {\n    // ... but at 2..32 rows it is formed once"),
    (STREAM, "    xsum_off = y_off + 2 * UR;", "    xsum_off = y_off + mp * 2 * UR;"),
    (STREAM, "  const int nx = rows * CH, ny = src.norm_w ? CH : 0;",
     "  const int nx = rows * CH, ny = glu ? nx : src.norm_w ? CH : 0;"),
    (STREAM, "    const bf16* sp = second ? src.norm_w + k : src.x + (size_t)m * src.ld + k;\n"
     "    unsigned char* dst = slab + (second ? G.y_off : X_OFF + m * G.xld) + 2 * c;",
     "    const bf16* sp = !second ? src.x + (size_t)m * src.ld + k\n"
     "                     : glu   ? src.x + (size_t)m * src.ld + src.glu_off + k\n"
     "                             : src.norm_w + k;\n"
     "    unsigned char* dst = slab + (second ? G.y_off + (glu ? m * 2 * UR : 0)\n"
     "                                        : X_OFF + m * G.xld) + 2 * c;"),
    (STREAM, "      const uint2 b = *reinterpret_cast<const uint2*>(slab + G.y_off + 2 * e0);",
     "      const uint2 b = *reinterpret_cast<const uint2*>(\n"
     "          slab + G.y_off + (src.glu_off > 0 ? m * 2 * UR : 0) + 2 * e0);"),
]

# K1's streaming kernel built at every row tile and routed by M (as it is:
# one row only, 2..32 rows on the tensor-core GEMV)
_K1_STREAM_ROWS = [
    (GEMV, "__global__ void __launch_bounds__(THREADS, 2) q4_gemv_stream_kernel(",
     "template <int MB>\n__global__ void __launch_bounds__(THREADS, q4s::min_blocks(MB))"
     " q4_gemv_stream_kernel("),
    (GEMV, "unsigned int* ticket, int K, int N, int gs,\n    float eps) {",
     "unsigned int* ticket, int M, int K, int N, int gs,\n    float eps) {"),
    (GEMV, "q4s::gemv_stream<1, GEMV_MODE>(src, w, 1, K, gs,",
     "q4s::gemv_stream<MB, GEMV_MODE>(src, w, M, K, gs,"),
    (GEMV, "cudaError_t launch_stream(", "template <int MB>\ncudaError_t launch_stream("),
    (GEMV, "unsigned int* ticket, int K, int N, int gs, float eps,\n"
     "                          cudaStream_t st) {",
     "unsigned int* ticket, int M, int K, int N, int gs, float eps,\n"
     "                          cudaStream_t st) {"),
    (GEMV, "const int smem = q4s::Geo(1, GEMV_MODE, 1).smem;",
     "const int smem = q4s::Geo(MB, GEMV_MODE, MB).smem;"),
    (GEMV, "allow_smem(q4_gemv_stream_kernel, smem)",
     "allow_smem(q4_gemv_stream_kernel<MB>, smem)"),
    (GEMV, "(&per_sm, q4_gemv_stream_kernel, THREADS,",
     "(&per_sm, q4_gemv_stream_kernel<MB>, THREADS,"),
    (GEMV, "q4_gemv_stream_kernel<<<grid, THREADS, smem, st>>>(x, qw, s, z, nw, xmap, out, "
     "part, ticket,\n                                                     K, N, gs, eps);",
     "q4_gemv_stream_kernel<MB><<<grid, THREADS, smem, st>>>(x, qw, s, z, nw, xmap, out, "
     "part, ticket, M, K, N, gs, eps);"),
    (GEMV, "  if (M == 1 && gs <= 128 && (gs & (gs - 1)) == 0)\n"
     "    return launch_stream(bx, qw, s, z, nw, xm, o, pt, tk, K, N, gs, eps, st);",
     "  if (gs <= 128 && (gs & (gs - 1)) == 0) switch (q4s::row_tile(M)) {\n"
     + "".join(f"    case {t}: return launch_stream<{t}>(bx, qw, s, z, nw, xm, o, pt, tk, M, K, "
               f"N, gs, eps, st);\n" for t in (1, 8, 16, 24))
     + "    default: return launch_stream<32>(bx, qw, s, z, nw, xm, o, pt, tk, M, K, N, gs, "
     "eps, st);\n  }"),
]


def _scratch_of_32_rows(dev, m, widest_n, tickets=0):
    """quant.fused_gemv_scratch at 32 rows, whatever m: K1's wrapper asks
    for one row's, which k1_stream_rows overruns at 2..32 rows."""
    from exllama_tpu_torch.ops import quant

    blocks = 4 * kernels.sm_count(dev)
    return quant.gemv_scratch(dev, blocks * 32 * 2 * quant.STREAM_BN,
                              max(tickets, -(-widest_n // quant.GEMV_BN)))


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
    "k7_stream_stages4": (("layer_tail", "q4_mlp"), _stream(
        "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"), {}),
    "k7_stream_no_x": (("layer_tail", "q4_mlp"), _stream(
        "    if (u + 1 < u1)  // unit u + 1's x, read after the next barrier",
        "    if (false)"), {}),
    "k7_no_prefetch": (("layer_tail", "q4_mlp", "q4_mlp_a8"), [
        (FUSED, "  if constexpr (MB == 1) q4s::prefetch<MB, MODE>(w, M, K, gs, smem);", ""),
        (FUSED, "MB == 1 && prefetched);", "false);")], {}),
    "rows_prefetch": (("layer_tail", "q4_mlp", "q4_mlp_a8"), [
        (FUSED, "  if constexpr (MB == 1) q4s::prefetch<MB, MODE>(w, M, K, gs, smem);",
         "  q4s::prefetch<MB, MODE>(w, M, K, gs, smem);"),
        (FUSED, "MB == 1 && prefetched);", "prefetched);")], {}),
    "k7_stream_no_products": (("layer_tail", "q4_mlp"), _stream(
        "    unit_products<MB, MODE>(acc,", "    if (u < 0) unit_products<MB, MODE>(acc,"), {}),
    "mlp_glu_staged": (("layer_tail", "q4_mlp", "q4_mlp_a8"), _MLP_GLU_STAGED, {}),
    "rows32_two_blocks": (("layer_tail", "q4_mlp"), _stream(
        "return mb == 32 ? 1 : 2;", "return 2;"), {}),
    "rows32_bb2": (("layer_tail", "q4_mlp"), _stream(
        "constexpr int BB = MODE == q4::EXACT && MB >= 16 ? 1 : MB == 32 ? 4 : MB >= 16 ? 2 : 4;",
        "constexpr int BB = MB >= 16 ? 2 : 4;"), {}),
    "rows_bb1": (("layer_tail", "q4_mlp", "q4_mlp_a8"), _stream(
        "constexpr int BB = MODE == q4::EXACT && MB >= 16 ? 1 : MB == 32 ? 4 : MB >= 16 ? 2 : 4;",
        "constexpr int BB = MB >= 16 ? 1 : 4;"), {}),
    "rows_bb1_16_24": (("layer_tail", "q4_mlp", "q4_mlp_a8"), _stream(
        "constexpr int BB = MODE == q4::EXACT && MB >= 16 ? 1 : MB == 32 ? 4 : MB >= 16 ? 2 : 4;",
        "constexpr int BB = MB == 32 ? 2 : MB >= 16 ? 1 : 4;"), {}),
    "rows32_bb2_two_blocks": (("layer_tail", "q4_mlp"), [
        (STREAM, "constexpr int BB = MODE == q4::EXACT && MB >= 16 ? 1 : MB == 32 ? 4 : MB >= 16 ? 2 : 4;",
         "constexpr int BB = MB >= 16 ? 2 : 4;"),
        (STREAM, "return mb == 32 ? 1 : 2;", "return 2;")], {}),
    "rows_no_combine": (("layer_tail", "q4_mlp"), _stream(
        "        if (*answer != last - first) continue;  // another block finishes tile t",
        "        continue;"), {}),
    "rows16_at_2": (("layer_tail", "q4_mlp"), _stream(
        "m <= 1 ? 1 : m <= 8 ? 8 : m", "m <= 1 ? 1 : m"),
        {}),
    "k7_one_block_an_sm": (("layer_tail", "q4_mlp"), [
        (FUSED, "constexpr int MAX_BLOCKS_PER_SM = 4;", "constexpr int MAX_BLOCKS_PER_SM = 1;")], {}),
    "k7_occ3": (("layer_tail", "q4_mlp"), [
        (TAIL, "__launch_bounds__(THREADS, q4s::min_blocks(MB))", "__launch_bounds__(THREADS, 3)"),
        ("q4_mlp.cu", "__launch_bounds__(q4::THREADS, q4s::min_blocks(MB))",
         "__launch_bounds__(q4::THREADS, 3)")],
        {}),
    "k8_vec2": (("kv_commit",), [
        (K8, "constexpr int COPY_THREADS = 256;", "constexpr int COPY_THREADS = 128;"),
        (K8, "constexpr int VEC = 1;", "constexpr int VEC = 2;")], {}),
    "k8_vec4": (("kv_commit",), [
        (K8, "constexpr int COPY_THREADS = 256;", "constexpr int COPY_THREADS = 64;"),
        (K8, "constexpr int VEC = 1;", "constexpr int VEC = 4;")], {}),
    "k1_tc_rows1": (("q4_gemv",), [], {"quant.gemv_tc_route": lambda m, gs: True}),
    "k1_stream_rows": (("q4_gemv",), _K1_STREAM_ROWS, {
        "quant.gemv_tc_route": lambda m, gs: gs not in (32, 64, 128),
        "quant.fused_gemv_scratch": _scratch_of_32_rows}),
    "tc_part_m_stride": (("q4_gemv",), _TC_PART_M_STRIDE, {}),
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
            ms[f"K2's parent (the ring's Exact mode) {nm} M=1919"] = timer(
                lambda: cs.ring_parent(x, qt), 10)
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
    """K5's stream-K loop (K5 itself before it moved onto K4's Hopper
    kernel; its parent since, which these variants patch) beside
    torch.argmax(torch.matmul(...)) on the normed rows."""
    import ctypes

    import chip_smoke as cs
    from exllama_tpu_torch.ops import dense
    from exllama_tpu_torch.ops.norms import rms_norm

    nw = (torch.rand(4096, generator=gen, device=dev) + 0.5).bfloat16()
    src = (OUT_DIR / variant / "head_argmax.cu").read_text()
    old = "void* part" not in src
    parent = "head_argmax_stream_launch" in src
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
            elif parent:
                ms[f"K5 V={v} M={m}"] = timer(
                    lambda: cs.k5_parent(x, nw, w, 1e-6), 20)
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
    for b, hkv in ((1, 32), (2, 8), (8, 8)):
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
    """K1 on the four Llama-7B projections (qkv with the norm) at 1, 2, 8,
    18 and 32 rows, and K6 at the same rows (a8 and a8x2 at 18)."""
    import chip_smoke as cs
    from exllama_tpu_torch.ops import mlp, quant

    nw = (torch.rand(4096, generator=gen, device=dev) + 0.5).bfloat16()
    if "q4_gemv" in stems:
        for nm, k, n in (("qkv", 4096, 12288), ("o", 4096, 4096),
                         ("gateup", 4096, 22016), ("down", 11008, 4096)):
            qt = cs.random_qt(gen, k, n, 128, False, dev)
            w = nw if nm == "qkv" else None
            for m in ((1, 2, 8, 18, 32) if nm == "qkv" else (2, 8, 18, 32)):
                x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
                ms[f"K1 {nm} M={m}"] = timer(
                    lambda: quant.q4_gemv(x, qt, w, 1e-6), 15)
            del qt
    if "q4_mlp" in stems:
        gu = cs.random_qt(gen, 4096, 22016, 128, False, dev)
        dn = cs.random_qt(gen, 11008, 4096, 128, False, dev)
        for m in (1, 2, 8, 18, 32):
            h = torch.randn((1, m, 4096), generator=gen, device=dev).bfloat16()
            ms[f"K6 M={m}"] = timer(
                lambda: mlp.q4_mlp(h, nw, gu, dn, 1e-6), 15)
            for impl in ("pallas_a8", "pallas_a8x2"):
                if m == 18 and f"q4_mlp_{impl[7:]}" in stems:
                    ms[f"K6 {impl[7:]} M={m}"] = timer(lambda: mlp.q4_mlp(
                        h, nw, gu, dn, 1e-6, impl=impl), 15)
        for m in (18, 24, 32):
            h = torch.randn((1, m, 4096), generator=gen, device=dev).bfloat16()
            if m == 24:
                ms[f"K6 M={m}"] = timer(
                    lambda: mlp.q4_mlp(h, nw, gu, dn, 1e-6), 15)
            if "q4_gemv" in stems:
                ms[f"K6 chain M={m}"] = timer(lambda: h + quant.q4_gemv(
                    mlp.silu_mul(quant.q4_gemv(h[0], gu, nw, 1e-6), 11008),
                    dn), 15)


def time_commit(timer, gen, dev, variant, ms):
    """K8 over 32 layers of Llama-7B caches (Hkv 32, S 2048) in each format:
    B = 1 with a [1] cursor, B = 2 with a [B] cursor (a source from before
    the device cursor takes a shared cursor by value, B = 1 only); and an
    empty launch (the floor) where the source has one."""
    import ctypes

    import chip_smoke as cs
    from exllama_tpu_torch.ops import attention

    old = "const void* past" not in (OUT_DIR / variant / "kv_commit.cu").read_text()
    for kind in ("bf16", *cs.KV_KINDS):
        for b in ((1,) if old else (1, 2)):
            if kind == "bf16":
                lists = [[torch.randn((b, 32, 2048, 128), generator=gen,
                                      device=dev).bfloat16()
                          for _ in range(32)] for _ in range(2)] + [None, None]
            else:
                cs_ = [cs.quantized_cache(gen, kind, b, 32, 2048, 128, dev)
                       for _ in range(32)]
                lists = [[c[i] for c in cs_] for i in range(4)]
            rows = torch.randn((2, 32, b, 1, 32, 128), generator=gen,
                               device=dev).bfloat16()
            ptrs = attention.kv_ptr_array(*[t for t in lists if t is not None])
            mode = ("bf16", *cs.KV_KINDS).index(kind)
            if old:
                fn = kernels.launcher("kv_commit")
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
                    ctypes.c_void_p]
                args = (ptrs.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(),
                        32, b, 32, 2048, 128, 1919, mode,
                        kernels.stream_of(rows))
                ms[f"K8 {kind} B={b}"] = timer(lambda: fn(*args), 20)
            else:
                past = torch.tensor([1919, 1000][:b], dtype=torch.int32,
                                    device=dev)
                ms[f"K8 {kind} B={b}"] = timer(lambda: attention.kv_commit(
                    lists[0], lists[1], rows[0], rows[1], past, lists[2],
                    lists[3], ptrs), 20)
            del lists, rows
    if not old:
        ms["launch floor"] = timer(lambda: attention.launch_floor(dev), 20)


def time_variant(v):
    import importlib

    import chip_smoke as cs

    point_at(v)
    if "kv_launch_floor" not in (OUT_DIR / v / "kv_commit.cu").read_text():
        kernels._SIGNATURES.pop("kv_launch_floor")   # a source from before it
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
    if "kv_commit" in stems:
        time_commit(timer, gen, dev, v, ms)
    time_rows(timer, gen, dev, stems, ms)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"variant": v, "card": card, "ms": ms}), flush=True)


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
                           capture_output=True, text=True, timeout=600)
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
