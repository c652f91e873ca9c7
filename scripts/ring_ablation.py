#!/usr/bin/env python3
"""Where the time of the ring kernel goes (exllama_tpu_torch/csrc/q4_ring.cuh:
K2, K10, K11 and K12), and how its W8 mode (K11) and the lm_head GEMV K4
(csrc/dense_stream.cuh) fare at other ring depths, on one CUDA card.

    python3 scripts/ring_ablation.py [--out FILE] [--only VARIANT ...]

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
                 not split (as it is: one block an SM, stream-K).

K4 is also timed through its C launcher alone ("launcher": the output and
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

from exllama_tpu_torch import kernels  # noqa: E402

RING, DENSE = "q4_ring.cuh", "dense_stream.cuh"
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
    (DENSE, "    tc_unit<MB, ALIGNED>(c, ws, xs, p, (u % KU) * ROWS,",
     "    if (u < 0) tc_unit<MB, ALIGNED>(c, ws, xs, p, (u % KU) * ROWS,")]
_DENSE_NO_FINISH = [(DENSE, "if (u + 1 < u1 && (u + 1) % KU) continue;", "continue;")]


# variant -> (libraries it builds and times, patches (header, old, new),
# names in ops.dense replaced while it is timed)
VARIANTS = {
    "full": (RING_STEMS + ("dense_gemv",), [], {}),
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
        "dense_grid": lambda k, v, sms: (-(-v // 256), 2 * sms)}),
    "dense_no_x": (("dense_gemv",), _DENSE_NO_X, {}),
    "dense_no_products": (("dense_gemv",), _DENSE_NO_PRODUCTS, {}),
    "dense_no_finish": (("dense_gemv",), _DENSE_NO_FINISH, {}),
    "dense_copies": (("dense_gemv",),
                     _DENSE_NO_X + _DENSE_NO_PRODUCTS + _DENSE_NO_FINISH, {}),
    "dense_no_split": (("dense_gemv",), [], {
        "dense_grid": lambda k, v, sms: (-(-v // 256), -(-v // 256))}),
}
SRC, OUT_DIR = kernels.CSRC, kernels.BUILD_DIR / "ablation"
LIBRARIES = dict(kernels.LIBRARIES)


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
        shutil.copytree(SRC, d)
        stems, patches, _ = VARIANTS[v]
        for header, old, new in patches:
            src = (d / header).read_text()
            if old not in src:
                raise SystemExit(f"{v}: '{old}' is not in {header}; update "
                                 f"the ablation patches")
            (d / header).write_text(src.replace(old, new))
        (d / "_b").mkdir()
        point_at(v)
        for stem in stems:
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(d), "-o",
                   str(kernels._target(stem)), str(d / f"{stem}.cu")]
            log = open(d / "_b" / f"{stem}.log", "w")
            procs.append((v, stem, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
    for v, stem, p in procs:
        if p.wait() != 0:
            raise SystemExit(f"nvcc failed for {v} {stem}:\n"
                             + (OUT_DIR / v / "_b" / f"{stem}.log")
                             .read_text()[-3000:])


def time_variant(v):
    import torch

    import chip_smoke as cs
    from exllama_tpu_torch.formats.gptq import w8_col_scale, with_w8
    from exllama_tpu_torch.ops import dense, quant

    point_at(v)
    stems, _, names = VARIANTS[v]
    for name, value in names.items():
        setattr(dense, name, value)
    dev = torch.device("cuda")
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    ms = {}
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
    if "dense_gemv" in stems:
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
    print(json.dumps({"variant": v, "ms": ms}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS),
                    help="build and time these variants (and full) alone")
    ap.add_argument("--time", help=argparse.SUPPRESS)   # one copy, in-process
    args = ap.parse_args()
    if args.time:
        time_variant(args.time)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ring_ablation: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    chosen = [v for v in VARIANTS if v != "full" and (
        not args.only or v in args.only)]
    build(["full", *chosen])
    print(f"# built {len(chosen) + 1} copies in {time.time() - t0:.1f} s",
          flush=True)
    lines = []
    for v in ["full", *chosen, "full"]:
        r = subprocess.run([sys.executable, __file__, "--time", v],
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
