#!/usr/bin/env python3
"""Where the time of the ring kernel goes (exllama_tpu_torch/csrc/q4_ring.cuh:
K2, K10 and K12), on one CUDA card.

    python3 scripts/ring_ablation.py [--out FILE]

Builds copies of the kernel sources with parts of the work cut out, each
into its own git-ignored directory (exllama_tpu_torch/_build/ablation/),
and times K2, K10 and K12 at Llama-7B shapes (M = 1919; K12 also at 33
rows) with each copy, one process a copy, in turns (the whole kernel first
and last):

  full           the kernel as it is;
  no_conversion  the producers copy but convert no weight slab and form no
                 Glu activation: copies and products;
  no_products    the consumers multiply nothing: copies and conversion;
  copies         neither: the copies and the hand-overs alone;
  no_glu_form    K12 without its activation forming (the rest as is).

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

HEADER = "q4_ring.cuh"
STEMS = ("q4_matmul", "q4_prefill_a8")
_NO_CONVERSION = [
    ("      cv.slab(", "      if (0) cv.slab("),
    ("if constexpr (MODE == Mode::Glu) form_glu<T>(", "if constexpr (false) form_glu<T>("),
]
_NO_PRODUCTS = [
    ("for (int kk = 0; kk < BK / 32; ++kk)", "for (int kk = 0; kk < 0; ++kk)"),
    ("for (int kk = 0; kk < BK / 16; ++kk)", "for (int kk = 0; kk < 0; ++kk)"),
]
VARIANTS = {
    "full": [],
    "no_conversion": _NO_CONVERSION,
    "no_products": _NO_PRODUCTS,
    "copies": _NO_CONVERSION + _NO_PRODUCTS,
    "no_glu_form": _NO_CONVERSION[1:],
}
SRC, OUT_DIR = kernels.CSRC, kernels.BUILD_DIR / "ablation"


def point_at(variant):
    """Make the package build and load this copy's libraries."""
    d = OUT_DIR / variant
    kernels.CSRC, kernels.BUILD_DIR = d, d / "_b"
    kernels.LIBRARIES = {k: kernels.LIBRARIES[k] for k in STEMS}


def build(variants):
    procs = []
    for v in variants:
        d = OUT_DIR / v
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(SRC, d)
        src = (d / HEADER).read_text()
        for old, new in VARIANTS[v]:
            if old not in src:
                raise SystemExit(f"{v}: '{old}' is not in {HEADER}; update "
                                 f"the ablation patches")
            src = src.replace(old, new)
        (d / HEADER).write_text(src)
        (d / "_b").mkdir()
        point_at(v)
        for stem in STEMS:
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
    from exllama_tpu_torch.formats.gptq import w8_col_scale
    from exllama_tpu_torch.ops import quant

    point_at(v)
    dev = torch.device("cuda")
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    ms = {}
    for nm, k, n in (("o", 4096, 4096), ("gateup", 4096, 22016),
                     ("down", 11008, 4096)):
        qt = cs.random_qt(gen, k, n, 128, False, dev)
        ws = w8_col_scale(qt)
        x = torch.randn((1919, k), generator=gen, device=dev).bfloat16()
        ms[f"K2 {nm} M=1919"] = timer(lambda: quant.q4_dequant_matmul(x, qt), 10)
        ms[f"K10 {nm} M=1919"] = timer(lambda: quant.q4_prefill_a8(x, qt, ws), 10)
    down = cs.random_qt(gen, 11008, 4096, 128, False, dev)
    for m in (33, 1919):
        x = torch.randn((m, 22016), generator=gen, device=dev).bfloat16()
        ms[f"K12 down M={m}"] = timer(
            lambda: quant.q4_matmul_glu(x, down, 11008, 11008), 10)
    print(json.dumps({"variant": v, "ms": ms}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
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
    build(list(VARIANTS))
    print(f"# built {len(VARIANTS)} copies in {time.time() - t0:.1f} s",
          flush=True)
    lines = []
    for v in ["full", *[v for v in VARIANTS if v != "full"], "full"]:
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
