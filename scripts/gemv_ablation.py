#!/usr/bin/env python3
"""Where the time of K1 at 2..32 rows and of K4 goes, on their Hopper
kernels (exllama_tpu_torch/csrc/q4_gemv_wg.cuh, dense_wg.cuh), on one CUDA
card.

    python3 scripts/gemv_ablation.py [--out FILE] [--only VARIANT ...]

Builds copies of the sources with one change each, each into its own
git-ignored directory (exllama_tpu_torch/_build/gemv_ablation/), and times
K1 at 18 and 32 rows on Llama-7B's four projections (g128; qkv with its
norm) and K4 on the 4096 x 32000 lm_head at 1 and 40 rows with each copy,
one process a copy, in turns (the kernels as they are first and last),
beside their parents (K1: the mma.sync route; K4: the stream-K loop) in the
same process:

  full         the kernels as they are;
  copies       the consumers take and release each slab and multiply
               nothing: the ring, x's forming (K1), the combine and the
               epilogue alone;
  copies_w     as copies, and K1's x slabs are not staged either: the
               streams alone (K1's words, scales and raw x, K4's w and x);
  no_form      K1's x slabs are not staged (the products run on TMA's raw
               rows, with whatever sums the slots hold);
  no_combine   a tile cut between blocks is not combined: each block
               writes its piece as if it were the whole tile (K1 at these
               widths is stream-K; K4 at 1 and 40 rows takes whole tiles).

The copies that change the arithmetic are timed only; the others are
first held against the plain versions (K1 1e-2, K4 1e-4). The results print
as one JSON line a copy, with the card's name and power limit.
"""

from __future__ import annotations

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

K1, K4, HOP = "q4_gemv_wg.cuh", "dense_wg.cuh", "hopper.cuh"
# K1's consumers: no fragments, products or folds (the slots still waited
# for and released)
_K1_COPIES = [
    (K1, """        const uint2 w0 = *reinterpret_cast<const uint2*>(W + (2 * ks) * BN + r0 + 64 * j);
        const uint2 w1 = *reinterpret_cast<const uint2*>(W + (2 * ks + 1) * BN + r0 + 64 * j);
        f[j][ks][0] = nib2(w0.x, pick), f[j][ks][1] = nib2(w0.y, pick);
        f[j][ks][2] = nib2(w1.x, pick), f[j][ks][3] = nib2(w1.y, pick);""",
     "        f[j][ks][0] = W[r0 + ks];"),
    (K1, """        Mma<BM>::run(pr[HALVES ? ks >> 1 : 0][j], a[j][ks], desc + 2 * ks, HALVES ? ks & 1 : ks);""",
     """        pr[0][j][0] += float((a[j][ks][0] ^ (uint32_t)desc) & 1);"""),
    (K1, """    if constexpr (HALVES) {
      fold<BM, VEC>(acc, pr[0], S, S + 2 * SROW, U, r0, q, nullptr, sh[0], sh[2]);
      fold<BM, VEC>(acc, pr[1], S + SROW, S + 3 * SROW, U + BM, r0, q, nullptr, sh[1], sh[3]);
    } else {  // both halves' sums
      fold<BM, VEC>(acc, pr[0], S, S + 2 * SROW, U, r0, q, U + BM, sh[0], sh[2]);
    }""", "    acc[0][0] += pr[0][0][0] + U[q] + float(S[r0]) + float(sh[0]);"),
]
_K4_BODY = ("      uint32_t a[NW][4][4];\n",
            "      __syncwarp();\n      if (lane == 0) mbar_arrive(empty + st);")
_K4_TOUCH = ("      acc[0][0] += float(ws[lane * 4] + ws[8192 + lane]);\n"
             "      __syncwarp();\n      if (lane == 0) mbar_arrive(empty + st);")
_FORM = ("          stage_slab<BM>(p, smem + st * C::X_BYTES,\n"
         "                         reinterpret_cast<const bf16*>(smem + C::N_OFF + st * C::N_BYTES), us, lane);\n")


def _cut(src, first, last, new):
    i, j = src.index(first), src.index(last) + len(last)
    return src[:i] + new + src[j:]


# variant -> ([(header, old, new) or (header, function)], checked)
VARIANTS = {
    "full": ([], True),
    "copies": (_K1_COPIES + [(K4, lambda s: _cut(s, *_K4_BODY, _K4_TOUCH))], False),
    "copies_w": (_K1_COPIES + [(K1, _FORM, ""),
                               (K4, lambda s: _cut(s, *_K4_BODY, _K4_TOUCH))], False),
    "no_form": ([(K1, _FORM, "")], False),
    "no_combine": ([(HOP, "  if (kb == 0 && ke == w.KT) return true;",
                     "  if (kb >= 0) return true;")], False),
}
K1_SHAPES = (("qkv", 4096, 12288), ("o", 4096, 4096), ("gateup", 4096, 22016),
             ("down", 11008, 4096))
K1_ROWS = (18, 32)
K4_ROWS = (1, 40)
OUT_DIR = kernels.BUILD_DIR / "gemv_ablation"
SRC = kernels.CSRC
LIBS = ("q4_gemv", "dense_gemv")


def point_at(variant):
    d = OUT_DIR / variant
    kernels.CSRC, kernels.BUILD_DIR = d, d / "_b"
    kernels.LIBRARIES = {lib: kernels.LIBRARIES[lib] for lib in LIBS}


def build(variants):
    for v in variants:   # every copy patched before any compiler starts
        d = OUT_DIR / v
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(SRC, d)
        for header, *patch in VARIANTS[v][0]:
            src = (d / header).read_text()
            try:
                new = (patch[0](src) if len(patch) == 1 else
                       src.replace(patch[0], patch[1]) if patch[0] in src
                       else None)
            except ValueError:
                new = None
            if new is None:
                raise SystemExit(f"{v}: a patch does not apply to {header}; "
                                 f"update the patches")
            (d / header).write_text(new)
        (d / "_b").mkdir()
    procs = []
    for v in variants:
        d = OUT_DIR / v
        point_at(v)
        for lib in LIBS:
            stem, flags = kernels.LIBRARIES[lib]
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", str(d),
                   "-o", str(kernels._target(lib)), str(d / f"{stem}.cu")]
            procs.append((v, lib, subprocess.Popen(
                cmd, stdout=open(d / "_b" / f"{lib}.log", "w"),
                stderr=subprocess.STDOUT)))
    for v, lib, p in procs:
        if p.wait() != 0:
            raise SystemExit(f"nvcc failed for {v} {lib}:\n"
                             + (OUT_DIR / v / "_b" / f"{lib}.log").read_text()[-3000:])
    for v in variants:   # each copy's registers and spills (ptxas -v)
        for lib in LIBS:
            log = (OUT_DIR / v / "_b" / f"{lib}.log").read_text().splitlines()
            for i, line in enumerate(log):
                if "Compiling entry function" in line and "_wg_kernel" in line:
                    name = line.split("'")[1][:48]
                    spill = next((s for s in log[i + 1:i + 4] if "spill" in s), "")
                    print(f"# {v} {name}: {spill.strip()}", flush=True)


def time_variant(v):
    import chip_smoke as cs
    from exllama_tpu_torch.ops import dense, quant

    point_at(v)
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    checked = VARIANTS[v][1]
    ms = {}
    for nm, k, n in K1_SHAPES:
        qt = cs.random_qt(gen, k, n, 128, False, dev)
        nw = ((torch.rand(k, generator=gen, device=dev) + 0.5).bfloat16()
              if nm == "qkv" else None)
        for m in K1_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
            label = f"K1 {nm} M={m}"
            if checked:
                cs.check_close(f"{v} {label}", quant.q4_gemv(x, qt, nw),
                               quant.q4_gemv_plain(x, qt, nw), 1e-2)
            ms[label] = timer(lambda: quant.q4_gemv(x, qt, nw), 10)
            if v == "full":
                ms[f"{label} parent"] = timer(
                    lambda: cs.k1_parent(x, qt, nw, 1e-6), 10)
        del qt
    w = (torch.randn((4096, 32000), generator=gen, device=dev) * 0.02).bfloat16()
    for m in K4_ROWS:
        x = torch.randn((m, 4096), generator=gen, device=dev).bfloat16()
        label = f"K4 lm_head M={m}"
        if checked:
            cs.check_close(f"{v} {label}", dense.dense_gemv(x, w),
                           dense.dense_gemv_plain(x, w), 1e-4)
        ms[label] = timer(lambda: dense.dense_gemv(x, w), 10)
        if v == "full" and m <= dense.GEMV_MAX_M:
            ms[f"{label} parent"] = timer(lambda: cs.k4_parent(x, w), 10)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"variant": v, "card": card, "ms": ms}), flush=True)


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
    if not torch.cuda.is_available():
        print("gemv_ablation: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    chosen = [v for v in VARIANTS if v != "full" and (not args.only or v in args.only)]
    build(["full", *chosen])
    print(f"# built {len(chosen) + 1} copies in {time.time() - t0:.1f} s", flush=True)
    lines = []
    for v in ["full", *chosen, "full"]:
        r = subprocess.run([sys.executable, __file__, "--time", v],
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
