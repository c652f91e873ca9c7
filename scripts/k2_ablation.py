#!/usr/bin/env python3
"""Where the time of K2 goes (exllama_tpu_torch/csrc/q4_wgmma.cuh, the
4-bit prefill matmul on TMA and wgmma), on one CUDA card.

    python3 scripts/k2_ablation.py [--out FILE] [--only VARIANT ...]

Builds copies of the sources with one change each, each into its own
git-ignored directory (exllama_tpu_torch/_build/k2_ablation/), and times K2
at 40, 127 and 1919 rows on Llama-7B's four projections (g128) with each
copy, one process a copy, in turns (the kernel as it is first and last),
beside K2's parent (the ring's Exact mode) in the same process:

  full         the kernel as it is;
  f32_dequant  each weight dequantized in f32 (multiply, subtract, cast),
               the f32-scale builds' arithmetic, instead of one bf16x2 fma
               for two weights (the same values: PERF.md says why);
  pingpong     the two consumer warpgroups take turns issuing their
               products (named barriers; as it is: they issue freely);
  depth2       two groups of products in flight (as it is: one);
  copies       the consumers dequantize and multiply nothing: TMA, the
               mbarrier ring and the epilogue alone;
  copies_w     as copies, and only the packed words are loaded (no x, no
               scale rows);
  tiles        the other tiles instantiated too; times K2 at 40 rows with
               64 x 128 tiles (as it is: 64 x 256) and at 127 and 1919 rows
               with 128 x 256 and 128 x 128 (as it is: 128 x 128 at 127 and
               256 x 128 at 1919).

Every copy's output at each case is first held against the plain version
(1e-2); the results print as one JSON line a copy, with the card's name
and power limit.
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

WG = "q4_wgmma.cuh"
_BODY = ("#pragma unroll\n    for (int j = 0; j < C::NW; ++j) {\n"
         "      const int r = r0 + 64 * j;",
         "    if (held > C::DEPTH) release();  // the oldest slab's products are done")
_SCALES = ("          tma_2d(ss, &smap, n0, g0, full + st);",
           "          tma_2d(ss + 3 * BN * SC_BYTES, &zmap, n0, g1, full + st);")


def _cut(src, first, last, new):
    i, j = src.index(first), src.index(last) + len(last)
    return src[:i] + new + src[j:]


def _copies(src):
    """The consumers take and release each slab and multiply nothing."""
    return _cut(src, *_BODY, "    acc[0][0] += sc2f(S[r0]) + float(W[r0] & 1);\n"
                "    if (++st == C::STAGES) st = 0, phase ^= 1;\n    ++held;\n    release();")


def _copies_w(src):
    src = _copies(src).replace(
        "          tma_2d(xs, &xmap, k0, m0, full + st);\n          tma_2d(ws",
        "          tma_2d(ws")
    return _cut(src, *_SCALES, "").replace(
        "static constexpr uint32_t TX = STAGE;",
        "static constexpr uint32_t TX = W_BYTES;")


_END = ("            p.out[(size_t)gm * p.N + gn + e] = Cs[r * C::C_LD + c + e];\n"
        "        }\n      }\n    }\n  }\n}")
PINGPONG = [
    (WG, "__device__ __forceinline__ void bar_sync(int id, int n) {",
     "__device__ __forceinline__ void bar_arrive(int id, int n) {\n"
     "  asm volatile(\"bar.arrive %0, %1;\\n\" ::\"r\"(id), \"r\"(n) : \"memory\");\n}\n"
     "__device__ __forceinline__ void bar_sync(int id, int n) {"),
    (WG, "  int lane;\n", "  int lane, wgi;\n"),
    (WG, "pick_of(q),\n                        lane};",
     "pick_of(q),\n                        lane, wgi};\n"
     "    if (wgi == 1) bar_arrive(2, CONSUMERS);  // warpgroup 0 takes the first turn"),
    (WG, "    ++held;\n    wgmma_fence();",
     "    ++held;\n    bar_sync(2 + wgi, CONSUMERS);\n    wgmma_fence();"),
    (WG, "    wgmma_commit();\n    wgmma_wait<C::DEPTH>();",
     "    wgmma_commit();\n    bar_arrive(2 + (wgi ^ 1), CONSUMERS);\n"
     "    wgmma_wait<C::DEPTH>();"),
    (WG, _END, _END[:-5] + "    if (wgi == 0) bar_sync(2, CONSUMERS);\n  }\n}"),
]
OTHER_TILES = ("  if (bm == 128 && bn == 128) return launch<128, 128, VEC>(maps, p, grid, st);",
               "  if (bm == 128 && bn == 128) return launch<128, 128, VEC>(maps, p, grid, st);\n"
               "  if (bm == 64 && bn == 128) return launch<64, 128, VEC>(maps, p, grid, st);\n"
               "  if (bm == 128 && bn == 256) return launch<128, 256, VEC>(maps, p, grid, st);")

# variant -> [(header, old, new) or (header, function)]; checked: False
# where the copy computes no product
VARIANTS = {
    "full": ([], True),
    "f32_dequant": ([(WG, "#if SCALE_F32\n// f32 scales", "#if 1\n// f32 scales")], True),
    "pingpong": (PINGPONG, True),
    "depth2": ([(WG, "DEPTH = 1;", "DEPTH = 2;")], True),
    "copies": ([(WG, _copies)], False),
    "copies_w": ([(WG, _copies_w)], False),
    "tiles": ([(WG, *OTHER_TILES)], True),
}
SHAPES = (("qkv", 4096, 12288), ("o", 4096, 4096), ("gateup", 4096, 22016),
          ("down", 11008, 4096))
ROWS = (40, 127, 1919)
TILES = {40: ((64, 128),), 127: ((128, 256),), 1919: ((128, 256), (128, 128))}
OUT_DIR = kernels.BUILD_DIR / "k2_ablation"
SRC = kernels.CSRC
LIB = "q4_matmul"


def point_at(variant):
    d = OUT_DIR / variant
    kernels.CSRC, kernels.BUILD_DIR = d, d / "_b"
    kernels.LIBRARIES = {LIB: kernels.LIBRARIES[LIB]}


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
        stem, flags = kernels.LIBRARIES[LIB]
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", str(d), "-o",
               str(kernels._target(LIB)), str(d / f"{stem}.cu")]
        procs.append((v, subprocess.Popen(cmd, stdout=open(d / "_b" / "log", "w"),
                                          stderr=subprocess.STDOUT)))
    for v, p in procs:
        if p.wait() != 0:
            raise SystemExit(f"nvcc failed for {v}:\n"
                             + (OUT_DIR / v / "_b" / "log").read_text()[-3000:])


def plan_with(m, n, k, tile):
    """q4_matmul_plan's choice between data-parallel and stream-K, at the
    given tile."""
    from exllama_tpu_torch.ops import quant

    sms = kernels.sm_count(torch.device("cuda", 0))
    bm, bn = tile
    tiles = -(-m // bm) * -(-n // bn)
    waves = -(-tiles // sms)
    if tiles >= quant.Q4MM_FILL * waves * sms:
        return quant.Q4MatmulPlan(m, n, k, bm, bn, min(sms, tiles), False)
    return quant.Q4MatmulPlan(m, n, k, bm, bn, min(sms, tiles * -(-k // 64)),
                              True)


def run(x, qt, plan):
    from exllama_tpu_torch.ops import quant

    m, k = x.shape
    n = qt.out_features
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    part, ticket = quant.q4_matmul_scratch(x.device, plan)
    kernels.check(kernels.launcher(LIB)(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), out.data_ptr(), part.data_ptr(),
        ticket.data_ptr(), m, k, n, qt.groupsize, plan.bm, plan.bn, plan.grid,
        int(plan.stream_k), kernels.stream_of(x)), LIB)
    return out


def time_variant(v):
    import chip_smoke as cs
    from exllama_tpu_torch.ops import quant

    point_at(v)
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    checked = VARIANTS[v][1]
    ms = {}
    for nm, k, n in SHAPES:
        qt = cs.random_qt(gen, k, n, 128, False, dev)
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
            tiles = [None] + (list(TILES[m]) if v == "tiles" else [])
            for tile in tiles:
                plan = (quant.q4_matmul_plan(m, n, k, kernels.sm_count(dev))
                        if tile is None else plan_with(m, n, k, tile))
                label = f"{nm} M={m}" + (f" {tile[0]}x{tile[1]}" if tile else "")
                if checked:
                    cs.check_close(f"{v} {label}", run(x, qt, plan),
                                   quant._q4_matmul_plain(x, qt), 1e-2)
                ms[label] = timer(lambda: run(x, qt, plan), 10)
            if v == "full":
                ms[f"{nm} M={m} parent"] = timer(lambda: cs.ring_parent(x, qt), 10)
        del qt
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
        print("k2_ablation: no CUDA device", file=sys.stderr)
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
