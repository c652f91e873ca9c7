#!/usr/bin/env python3
"""Where the time of the Hopper K6 and K7 goes (exllama_tpu_torch/csrc/
fused_wg.cuh, layer_tail.cu), on one CUDA card.

    python3 scripts/fused_wg_ablation.py [--out FILE] [--only VARIANT ...]
                                         [--against DIR]

Builds copies of the sources with one change each, each into its own
git-ignored directory (exllama_tpu_torch/_build/fused_wg_ablation/), and
times K6 at 1, 8 and 32 rows (Llama-7B's MLP, g128) and K7 at B = 1, past
2000 (layer_tail over bf16, int8 and int4 caches, layer_step) and at B = 8
with GQA 8 (layer_tail over the three caches) with each copy, one process a
copy, in turns (the kernels as they are first and last). With --against,
the sources of another checkout (DIR/exllama_tpu_torch/csrc, the same
wrappers' C interface; for example the parent commit unpacked by ``git
archive``) are built and timed as the copy ``against``, checked, between
the others:

  full          the kernels as they are (held against the plain versions);
  copies        each slab is staged and released with no A fragments,
                products or fold: the streams, the staging, the combine,
                the epilogue, the barriers and attention;
  no_products   the fragments and the fold, no wgmma;
  no_stage      x is not staged (no norm, no silu(gate) * up, no sums);
  no_combine    a tile cut between blocks is not combined: each block
                writes its piece as if it were the whole tile;
  no_attention  K7's attention phase does nothing (its two barriers stay,
                its ring is not filled);
  barriers      every GEMV phase has no units: the launch, the norm's row
                sums, the grid barriers and (K7) attention alone;
  bare          barriers without attention: the launch, the row sums and
                the grid barriers alone;
  stages6       a GEMV ring of at most 6 slots (K6's and K7's; K7's
                attention ring takes what that leaves);
  attn_stream   K7's attention streams its chunks through the ring and
                runs its softmax on zero scores, no products (the stream,
                the item's prologue and merge);
  attn_math     K7's attention ring is filled with no loads (each slot's
                barrier completes at the producer's arrival): the products
                on stale shared memory, the prologue and the merge.

Only ``full`` and ``against`` are checked; the others change the
arithmetic and are timed only. The results print as one JSON line a copy, with the card's name and
power limit.
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

FWG, TAIL, HOP, K1 = "fused_wg.cuh", "layer_tail.cu", "hopper.cuh", "q4_gemv_wg.cuh"
_PRODUCTS = """    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        Mma<BM>::run(pr[HALVES ? ks >> 1 : 0][j], a[j][ks], desc + 2 * ks, HALVES ? ks & 1 : ks);
    wgmma_commit();
    wgmma_wait<0>();
"""
_NO_PRODUCTS = "    pr[0][0][0] += float((a[0][0][0] ^ (uint32_t)desc) & 1);\n"
_FRAGS = """        a[j][ks][0] = nib2(w0.x, pick), a[j][ks][1] = nib2(w0.y, pick);
        a[j][ks][2] = nib2(w1.x, pick), a[j][ks][3] = nib2(w1.y, pick);"""
_FOLD = """    if constexpr (HALVES) {
      fold<BM, VEC>(acc, pr[0], S, S + 2 * SROW, U, r0, q, nullptr, sh[0], sh[2]);
      fold<BM, VEC>(acc, pr[1], S + SROW, S + 3 * SROW, U + BM, r0, q, nullptr, sh[1], sh[3]);
    } else {  // both halves' sums
      fold<BM, VEC>(acc, pr[0], S, S + 2 * SROW, U, r0, q, U + BM, sh[0], sh[2]);
    }"""
# the slab loop is K1's (q4_gemv_wg.cuh), which the copies' K1 builds are not
# timed with
_COPIES = [(K1, _PRODUCTS, _NO_PRODUCTS),
           (K1, _FRAGS, "        a[j][ks][0] = W[r0 + ks];"),
           (K1, _FOLD, "    acc[0][0] += pr[0][0][0] + U[q] + float(S[r0]);")]
_NO_UNITS = (FWG, "  g.grid = units < grid ? (int)units : grid;", "  g.grid = 0;")
_NO_ATTN = [(TAIL, f"    wg::{f}<{kv}>({a}p, ar, ring);", "    (void)p;")
            for f, a in (("consume", ""), ("produce", "kmap, ")) for kv in (0, 1, 2)]

# variant -> ([(file, old, new)], checked)
VARIANTS = {
    "full": ([], True),
    "copies": (_COPIES, False),
    "no_products": ([(K1, _PRODUCTS, _NO_PRODUCTS)], False),
    "no_stage": ([(FWG, "  if (t >= 8 * BM) return;", "  if (t >= 0) return;")], False),
    "no_combine": ([(HOP, "  if (kb == 0 && ke == w.KT) return true;",
                     "  if (kb >= 0) return true;")], False),
    "no_attention": (_NO_ATTN, False),
    "barriers": ([_NO_UNITS], False),
    "bare": ([_NO_UNITS] + _NO_ATTN, False),
    "stages6": ([(FWG, "  static constexpr int CAP = ATT_MIN > 0 ? 8 : 12;",
                  "  static constexpr int CAP = 6;")], False),
    "attn_stream": ([(TAIL, "      scores<KV>(kt, qs, kl, half, G, sc);", "      (void)kt;"),
                     (TAIL, "        v_dims<KV>(kt + R::K_BYTES, kk, lane, v01, v23);",
                      "        continue;")], False),
    "attn_math": ([(TAIL, "      mbar_arrive_tx(full + st, tx);",
                    "      mbar_arrive(full + st);\n      continue;")], False),
    "against": ([], True),   # --against DIR's sources
}
OUT_DIR = kernels.BUILD_DIR / "fused_wg_ablation"
SRC = kernels.CSRC
LIBS = ("q4_mlp", "layer_tail", "layer_tail_kvq")


def point_at(variant):
    d = OUT_DIR / variant
    kernels.CSRC, kernels.BUILD_DIR = d, d / "_b"
    kernels.LIBRARIES = {lib: kernels.LIBRARIES[lib] for lib in LIBS}


def build(variants, against=None):
    for v in variants:   # every copy patched before any compiler starts
        d = OUT_DIR / v
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(SRC if v != "against" else Path(against) / "exllama_tpu_torch" / "csrc", d)
        for name, old, new in VARIANTS[v][0]:
            src = (d / name).read_text()
            if old not in src:
                raise SystemExit(f"{v}: a patch does not apply to {name}; "
                                 f"update the patches")
            (d / name).write_text(src.replace(old, new))
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
    for v in variants:   # each copy's spills and serialized products
        for lib in LIBS:
            log = (OUT_DIR / v / "_b" / f"{lib}.log").read_text().splitlines()
            for i, line in enumerate(log):
                if "Compiling entry function" in line and "fused_wg" in line:
                    spill = next((s for s in log[i + 1:i + 4] if "spill" in s), "")
                    print(f"# {v} {lib}: {spill.strip()}", flush=True)
            warn = sorted({line.split("(")[0].strip() for line in log if "C75" in line})
            if warn:
                print(f"# {v} {lib}: {warn}", flush=True)


def time_variant(v):
    import chip_smoke as cs
    from exllama_tpu_torch.ops import attn_block, mlp
    from exllama_tpu_torch.ops.rope import rope_tables, slice_tables

    point_at(v)
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    hidden, inter, heads, d, s_max, gs, eps = 4096, 11008, 32, 128, 2048, 128, 1e-6
    checked = VARIANTS[v][1]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    gateup = cs.random_qt(gen, hidden, 2 * inter, gs, False, dev)
    down = cs.random_qt(gen, inter, hidden, gs, False, dev)
    o = cs.random_qt(gen, heads * d, hidden, gs, False, dev)
    nw = (torch.rand(hidden, generator=gen, device=dev) + 0.5).bfloat16()
    ms = {}
    for m in (1, 8, 32):
        h = rnd(m, 1, hidden)
        if checked:
            cs.check_close(f"{v} K6 M={m}", mlp.q4_mlp(h, nw, gateup, down, eps),
                           mlp.q4_mlp_plain(h, nw, gateup, down, eps), 2e-2)
        ms[f"K6 M={m}"] = timer(lambda: mlp.q4_mlp(h, nw, gateup, down, eps), 10)
    sin, cos = rope_tables(s_max, d, device=dev)
    for label, b, hkv, step, kind in (
            ("layer_tail B=1", 1, 32, False, "bf16"),
            ("layer_tail B=1 int8", 1, 32, False, "int8"),
            ("layer_tail B=1 int4", 1, 32, False, "int4"),
            ("layer_step B=1", 1, 32, True, "bf16"),
            ("layer_tail B=8 gqa8", 8, 8, False, "bf16"),
            ("layer_tail B=8 gqa8 int8", 8, 8, False, "int8"),
            ("layer_tail B=8 gqa8 int4", 8, 8, False, "int4")):
        qkv = cs.random_qt(gen, hidden, (heads + 2 * hkv) * d, gs, False, dev)
        h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
        scales = {}
        if kind == "bf16":
            kc, vc = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d)
        else:
            kc, vc, ks, vs = cs.quantized_cache(gen, kind, b, hkv, s_max, d, dev)
            scales = dict(k_scale=ks, v_scale=vs)
        new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
        if step:
            sin_t, cos_t = slice_tables(sin, cos, 2000, 1)
            args = (h, qkv, nw, sin_t, cos_t, kc, vc, 2000, s_max, o, nw,
                    gateup, down, eps, heads, hkv, d)
            fn, plain = attn_block.layer_step, attn_block.layer_step_plain
        else:
            args = (h, q, kc, vc, 2000, s_max, o, nw, gateup, down, eps, new_kv)
            fn, plain = attn_block.layer_tail, attn_block.layer_tail_plain
        if checked:
            got, ref = fn(*args, **scales), plain(*args, **scales)
            if step:
                got, ref = got[0], ref[0]
            cs.check_close(f"{v} K7 {label}", got, ref, 2e-2)
        ms[f"K7 {label}"] = timer(lambda: fn(*args, **scales), 10)
        del kc, vc, qkv, scales
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"variant": v, "card": card, "ms": ms}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS),
                    help="build and time these variants (and full) alone")
    ap.add_argument("--against", help="a checkout whose sources are timed "
                    "as the copy 'against'")
    ap.add_argument("--time", help=argparse.SUPPRESS)   # one copy, in-process
    args = ap.parse_args()
    if args.time:
        time_variant(args.time)
        return 0
    if not torch.cuda.is_available():
        print("fused_wg_ablation: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    chosen = [v for v in VARIANTS if v != "full" and (not args.only or v in args.only)
              and (v != "against" or args.against)]
    build(["full", *chosen], args.against)
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
