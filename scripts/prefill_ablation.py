#!/usr/bin/env python3
"""K3's prefill kernel on Hopper (exllama_tpu_torch/csrc/flash_prefill_wg.cuh)
against copies with one design choice undone, on one CUDA card.

    python3 scripts/prefill_ablation.py [--out FILE] [--only VARIANT ...]

Builds copies of the sources with one change each, each into its own
git-ignored directory (exllama_tpu_torch/_build/prefill_ablation/), and
runs the Llama-7B-width prefill cases with each copy, one process a copy:
T = 1919 from past 0 at head_dim 64 (64 heads) and 128 (32 heads, bf16 and
int8 caches), and two 64-row chunks behind cursors 1000 / 1100 at head_dim
128; each case's largest error against attend_plain over its scale and its
time, with the parent (FlashAttention-2 tiles on mma.sync) timed in the
same process:

  full          the kernel as it is;
  q_shared      Q as a shared-memory operand of S = QK^T at head_dim 128
                too, not the register operand (its 32 fragment registers a
                thread);
  tile_is_head  the key tile as wide as the head: 64 keys at head_dim 64,
                128 at 128, the pairing that summed wrongly from the second
                tile on;
  no_softmax    (timed only) S goes to PV as it is: no scale, mask,
                exponentials or rescale of O;
  no_s          (timed only) no S = QK^T products (the softmax runs on
                whatever S holds);
  no_pv         (timed only) no O += PV products;
  loads_only    (timed only) none of the three: the ring, Q's staging and
                the epilogue alone;
  convert2      two converting warps over an int8 / int4 cache, not three
                (352 threads: 184 registers a thread, not 168);
  stages6       a ring of up to six stages, not five.

The results print as one JSON line a copy, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from exllama_tpu_torch import kernels  # noqa: E402

HDR = "flash_prefill_wg.cuh"
VARIANTS = {
    "full": [],
    "q_shared": [("  constexpr bool QREG = D <= 128;",
                  "  constexpr bool QREG = D < 128;")],
}
# the key tile as wide as the head, and the assertion that forbids it lifted
TILE_IS_HEAD = [("static constexpr int BN = D > 64 ? 64 : 128;",
                 "static constexpr int BN = D > 128 ? 64 : D;"),
                ("  static_assert(BN != D,", "  static_assert(true,")]
_NO_SOFTMAX = ("    if (s0 + BN > full_end)\n      mrow0 ? softmax(T{}, T{}) : softmax(T{}, F{});\n"
               "    else\n      mrow0 ? softmax(F{}, T{}) : softmax(F{}, F{});",
               "    alpha[0] = alpha[1] = 1.f;")
_NO_S = ("        Mma64SS::run(sc, kmajor_sw128(qs + (kd >> 2) * BR * 128 + 64 * wg * 128) + 2 * (kd & 3),\n"
         "                     kdesc, kd > 0);",
         "        sc[kd] += (float)(kdesc & 1);")
_NO_PV = ("      Mma<D>::template run<1>(o, pa[kk], mnmajor_sw128(vt + kk * 2048, C::BOX));",
          "      o[kk] += __uint_as_float(pa[kk][0] & 1);")
VARIANTS.update({"tile_is_head": TILE_IS_HEAD,
                 "no_softmax": [_NO_SOFTMAX], "no_s": [_NO_S], "no_pv": [_NO_PV],
                 "loads_only": [_NO_SOFTMAX, _NO_S, _NO_PV],
                 "convert2": [("static constexpr int PW = KV ? 4 : 1;",
                               "static constexpr int PW = KV ? 3 : 1;")],
                 "stages6": [("(FIT2 < 5 ? FIT2 : 5)", "(FIT2 < 6 ? FIT2 : 6)")]})
TIMED_ONLY = ("no_softmax", "no_s", "no_pv", "loads_only")
# label, head_dim, heads, kind, B, T, past, attend_len
CASES = (("D=64 bf16 T=1919", 64, 64, "bf16", 1, 1919, 0, 2048),
         ("D=128 bf16 T=1919", 128, 32, "bf16", 1, 1919, 0, 2048),
         ("D=128 int8 T=1919", 128, 32, "int8", 1, 1919, 0, 2048),
         ("D=128 bf16 B=2 T=64 past=[1000,1100]", 128, 32, "bf16", 2, 64,
          [1000, 1100], 1280))
OUT_DIR = kernels.BUILD_DIR / "prefill_ablation"
SRC = kernels.CSRC
LIBS = ("flash_attn",)


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
        src = (d / HDR).read_text()
        for old, new in VARIANTS[v]:
            if old not in src:
                raise SystemExit(f"{v}: a patch does not apply to {HDR}; "
                                 f"update the patches")
            src = src.replace(old, new)
        (d / HDR).write_text(src)
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


def time_variant(v):
    import chip_smoke as cs
    from exllama_tpu_torch.ops import attention

    point_at(v)
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    out = {}
    for label, d, h, kind, b, t, past, alen in CASES:
        if v in TIMED_ONLY and label != "D=128 bf16 T=1919":
            continue
        q = torch.randn((b, t, h, d), generator=gen, device=dev).bfloat16()
        ks = vs = None
        if kind == "bf16":
            kc, vc = (torch.randn((b, h, 2048, d), generator=gen,
                                  device=dev).bfloat16() for _ in range(2))
        else:
            kc, vc, ks, vs = cs.quantized_cache(gen, kind, b, h, 2048, d, dev)
        pt = (past if isinstance(past, int)
              else torch.tensor(past, dtype=torch.int32, device=dev))
        args = (q, kc, vc, pt, alen, None, None, ks, vs)
        out[label] = {"ms": timer(lambda: attention.attend(*args), 10)}
        if v not in TIMED_ONLY:
            got = attention.attend(*args).float()
            ref = attention.attend_plain(*args).float()
            out[label]["rel_err"] = ((got - ref).abs().max()
                                     / ref.abs().max()).item()
            del got, ref
        if v == "full":
            out[label]["parent_ms"] = timer(lambda: cs.k3_prefill_parent(
                q, kc, vc, pt, alen, None, ks, vs), 10)
        del q, kc, vc, ks, vs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"variant": v, "card": card, "cases": out}), flush=True)


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
        print("prefill_ablation: no CUDA device", file=sys.stderr)
        return 2
    variants = ["full"] + [v for v in (args.only or VARIANTS) if v != "full"]
    build(variants)
    lines = []
    for v in variants:   # one process a copy: their symbols would collide
        r = subprocess.run([sys.executable, __file__, "--time", v],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise SystemExit(f"{v} failed:\n{r.stderr[-3000:]}")
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
