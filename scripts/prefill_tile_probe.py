#!/usr/bin/env python3
"""Where a key tile as wide as the head goes wrong in K3's prefill kernel
(exllama_tpu_torch/csrc/flash_prefill_wg.cuh; its Cfg forbids BN == D), on
one CUDA card.

    python3 scripts/prefill_tile_probe.py [--out FILE] [--only COPY ...]

Builds copies of the flash_attn library as scripts/prefill_ablation.py
builds its copies (one nvcc each, in parallel, under the git-ignored
exllama_tpu_torch/_build/prefill_ablation/), and runs each in a process of
its own:

  shipped     the kernel as it is (64 keys a tile at head_dim 128);
  head        128 keys a tile at head_dim 128;
  dump        shipped, writing its first block's S, P and O fragments;
  dump_head   head, writing them;
  head_pv64   head with O += PV as two products of 64 columns each
              (wgmma m64n64 on each 64-column box of V), so that S and PV
              no longer share one wgmma shape;
  head_s64    head with S = QK^T as two products of 64 keys each.

Every copy's output at head_dim 128, bf16, T = 256 (two heads) and
T = 1919 (32 heads) from past 0 is held against attend_plain (the largest
error over the output's scale). The dump copies also write, for block 0
(query rows 128..191 of the first kv head at T = 256), its first consumer
warpgroup's S after the first two key tiles' QK^T, P after their softmax
(with alpha) and O after their PV; each is held against the plain product
of the kernel's own inputs: S against Q K^T, P against the online softmax
of the dumped S, O after tile j against alpha * (dumped O of tile j - 1)
+ bf16(dumped P) V; a wrong S of the second tile is also held against
what it could be instead: the registers' last values (the first tile's P,
the largest difference), Q V^T of its own tile, Q K^T of the first tile,
each of its own k-steps of 16 dims alone and summed up to it, and the
first tile's P (bf16) in Q's place times its own K^T. One JSON line a
copy, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import prefill_ablation as abl  # noqa: E402
from exllama_tpu_torch import kernels  # noqa: E402

# block 0's first warpgroup: S, P of tiles 0 and 1, O of tiles 0 and 1,
# alpha; 128 threads x 64 floats each
_DUMP = [
    ("constexpr float NEG_INF = -1e9f;                               // attention.py:36",
     "constexpr float NEG_INF = -1e9f;                               // attention.py:36\n"
     "__device__ float probe_buf[7 * 128 * 64];"),
    ("    fence_regs(sc);\n\n    // scale, mask and the online softmax;",
     "    fence_regs(sc);\n"
     "    if (blockIdx.x == 0 && wg == 0 && j < 2) {\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < BN / 2; ++i) probe_buf[(j * 128 + ct) * 64 + i] = sc[i];\n"
     "    }\n\n    // scale, mask and the online softmax;"),
    ("    // O += P V: P rounded to bf16 in A's register layout, V MN-major",
     "    if (blockIdx.x == 0 && wg == 0 && j < 2) {\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < BN / 2; ++i) probe_buf[((2 + j) * 128 + ct) * 64 + i] = sc[i];\n"
     "      probe_buf[(6 * 128 + ct) * 64 + 2 * j] = alpha[0];\n"
     "      probe_buf[(6 * 128 + ct) * 64 + 2 * j + 1] = alpha[1];\n"
     "    }\n"
     "    // O += P V: P rounded to bf16 in A's register layout, V MN-major"),
    ("    fence_regs(o);\n    __syncwarp();",
     "    fence_regs(o);\n"
     "    if (blockIdx.x == 0 && wg == 0 && j < 2) {\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < D / 2; ++i) probe_buf[((4 + j) * 128 + ct) * 64 + i] = o[i];\n"
     "    }\n    __syncwarp();"),
    ("}  // namespace fwg",
     "}  // namespace fwg\n\n"
     "extern \"C\" int fwg_probe_read(void* dst) {\n"
     "  return cudaMemcpyFromSymbol(dst, fwg::probe_buf, sizeof(fwg::probe_buf));\n"
     "}"),
]
_PV64 = ("      Mma<D>::template run<1>(o, pa[kk], mnmajor_sw128(vt + kk * 2048, C::BOX));",
         "      if constexpr (D == 128) {\n"
         "        Mma<64>::template run<1>(*reinterpret_cast<float(*)[32]>(o), pa[kk],\n"
         "                                 mnmajor_sw128(vt + kk * 2048, C::BOX));\n"
         "        Mma<64>::template run<1>(*reinterpret_cast<float(*)[32]>(o + 32), pa[kk],\n"
         "                                 mnmajor_sw128(vt + C::BOX + kk * 2048, C::BOX));\n"
         "      } else {\n"
         "        Mma<D>::template run<1>(o, pa[kk], mnmajor_sw128(vt + kk * 2048, C::BOX));\n"
         "      }")
_S64 = ("        Mma<BN>::run(sc, qf[kd], kdesc, kd > 0);",
        "      {\n"
        "        if constexpr (BN == 128) {\n"
        "          Mma<64>::run(*reinterpret_cast<float(*)[32]>(sc), qf[kd], kdesc, kd > 0);\n"
        "          Mma<64>::run(*reinterpret_cast<float(*)[32]>(sc + 32), qf[kd],\n"
        "                       kdesc + (8192 >> 4), kd > 0);\n"
        "        } else {\n"
        "          Mma<BN>::run(sc, qf[kd], kdesc, kd > 0);\n"
        "        }\n"
        "      }")
PROBES = {
    "shipped": [],
    "head": abl.TILE_IS_HEAD,
    "dump": _DUMP,
    "dump_head": abl.TILE_IS_HEAD + _DUMP,
    "head_pv64": abl.TILE_IS_HEAD + [_PV64],
    "head_s64": abl.TILE_IS_HEAD + [_S64],
}
D = 128


def rel(got, ref):
    return ((got.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def fragments(buf, slot, width):
    """Slot ``slot`` of the dump as a [64 rows, width] matrix: thread t's
    element 4i + 2h + e is row 16 (t / 32) + (t % 32) / 4 + 8h, column
    8i + 2 (t % 4) + e (wgmma's accumulator layout)."""
    t = torch.arange(128)[:, None]
    idx = torch.arange(width // 2)[None, :]
    i, h, e = idx // 4, (idx // 2) % 2, idx % 2
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * h
    col = 8 * i + 2 * (t % 4) + e
    out = torch.full((64, width), float("nan"), dtype=torch.float64)
    out[row, col] = buf[slot, :, :width // 2].double()
    return out


def check_dump(lib, q, kc, vc, bn):
    """S, P and O of block 0's first warpgroup after key tiles 0 and 1
    against the plain arithmetic of the kernel's own inputs."""
    raw = torch.empty(7 * 128 * 64, dtype=torch.float32)
    kernels.check(lib.fwg_probe_read(ctypes.c_void_p(raw.data_ptr())),
                  "fwg_probe_read")
    buf = raw.view(7, 128, 64)
    rows = torch.arange(128, 192)                # block 0, warpgroup 0
    qq = q[0, 128:192, 0].double().cpu()
    k, v = kc[0, 0].double().cpu(), vc[0, 0].double().cpu()
    alpha = torch.empty(64, 2, dtype=torch.float64)
    t = torch.arange(128)
    for h in range(2):
        alpha[16 * (t // 32) + (t % 32) // 4 + 8 * h] = \
            buf[6, :, h::2][:, :2].double()
    mask_value = -0.7 * 3.4028234663852886e38
    m = torch.full((64,), mask_value, dtype=torch.float64)
    o_prev = torch.zeros((64, D), dtype=torch.float64)
    out = {}
    for j in range(2):
        s0 = j * bn
        s_got = fragments(buf, j, bn)
        s_ref = qq @ k[s0:s0 + bn].T
        sc = s_got / math.sqrt(D)
        vis = torch.arange(s0, s0 + bn)[None, :] < (rows + 1)[:, None]
        sc = torch.where(vis, sc, mask_value)
        m_new = torch.maximum(m, sc.amax(1))
        p_ref = torch.where(vis, torch.exp(sc - m_new[:, None]), 0.0)
        a_ref = torch.exp(m - m_new)
        m = m_new
        p_got = fragments(buf, 2 + j, bn)
        o_got = fragments(buf, 4 + j, D)
        pb = p_got.float().bfloat16().double()
        o_ref = alpha[:, j:j + 1] * o_prev + pb @ v[s0:s0 + bn]
        out[f"tile{j}"] = {"S": rel(s_got, s_ref), "P": rel(p_got, p_ref),
                           "alpha": (alpha[:, j] - a_ref).abs().max().item(),
                           "O": rel(o_got, o_ref),
                           "S_max_over_ref": (s_got.abs().max()
                                              / s_ref.abs().max()).item()}
        if j:   # what a wrong S could be: the registers' last values (the
            # previous tile's P), or a product with the wrong tile
            out["tile1"]["S_vs_P0"] = (s_got - p_prev).abs().max().item()
            out["tile1"]["S_vs_QV1"] = rel(s_got, qq @ v[s0:s0 + bn].T)
            out["tile1"]["S_vs_QK0"] = rel(s_got, qq @ k[:bn].T)
            # the first tile's P (bf16, as PV's A operand) in place of Q
            out["tile1"]["S_vs_P0K1"] = rel(
                s_got, p_prev.float().bfloat16().double() @ k[s0:s0 + bn].T)
            # ... or some of its own k-steps of 16 dims: each alone, and
            # each prefix
            kt = k[s0:s0 + bn]
            steps = [qq[:, 16 * i:16 * i + 16] @ kt[:, 16 * i:16 * i + 16].T
                     for i in range(D // 16)]
            out["tile1"]["S_vs_one_kstep"] = [rel(s_got, x) for x in steps]
            out["tile1"]["S_vs_kstep_prefix"] = [
                rel(s_got, sum(steps[:i + 1])) for i in range(D // 16)]
        o_prev, p_prev = o_got, p_got
    return out


def run_probe(v):
    from exllama_tpu_torch.ops import attention

    abl.point_at(v)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for t, h in ((256, 2), (1919, 32)):
        q = torch.randn((1, t, h, D), generator=gen, device=dev).bfloat16()
        kc = torch.randn((1, h, 2048, D), generator=gen, device=dev).bfloat16()
        vc = torch.randn((1, h, 2048, D), generator=gen, device=dev).bfloat16()
        args = (q, kc, vc, 0, t)
        got = attention.attend(*args)
        torch.cuda.synchronize()
        case = {"rel_err": rel(got, attention.attend_plain(*args))}
        if v.startswith("dump") and t == 256:
            lib = kernels._libs["flash_attn"]
            lib.fwg_probe_read.argtypes = [ctypes.c_void_p]
            case.update(check_dump(lib, q, kc, vc, 128 if v == "dump_head" else 64))
        res[f"T={t}"] = case
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"variant": v, "card": card, "cases": res}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--only", nargs="+", choices=list(PROBES),
                    help="build and run these copies alone")
    ap.add_argument("--run", help=argparse.SUPPRESS)   # one copy, in-process
    args = ap.parse_args()
    if args.run:
        run_probe(args.run)
        return 0
    if not torch.cuda.is_available():
        print("prefill_tile_probe: no CUDA device", file=sys.stderr)
        return 2
    variants = args.only or list(PROBES)
    abl.VARIANTS.update(PROBES)
    abl.build(variants)
    lines = []
    for v in variants:     # one process a copy: their symbols would collide
        r = subprocess.run([sys.executable, __file__, "--run", v],
                           capture_output=True, text=True, timeout=600)
        line = (r.stdout.strip().splitlines() or [""])[-1]
        if r.returncode != 0:
            line = json.dumps({"variant": v, "failed": r.stderr[-1500:]})
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
