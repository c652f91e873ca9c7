#!/usr/bin/env python3
"""Build, check and time the Hopper K6 / K7 (exllama_tpu_torch/csrc/
fused_wg.cuh) on one CUDA card, the quick way before a whole chip_smoke.py.

    python3 scripts/fused_wg_check.py [--watchdog] [--tests EXPR] [--no-time]
                                      [--k1] [--out FILE]

Builds the exact-mode libraries (and, with --watchdog, with -DWG_WATCHDOG=1:
an mbarrier or grid-barrier wait that never ends traps instead of hanging
the card), prints ptxas's registers and spills of every fused_wg_kernel
instantiation from the build logs, runs the card tests that ``--tests``
selects (pytest -k; default: K6, K7 and their parents, the graph replay
after gen_begin) in this process, then chip_smoke.py's phase-3 K5-K7 cases
(fused_cases: each kernel against its plain version, timed beside its
parent, the separate chain and its bound) unless --no-time, and with --k1
phase 3's K1 cases too (k1_cases: K1 shares its slab loop with K6 / K7). The card's name
and power limit print first; with --out the phase-3 records are also
written to FILE as JSON.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from exllama_tpu_torch import kernels  # noqa: E402

TESTS = ("q4_mlp or layer_tail or attn_block_o or k6_or_k7 or "
         "after_gen_begin")


def ptxas_lines(lib: str):
    """ptxas's resource lines of the fused_wg kernels in ``lib``'s log."""
    log = (kernels.BUILD_DIR / f"{lib}.log").read_text().splitlines()
    out, name = [], None
    for line in log:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif name and "fused_wg_kernel" in name and (
                "registers" in line or "spill" in line):
            out.append(f"{lib}: {name[:60]}... {line.strip()}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--watchdog", action="store_true")
    ap.add_argument("--tests", default=TESTS)
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--k1", action="store_true")
    ap.add_argument("--out", help="also write the phase-3 records here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    if a.watchdog:
        kernels.NVCC_FLAGS.append("-DWG_WATCHDOG=1")
    libs = [lib for lib in kernels.LIBRARIES if not lib.endswith("_f32")]
    libs += ["q4_mlp_f32", "layer_tail_f32", "layer_tail_kvq_f32"]
    t0 = time.time()
    kernels.build(libs)
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s",
          flush=True)
    for lib in ("q4_mlp", "layer_tail", "layer_tail_kvq", "layer_tail_f32"):
        for line in ptxas_lines(lib):
            print(line, flush=True)
    import pytest

    rc = pytest.main([str(ROOT / "tests/test_torch_kernels.py"), "-m", "cuda",
                      "--noconftest", "-o", "addopts=", "-q", "-x",
                      "-p", "no:cacheprovider", "-k", a.tests])
    print(f"card tests rc {rc}", flush=True)
    if rc != 0 or a.no_time:
        return int(rc)
    import chip_smoke

    dev = torch.device("cuda", 0)
    res: dict = {}
    chip_smoke.fused_cases(dev, chip_smoke.Timer(dev), res)
    if a.k1:
        chip_smoke.k1_cases(dev, chip_smoke.Timer(dev), res)
    if a.out:
        Path(a.out).write_text(json.dumps({"card": smi, "cases": res}, default=str,
                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
