#!/usr/bin/env python3
"""One-pass a8 K7 (layer_tail) against its plain version on the inputs of
tests/test_torch_kernels.py::test_layer_tail_rows_modes_caches_bits, built
from this tree's sources or from another checkout's, on one CUDA card:

    python3 scripts/k7_a8_parent_check.py [--csrc DIR]

Prints max |kernel - plain| / max |plain| for a few (B, mode, cache)
cells, so that a K7 change can be told from a8's own noise through a
quantized attention row (the same numbers from both builds)."""

import argparse
import importlib.util
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from exllama_tpu_torch import kernels  # noqa: E402
from exllama_tpu_torch.ops import quant  # noqa: E402

CELLS = ((8, "pallas_a8", "int8"), (2, "pallas_a8", "int8"),
         (8, "pallas_a8", "bf16"), (8, "pallas_a8x2", "int8"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", help="build the kernels from this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_a8_parent_check: no CUDA device", file=sys.stderr)
        return 1
    if args.csrc:
        d = kernels.BUILD_DIR / "a8_check"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(args.csrc, d)
        kernels.CSRC, kernels.BUILD_DIR = d, d / "_b"
    dev = torch.device("cuda")
    # room for either build's split scratch
    quant.gemv_scratch(dev, 4 * kernels.sm_count(dev) * 32 * 128, 4096)
    spec = importlib.util.spec_from_file_location(
        "card_tests", ROOT / "tests" / "test_torch_kernels.py")
    tk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tk)
    for b, impl, kind in CELLS:
        rec = {}

        def close(got, ref, rel, rec=rec):
            rec["rel"] = ((got.float() - ref.float()).abs().max()
                          / ref.float().abs().max()).item()

        tk._close = close
        gen = torch.Generator(device="cuda").manual_seed(0)
        tk.test_layer_tail_rows_modes_caches_bits(gen, b, impl, kind)
        print(f"{args.csrc or 'this tree'} B={b} {impl} {kind}: "
              f"rel {rec['rel']:.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
