#!/usr/bin/env python3
"""The port's perplexity (`python -m exllama_tpu_torch.benchmark --synthetic
7b -ppl`: 8 chunks of the bundled wikitext sample, each one forward of
its full logits) for two checkouts in turns, A B B A, on one CUDA card: the
wall time of the measured pass beside the perplexity, each run a process of
its own in its checkout.

    python3 scripts/ppl_turns.py PARENT_DIR [CHANGE_DIR] [--out FILE]

CHANGE_DIR defaults to this checkout. Both checkouts' kernels are built
first, at once; each run then loads the 32-layer Llama-7B-shape synthetic
model, runs the perplexity once to warm (libraries, allocator, tensor
maps) and times a second pass between two device synchronizations. One
JSON line a run: {"tree", "card" (nvidia-smi's name and power limit),
"ppl", "seconds"}.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_here():
    """One run in the current directory's checkout; prints its JSON line."""
    sys.path.insert(0, os.getcwd())
    import contextlib
    import io

    import torch

    from exllama_tpu_torch import benchmark

    args = benchmark.parse_args(["--synthetic", "7b", "-ppl"])
    with contextlib.redirect_stdout(io.StringIO()):
        model, tokenizer = benchmark.load(args)
    cache = benchmark.ExLlamaCache(model)
    with contextlib.redirect_stdout(io.StringIO()):
        benchmark.run_ppl(model, cache, tokenizer, args)     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ppl = benchmark.run_ppl(model, cache, tokenizer, args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"tree": os.getcwd(), "card": card, "ppl": ppl,
                      "seconds": seconds}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=str(ROOT))
    ap.add_argument("--out")
    ap.add_argument("--here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.here:
        run_here()
        return 0
    trees = [str(Path(args.parent).resolve()), str(Path(args.change).resolve())]
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from exllama_tpu_torch import kernels; kernels.build()"],
        cwd=t) for t in trees]
    if any(b.wait() != 0 for b in builds):
        print("ppl_turns: a build failed", file=sys.stderr)
        return 1
    lines = []
    for t in (trees[0], trees[1], trees[1], trees[0]):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "x", "--here"],
                           cwd=t, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-2000:] + r.stderr[-4000:], file=sys.stderr)
            return 1
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
