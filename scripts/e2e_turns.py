#!/usr/bin/env python3
"""Phases 5-7 of chip_smoke.py -- the default configuration's three
requests, bench.py's greedy decode on its two paths (commit_impl "auto";
fuse_qkv + the K8 commit) and request 1 with the fusions off -- for two
checkouts in turns, A B B A, on one CUDA card, so that a change to host
code is read against its parent in one call rather than across calls.

    python3 scripts/e2e_turns.py PARENT_DIR [CHANGE_DIR] [--out FILE]

CHANGE_DIR defaults to this checkout. Both checkouts' kernels are built
first, at once (each with its own exllama_tpu_torch.kernels.build(), into
its own git-ignored build directory); then each run is a process of its
own in its checkout, driving that checkout's chip_smoke.py functions
(MainPath, main_path, greedy) on a fresh 32-layer Llama-7B-shape model.
One JSON line a run: {"tree", "card" (nvidia-smi's name and power limit),
and the host-clock numbers chip_smoke prints: "request2_prefill_ms",
"request3_decode_step_ms", "default_prompt_tps", "default_decode_tps",
"greedy_auto_tps", "greedy_k8_tps", "separate_decode_tps"}.
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
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    mp = cs.MainPath(dev)
    r5 = cs.main_path(mp)
    auto = cs.greedy(mp, "commit_impl=auto", commit_impl="auto")
    k8 = cs.greedy(mp, "fuse_qkv, commit_impl=pallas", qkv_fuse=True,
                   commit_impl="pallas")
    mp.set_tuning(fuse_mlp=False, fuse_attn=False, commit_impl="xla")
    sep = mp.request1("separate")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "tree": os.getcwd(), "card": card,
        "request2_prefill_ms": r5["request2_prefill_ms"],
        "request3_decode_step_ms": r5["request3_decode_step_ms"],
        "default_prompt_tps": r5["prompt_tps"],
        "default_decode_tps": r5["decode_tps"],
        "greedy_auto_tps": auto["decode_tps"],
        "greedy_k8_tps": k8["decode_tps"],
        "separate_decode_tps": sep["decode_tps"]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=str(ROOT))
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_here()
        return 0
    trees = [str(Path(args.parent).resolve()), str(Path(args.change).resolve())]
    t0 = time.time()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from exllama_tpu_torch import kernels; kernels.build()"], cwd=t)
        for t in trees]
    if any(p.wait() != 0 for p in builds):
        print("e2e_turns: a checkout's kernels did not build", file=sys.stderr)
        return 1
    print(f"# built both checkouts in {time.time() - t0:.1f} s", flush=True)
    lines = []
    for t in (trees[0], trees[1], trees[1], trees[0]):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--run", t], cwd=t, capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-3000:] + r.stderr[-3000:], file=sys.stderr)
            return 1
        lines.append(r.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
