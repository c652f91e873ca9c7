"""Shared example bootstrap: a checkpoint through ``-d``, or
``--synthetic`` (the benchmark's shapes, seed 0).

Over a mesh (``--tp`` / ``--dp`` under ``torchrun``) every rank runs the
example on its shard, SPMD, and only rank 0 prints. The examples that bind
a port or read stdin go through ``parallel.relay``: rank 0 serves or reads,
and the other ranks follow (:func:`read_line`; the servers' own
``follow``).
"""

from __future__ import annotations

import argparse
import os
import sys

from exllama_tpu_torch import benchmark
from exllama_tpu_torch.cache import ExLlamaCache
from exllama_tpu_torch.parallel.relay import is_follower


def build_from_args(description, batch_size=1, extra_args=None, argv=None):
    """(args, config, model, tokenizer, cache of ``batch_size`` rows)."""
    parser = argparse.ArgumentParser(description=description)
    benchmark.add_model_args(parser)
    parser.add_argument("--max_new", type=int, default=None,
                        help="override each example's generation length")
    if extra_args:
        extra_args(parser)
    args = parser.parse_args(argv)
    if is_follower(args):
        sys.stdout = open(os.devnull, "w")
    model, tokenizer = benchmark.load(args)
    cache = ExLlamaCache(model, batch_size=batch_size)
    return args, model.config, model, tokenizer, cache


def read_line(prompt: str, relay=None):
    """A line of stdin (stripped; None at its end) read on rank 0 and, over
    a mesh (``relay``), sent to the other ranks, which receive it here
    instead of reading."""
    if relay is not None and not relay.leader:
        return relay.recv()
    try:
        line = input(prompt).strip()
    except (EOFError, KeyboardInterrupt):
        print()
        line = None
    if relay is not None:
        relay.send(line)
    return line
