"""Shared example bootstrap: a checkpoint through ``-d``, or
``--synthetic`` (the benchmark's shapes, seed 0)."""

from __future__ import annotations

import argparse

from exllama_tpu_torch import benchmark
from exllama_tpu_torch.cache import ExLlamaCache


def build_from_args(description, batch_size=1, extra_args=None, argv=None):
    """(args, config, model, tokenizer, cache of ``batch_size`` rows)."""
    parser = argparse.ArgumentParser(description=description)
    benchmark.add_model_args(parser)
    parser.add_argument("--max_new", type=int, default=None,
                        help="override each example's generation length")
    if extra_args:
        extra_args(parser)
    args = parser.parse_args(argv)
    model, tokenizer = benchmark.load(args)
    cache = ExLlamaCache(model, batch_size=batch_size)
    return args, model.config, model, tokenizer, cache
