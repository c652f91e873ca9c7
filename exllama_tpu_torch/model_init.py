"""Shared CLI argument vocabulary -> ExLlamaConfig factory (port of
exllama_tpu/model_init.py, same flag names).

One argparse vocabulary, mapped onto a config by :func:`make_config` and
onto a loaded model by :func:`build`: every flag of the JAX package's
``add_args``, and ``--scale_f32`` (which the JAX package's benchmark adds).
The port runs on one card: ``--tp`` / ``--dp`` above 1 raise
``NotImplementedError``; ``--cpu`` selects ``torch.device("cpu")``, where
every kernel wrapper runs its plain PyTorch version; ``--matmul_impl xla``
runs the plain path on the card, an oracle for the kernels.

    --kv_int8          int8 KV cache, one f32 scale per (token, kv head)
    --kv_int4          int4 KV cache, two values a byte
    --pad_head_dim     pad an odd head_dim to a width kernel K3 takes
    --turbo            W4A8 decode matmuls + int8 KV cache
    --turbo_prefill    with --turbo: int8 tensor-core prefill too
    --a8x2             two-pass W4A8 decode matmuls, bf16 KV
    --fuse_layer       the whole decode layer in one K7 launch
    --scale_f32        f32 scales and zero-scales (the f32-scale builds)
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from exllama_tpu_torch.config import ExLlamaConfig


def add_args(parser: argparse.ArgumentParser):
    parser.add_argument("-d", "--directory", type=str,
                        help="Path to model directory (config.json + tokenizer + .safetensors)")
    parser.add_argument("-c", "--config", type=str, help="Path to config.json")
    parser.add_argument("-m", "--model", type=str,
                        help="Path to model.safetensors (file or shard dir)")
    parser.add_argument("-t", "--tokenizer", type=str,
                        help="Path to tokenizer.model / tokenizer.json")

    parser.add_argument("-l", "--length", type=int, default=2048,
                        help="Maximum sequence length")
    parser.add_argument("-cpe", "--compress_pos_emb", type=float, default=1.0,
                        help="Linear RoPE position compression")
    parser.add_argument("-a", "--alpha", type=float, default=1.0,
                        help="NTK-alpha RoPE scaling")
    parser.add_argument("-theta", "--theta", type=float,
                        help="Override rope_theta directly")

    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel degree (the port runs 1)")
    parser.add_argument("--dp", type=int, default=1,
                        help="Data/batch-parallel degree (the port runs 1)")
    parser.add_argument("--kv_int8", action="store_true",
                        help="int8 KV cache (halves the KV stream; "
                             "per-token-per-head scales)")
    parser.add_argument("--pad_head_dim", action="store_true",
                        help="pad odd head dims (e.g. 100) to a width the "
                             "flash attention kernel takes in the KV cache "
                             "(exact; costs the pad fraction in KV memory)")
    parser.add_argument("--kv_int4", action="store_true",
                        help="int4 KV cache (quarter the KV stream, two "
                             "values per byte; coarser than int8)")
    parser.add_argument("--turbo", action="store_true",
                        help="W4A8 decode matmuls + int8 KV cache "
                             "(small activation-quant noise)")
    parser.add_argument("--a8x2", action="store_true",
                        help="two-pass W4A8 decode matmuls, bf16 KV: "
                             "exact-grade activation quantization")
    parser.add_argument("--turbo_prefill", action="store_true",
                        help="with --turbo: W4A8 prefill too (int8 tensor "
                             "cores; noisier -- prefill quant error "
                             "compounds through the KV cache). Keeps a "
                             "resident int8 weight image in device memory "
                             "when it fits tuning.prefill_w8_budget_gb, "
                             "else re-quantizes in the kernel")
    parser.add_argument("--no_fuse", action="store_true",
                        help="disable load-time qkv/gateup projection fusion")
    parser.add_argument("--fuse_layer", action="store_true",
                        help="whole-layer decode kernel (one K7 launch per "
                             "layer: norm + qkv + rope + attention + o + "
                             "MLP; tuning.fuse_qkv)")
    parser.add_argument("--matmul_impl", type=str, default="auto",
                        choices=["auto", "pallas", "xla"],
                        help="q4 matmul implementation ('xla': the plain "
                             "path, an oracle for the kernels)")
    parser.add_argument("--attn_bucket", type=int, default=256,
                        help="Decode attention length bucket (0 = full cache)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (plain PyTorch versions)")
    parser.add_argument("--max_input_len", type=int, default=2048,
                        help="Chunked-prefill max rows per chunk")
    parser.add_argument("--scale_f32", action="store_true",
                        help="store quantization scales in f32 (each 4-bit "
                             "kernel runs its f32-scale build)")


def device_of(args) -> torch.device:
    """The card, unless ``--cpu`` asks for the CPU."""
    return torch.device("cpu" if getattr(args, "cpu", False) else "cuda")


def get_model_files(args):
    """Resolve -d into explicit paths."""
    if args.directory is not None:
        args.config = os.path.join(args.directory, "config.json")
        st = glob.glob(os.path.join(args.directory, "*.safetensors"))
        if not st:
            raise FileNotFoundError(
                f"no .safetensors in {args.directory}"
            )
        args.model = args.directory if len(st) > 1 else st[0]
        for cand in ("tokenizer.model", "tokenizer.json"):
            p = os.path.join(args.directory, cand)
            if os.path.exists(p):
                args.tokenizer = p
                break
    missing = [k for k in ("config", "model")
               if getattr(args, k) is None]
    if missing:
        raise ValueError(f"missing arguments: {missing} (or use -d)")
    # tokenizer-less directories (fabricated rehearsal checkpoints) fall
    # back to the byte-level FakeTokenizer
    if args.tokenizer is None and args.directory is None:
        raise ValueError("missing arguments: ['tokenizer'] (or use -d)")


def make_config(args) -> ExLlamaConfig:
    if args.tp > 1 or args.dp > 1:
        raise NotImplementedError(
            f"--tp {args.tp} --dp {args.dp}: the port runs on one device "
            f"(parallelism is ROADMAP.md queue 1 item 8)")
    config = ExLlamaConfig(args.config)
    config.model_path = args.model
    config.max_seq_len = args.length
    config.max_input_len = min(args.max_input_len, args.length)
    config.max_attention_size = args.length ** 2
    config.compress_pos_emb = args.compress_pos_emb
    if args.theta:
        config.rotary_embedding_base = args.theta
    if args.alpha != 1.0:
        config.alpha_value = args.alpha
        config.calculate_rotary_embedding_base()
    config.tuning.matmul_impl = args.matmul_impl   # "xla": the plain path
    config.tuning.attn_len_bucket = args.attn_bucket
    if getattr(args, "kv_int8", False) or getattr(args, "turbo", False):
        config.tuning.kv_cache_dtype = "int8"
    if getattr(args, "kv_int4", False):
        config.tuning.kv_cache_dtype = "int4"
    if getattr(args, "pad_head_dim", False):
        config.tuning.pad_head_dim = True
    if getattr(args, "turbo", False) and args.matmul_impl == "auto":
        config.tuning.matmul_impl = (
            "pallas_a8t" if getattr(args, "turbo_prefill", False)
            else "pallas_a8"
        )
    elif getattr(args, "a8x2", False) and args.matmul_impl == "auto":
        config.tuning.matmul_impl = "pallas_a8x2"
    elif getattr(args, "turbo_prefill", False):
        print(" !! --turbo_prefill ignored: requires --turbo with "
              "--matmul_impl auto (got "
              f"turbo={getattr(args, 'turbo', False)}, "
              f"matmul_impl={args.matmul_impl})")
    if getattr(args, "no_fuse", False):
        config.tuning.fuse_projections = False
    if getattr(args, "fuse_layer", False):
        config.tuning.fuse_qkv = True
    if getattr(args, "scale_f32", False):
        config.tuning.scale_dtype = "f32"
    # a flag of the port's benchmark (exllama_tpu_torch.benchmark)
    if getattr(args, "no_fold_act_order", False):
        config.tuning.fold_act_order = False
    return config


def print_options(args, extra: dict | None = None):
    print(f" -- Model config: {args.config}")
    print(f" -- Model: {args.model}")
    print(f" -- Sequence length: {args.length}")
    if args.compress_pos_emb != 1.0:
        print(f" -- RoPE compression: {args.compress_pos_emb}")
    if args.alpha != 1.0:
        print(f" -- NTK alpha: {args.alpha}")
    print(f" -- Device: {device_of(args)}, "
          f"matmul={args.matmul_impl}, attn_bucket={args.attn_bucket}")
    if extra:
        for k, v in extra.items():
            print(f" -- {k}: {v}")


def build(args):
    """Config + model + tokenizer from parsed args, and None where the JAX
    package returns its device mesh."""
    from exllama_tpu_torch.models.llama import ExLlama
    from exllama_tpu_torch.tokenizer import ExLlamaTokenizer, FakeTokenizer

    get_model_files(args)
    config = make_config(args)
    model = ExLlama(config, device=device_of(args))
    if args.tokenizer is None:
        print(" !! no tokenizer file found; using byte-level FakeTokenizer")
        tokenizer = FakeTokenizer()
    else:
        tokenizer = ExLlamaTokenizer(args.tokenizer)
    print(f" -- Groupsize (inferred): {config.groupsize}")
    print(f" -- Act-order (inferred): {config.act_order}")
    return config, model, tokenizer, None
