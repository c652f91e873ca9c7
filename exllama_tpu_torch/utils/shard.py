"""Split a .safetensors file into size-capped shards and an HF-style index
(port of exllama_tpu/utils/shard.py).

Deterministic greedy packing in the order of the tensors' names, and
``<base>.safetensors.index.json`` with ``weight_map`` and ``total_size``;
read and written by the port's own safetensors reader and writer, so no
``safetensors`` package is needed:

    python -m exllama_tpu_torch.utils.shard input.safetensors 4   # GB a shard
"""

from __future__ import annotations

import json
import os
import sys

from exllama_tpu_torch.formats.loader import SafetensorsFile, save_safetensors


def shard_file(input_path: str, max_gb: float, output_dir: str | None = None):
    """Write the shards (and the index) next to ``input_path`` or into
    ``output_dir``; returns the shard paths."""
    output_dir = output_dir or os.path.dirname(os.path.abspath(input_path))
    base = os.path.basename(input_path).rsplit(".", 1)[0]
    limit = int(max_gb * 1024**3)

    f = SafetensorsFile(input_path)
    keys = sorted(f.keys())       # by name, as safetensors lists them
    shards: list[list[str]] = [[]]
    sizes = [0]
    for key in keys:
        lo, hi = f.header[key]["data_offsets"]
        nbytes = hi - lo
        if sizes[-1] + nbytes > limit and shards[-1]:
            shards.append([])
            sizes.append(0)
        shards[-1].append(key)
        sizes[-1] += nbytes

    n = len(shards)
    weight_map = {}
    total = 0
    written = []
    for i, shard_keys in enumerate(shards):
        name = f"{base}-{i + 1:05d}-of-{n:05d}.safetensors"
        tensors = {k: f.get(k) for k in shard_keys}
        save_safetensors(tensors, os.path.join(output_dir, name))
        written.append(os.path.join(output_dir, name))
        for k in shard_keys:
            weight_map[k] = name
            total += tensors[k].nbytes
        print(f" -- wrote {name} ({sizes[i] / 1024**3:.2f} GB)")

    index = {
        "metadata": {"total_size": total},
        "weight_map": weight_map,
    }
    index_path = os.path.join(output_dir, f"{base}.safetensors.index.json")
    with open(index_path, "w") as fo:
        json.dump(index, fo, indent=2)
    print(f" -- wrote {index_path}")
    return written


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print("usage: python -m exllama_tpu_torch.utils.shard "
              "<file.safetensors> <GB>")
        sys.exit(1)
    shard_file(sys.argv[1], float(sys.argv[2]))
