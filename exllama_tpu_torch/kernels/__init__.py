"""Build and load the port's CUDA kernels (exllama_tpu_torch/csrc/*.cu).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``; the sources of
the shared GEMV (K1, K6, K7) compile once per arithmetic mode
(``-DGEMV_MODE``: exact, a8, a8x2), one library each, and K7 once more per
mode for the quantized KV caches (``-DKV_QUANT=1``), and K3 once more for
head_dim 256 (``-DFLASH_D256=1``). The libraries go to
``exllama_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
the shared headers and the flags, so an edited source rebuilds and an
unchanged one is reused. All libraries build in parallel, one ``nvcc``
each, at the first kernel call (or an explicit :func:`build`). Nothing here
runs at import time: CPU-only installs import the package freely and never
build.

Every C entry point takes pointers and the stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# library -> (source stem, extra nvcc flags)
LIBRARIES = {
    "q4_gemv": ("q4_gemv", []),
    "q4_matmul": ("q4_matmul", []),
    "flash_attn": ("flash_attn", []),
    # K3 at head_dim 256, a library of its own so that it builds in parallel
    "flash_attn_d256": ("flash_attn", ["-DFLASH_D256=1"]),
    "dense_gemv": ("dense_gemv", []),
    "head_argmax": ("head_argmax", []),
    "q4_mlp": ("q4_mlp", []),
    "layer_tail": ("layer_tail", []),
    "kv_commit": ("kv_commit", []),
    "q4_prefill_a8": ("q4_prefill_a8", []),
    "w8_matmul": ("w8_matmul", []),
}
# the W4A8 builds of the shared GEMVs; see csrc/q4_gemv.cuh
GEMV_MODES = {"a8": 1, "a8x2": 2}
for _stem in ("q4_gemv", "q4_mlp", "layer_tail"):
    for _mode, _n in GEMV_MODES.items():
        LIBRARIES[f"{_stem}_{_mode}"] = (_stem, [f"-DGEMV_MODE={_n}"])

# entry point -> (library, C function, ctypes signature: "p" pointer /
# stream, "i" int, "f" float)
_SIGNATURES = {
    "q4_gemv": ("q4_gemv", "q4_gemv_launch", "p" * 9 + "i" * 5 + "f" + "p"),
    "q4_matmul": ("q4_matmul", "q4_matmul_launch", "ppppp" + "iiii" + "p"),
    "q4_matmul_glu": ("q4_matmul", "q4_matmul_glu_launch",
                      "ppppp" + "i" * 6 + "p"),
    "flash_attn": ("flash_attn", "flash_attn_launch",
                   "p" * 12 + "i" * 12 + "f" + "p"),
    "flash_attn_d256": ("flash_attn_d256", "flash_attn_launch",
                        "p" * 12 + "i" * 12 + "f" + "p"),
    "dense_gemv": ("dense_gemv", "dense_gemv_launch", "ppppp" + "iiii" + "p"),
    "head_argmax": ("head_argmax", "head_argmax_launch",
                    "p" * 7 + "iiii" + "f" + "p"),
    "q4_mlp": ("q4_mlp", "q4_mlp_launch", "p" * 13 + "iiii" + "f" + "p"),
    "layer_tail": ("layer_tail", "layer_tail_launch",
                   "p" * 37 + "i" * 12 + "ff" + "p"),
    "kv_commit": ("kv_commit", "kv_commit_launch", "ppp" + "i" * 7 + "p"),
    "q4_prefill_a8": ("q4_prefill_a8", "q4_prefill_a8_launch",
                      "p" * 8 + "iiii" + "p"),
    "w8_matmul": ("w8_matmul", "w8_matmul_launch", "p" * 6 + "iii" + "p"),
}
for _stem in ("q4_gemv", "q4_mlp", "layer_tail"):
    for _mode in GEMV_MODES:
        _SIGNATURES[f"{_stem}_{_mode}"] = (
            f"{_stem}_{_mode}", *_SIGNATURES[_stem][1:])
# K7 over an int8 / int4 KV cache: the same source once more per GEMV mode,
# so that the bf16 libraries stay the code they were
for _lib in ("layer_tail", "layer_tail_a8", "layer_tail_a8x2"):
    LIBRARIES[f"{_lib}_kvq"] = (
        "layer_tail", LIBRARIES[_lib][1] + ["-DKV_QUANT=1"])
    _SIGNATURES[f"{_lib}_kvq"] = (f"{_lib}_kvq", *_SIGNATURES[_lib][1:])
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(lib: str) -> Path:
    stem, flags = LIBRARIES[lib]
    h = hashlib.sha256()
    h.update((CSRC / f"{stem}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"{lib}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every library that is not up to date, all in parallel, and
    load them all. Returns the seconds spent."""
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for lib, (stem, flags) in LIBRARIES.items():
        out = _target(lib)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{lib}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs.append((lib, out, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for lib, out, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc != 0:
            failed.append(lib)
        else:
            os.replace(tmp, out)
    if failed:
        logs = "\n".join(
            (BUILD_DIR / f"{s}.log").read_text()[-4000:] for s in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    for lib in LIBRARIES:
        _load(lib)
    return time.time() - t0


def _load(lib: str) -> ctypes.CDLL:
    cdll = ctypes.CDLL(str(_target(lib)))
    for owner, fn_name, sig in _SIGNATURES.values():
        if owner == lib:
            fn = getattr(cdll, fn_name)
            fn.argtypes = [_CTYPES[c] for c in sig]
            fn.restype = ctypes.c_int
    _libs[lib] = cdll
    return cdll


def launcher(name: str):
    """The C launch function of entry point ``name`` (a key of
    ``_SIGNATURES``), building on first use."""
    lib, fn_name, _ = _SIGNATURES[name]
    if lib not in _libs:
        if not _target(lib).exists():
            build()
        else:
            _load(lib)
    return getattr(_libs[lib], fn_name)


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


_SMS: dict = {}


def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev`` (cached)."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
