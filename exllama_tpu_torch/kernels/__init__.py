"""Build and load the port's CUDA kernels (exllama_tpu_torch/csrc/*.cu).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The libraries go
to ``exllama_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the shared headers, so an edited source rebuilds and an unchanged
one is reused. All sources build in parallel, one ``nvcc`` each, at the
first kernel call (or an explicit :func:`build`). Nothing here runs at
import time: CPU-only installs import the package freely and never build.

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

# ctypes signatures: "p" pointer / stream, "i" int, "f" float
_SIGNATURES = {
    "q4_gemv": ("q4_gemv_launch", "ppppppp" + "iiii" + "f" + "p"),
    "q4_matmul": ("q4_matmul_launch", "ppppp" + "iiii" + "p"),
    "flash_attn": ("flash_attn_launch", "pppppppp" + "iiiiiiii" + "f" + "p"),
    "dense_gemv": ("dense_gemv_launch", "ppp" + "iii" + "p"),
}
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


def _target(stem: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{stem}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every kernel source that has no up-to-date library, all in
    parallel, and load them all. Returns the seconds spent."""
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for stem in _SIGNATURES:
        out = _target(stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{stem}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs.append((stem, out, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for stem, out, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc != 0:
            failed.append(stem)
        else:
            os.replace(tmp, out)
    if failed:
        logs = "\n".join(
            (BUILD_DIR / f"{s}.log").read_text()[-4000:] for s in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    for stem in _SIGNATURES:
        _load(stem)
    return time.time() - t0


def _load(stem: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(stem)))
    fn_name, sig = _SIGNATURES[stem]
    fn = getattr(lib, fn_name)
    fn.argtypes = [_CTYPES[c] for c in sig]
    fn.restype = ctypes.c_int
    _libs[stem] = lib
    return lib


def launcher(stem: str):
    """The C launch function of kernel ``stem``, building on first use."""
    if stem not in _libs:
        if not _target(stem).exists():
            build()
        else:
            _load(stem)
    return getattr(_libs[stem], _SIGNATURES[stem][0])


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
