"""Build and load the port's CUDA kernels (exllama_tpu_torch/csrc/*.cu).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``; the sources of
the shared GEMV (K1, K6, K7) compile once per arithmetic mode
(``-DGEMV_MODE``: exact, a8, a8x2), one library each, and K7 once more per
mode for the quantized KV caches (``-DKV_QUANT=1``), and K3 once more for
head_dim 256 (``-DFLASH_D256=1``); every library that reads the 4-bit
weights' scales (K1 / K9, K2 / K12, K6, K7, K10) once more for f32 scales
(``-DSCALE_F32=1``, ``TuningParams.scale_dtype="f32"``; suffix ``_f32``).
The libraries go to
``exllama_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
the shared headers and the flags, so an edited source rebuilds and an
unchanged one is reused. The libraries of one scale type build in
parallel, one ``nvcc`` each, at the first call of one of them (an explicit
:func:`build` builds them all at once). Nothing here
runs at import time: CPU-only installs import the package freely and never
build.

Every C entry point takes pointers and the stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
It launches on the stream it is given, ``torch.cuda.current_stream()``, so
under CUDA graph capture (``generator.DecodeLoop``) it launches into the
graph. Each wrapper in ``exllama_tpu_torch.ops`` counts its launches on
integer attributes of its own (``launches``, ``launches_int8``, ...);
:func:`launch_counts` reads them all and :func:`add_launches` adds to them,
which is how a graph's replay, which runs no Python, counts the launches
it captured.
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
    # K1 at 2..32 rows on Hopper (the exact builds only)
    "q4_gemv_wg": ("q4_gemv", "q4_gemv_wg_launch", "p" * 9 + "i" * 7 + "f" + "p"),
    # its parent, the mma.sync route (chip_smoke.py's yardstick only), and
    # the count of its launches
    "q4_gemv_tc": ("q4_gemv", "q4_gemv_tc_launch", "p" * 9 + "i" * 5 + "f" + "p"),
    "q4_gemv_tc_launches": ("q4_gemv", "q4_gemv_tc_launches", ""),
    "q4_matmul": ("q4_matmul", "q4_matmul_launch",
                  "p" * 7 + "i" * 8 + "p"),
    # K2's parent, the ring's Exact mode (chip_smoke.py's yardstick only),
    # and the count of its launches
    "q4_matmul_ring": ("q4_matmul", "q4_matmul_ring_launch",
                       "ppppp" + "iiii" + "p"),
    "q4_matmul_ring_launches": ("q4_matmul", "q4_matmul_ring_launches", ""),
    "q4_matmul_glu": ("q4_matmul", "q4_matmul_glu_launch",
                      "ppppp" + "i" * 6 + "p"),
    "flash_attn": ("flash_attn", "flash_attn_launch",
                   "p" * 12 + "i" * 12 + "f" + "p"),
    "flash_attn_d256": ("flash_attn_d256", "flash_attn_launch",
                        "p" * 12 + "i" * 12 + "f" + "p"),
    "dense_gemv": ("dense_gemv", "dense_gemv_launch", "ppppp" + "i" * 7 + "p"),
    # K4's parent, the stream-K loop K5 runs (chip_smoke.py's yardstick
    # only), and the count of its launches
    "dense_gemv_stream": ("dense_gemv", "dense_gemv_stream_launch",
                          "ppppp" + "iiii" + "p"),
    "dense_gemv_stream_launches": ("dense_gemv", "dense_gemv_stream_launches",
                                   ""),
    "head_argmax": ("head_argmax", "head_argmax_launch",
                    "p" * 7 + "iiii" + "f" + "p"),
    "q4_mlp": ("q4_mlp", "q4_mlp_launch", "p" * 13 + "iiii" + "f" + "p"),
    "layer_tail": ("layer_tail", "layer_tail_launch",
                   "p" * 37 + "i" * 12 + "ff" + "p"),
    "kv_commit": ("kv_commit", "kv_commit_launch", "pppp" + "i" * 7 + "p"),
    "kv_launch_floor": ("kv_commit", "kv_launch_floor", "p"),
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
# every library that reads the weights' scales, once more for f32 scales
SCALED = [lib for lib, (stem, _) in LIBRARIES.items() if stem in (
    "q4_gemv", "q4_matmul", "q4_mlp", "layer_tail", "q4_prefill_a8")]
for _lib in SCALED:
    LIBRARIES[f"{_lib}_f32"] = (LIBRARIES[_lib][0],
                                LIBRARIES[_lib][1] + ["-DSCALE_F32=1"])
for _name, (_lib, _fn, _sig) in list(_SIGNATURES.items()):
    if _lib in SCALED:
        _SIGNATURES[f"{_name}_f32"] = (f"{_lib}_f32", _fn, _sig)
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


def scaled(name: str, scales: torch.Tensor) -> str:
    """Entry point ``name``, or its f32-scale build for f32 ``scales``."""
    return f"{name}_f32" if scales.dtype == torch.float32 else name


def build(libs=None) -> float:
    """Compile every library of ``libs`` (default: all) that is not up to
    date, all in parallel, and load them. Returns the seconds spent."""
    t0 = time.time()
    libs = list(LIBRARIES) if libs is None else list(libs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for lib in libs:
        stem, flags = LIBRARIES[lib]
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
    for lib in libs:
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
            f32 = lib.endswith("_f32")     # the libraries of its scale type
            build(l for l in LIBRARIES if l.endswith("_f32") == f32)
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


# -------------------------------------------------------- launch counters

_OPS = ("attention", "attn_block", "dense", "mlp", "quant")


def launch_counters() -> list:
    """Every launch counter of the kernel wrappers: (wrapper, attribute)
    for each ``launches*`` attribute of a function in the ops modules."""
    import importlib

    seen, out = set(), []
    for name in _OPS:
        mod = importlib.import_module(f"exllama_tpu_torch.ops.{name}")
        for fn in vars(mod).values():
            if not callable(fn) or id(fn) in seen:
                continue
            attrs = sorted(a for a in getattr(fn, "__dict__", {})
                           if a.startswith("launches"))
            if attrs:
                seen.add(id(fn))
                out += [(fn, a) for a in attrs]
    return out


def launch_counts() -> dict:
    """{(wrapper, attribute): count} of every launch counter."""
    return {(fn, a): getattr(fn, a) for fn, a in launch_counters()}


def add_launches(counts: dict, times: int = 1):
    """Add ``times`` x ``counts`` ({(wrapper, attribute): n}, e.g. the
    difference of two :func:`launch_counts`) to the counters."""
    for (fn, a), n in counts.items():
        setattr(fn, a, getattr(fn, a) + n * times)


# ---------------------------------------------------- scratch and capture

def scratch_in_use(dev) -> list:
    """The per-device scratch tensors the kernels write and keep between
    launches: K3's decode partials and tickets, the GEMVs' (K1, K4-K7)
    partials and tickets, K5's keys. A captured graph holds these
    references, so a later eager call that grows a scratch (and drops the
    dictionary's reference) never frees memory the graph still writes."""
    from exllama_tpu_torch.ops import attention, dense, quant

    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        # filed under the tensors' device, which has its index
        dev = torch.device("cuda", torch.cuda.current_device())
    held = [*attention._SCRATCH.get(dev, ()), *quant._GEMV_SCRATCH.get(dev, ())]
    keys = dense._HEAD_KEYS.get(dev)
    return held + ([keys] if keys is not None else [])


def no_growth_under_capture(name: str):
    """Raise where the per-device scratch ``name`` is about to be allocated
    or replaced while the current stream is being captured: the buffer
    would come from the graph's pool and the eager callers would share it.
    The eager step before each capture sizes every scratch."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name} would grow under CUDA graph capture: "
                           f"run the step eagerly first, which sizes it")
