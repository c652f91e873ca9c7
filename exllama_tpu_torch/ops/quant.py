"""4-bit GPTQ matmul (port of exllama_tpu/ops/quant.py:q4_matmul).

Two hand-written CUDA kernels, chosen by the row count M exactly where the
JAX package switches its Pallas kernels (``GEMV_MAX_M = 32``, a threshold
measured on a TPU and kept for now):

  * M <= 32: K1 ``q4_gemv`` (csrc/q4_gemv.cu) -- group partial sums with the
    optional RMSNorm and act-order gather in its prologue;
  * M > 32:  K2 ``q4_dequant_matmul`` (csrc/q4_matmul.cu) -- bf16 tile
    dequant + tensor-core products; act-order x is gathered before it.

Each kernel wrapper runs the plain PyTorch version for CPU tensors only
(the tests), launches the kernel for CUDA tensors and raises otherwise.
``_q4_matmul_plain`` is the analogue of the JAX ``_q4_matmul_xla``:
dequantize to bf16, f32-accumulated product, cast to x.dtype.
"""

from __future__ import annotations

import torch

from exllama_tpu_torch import kernels
from exllama_tpu_torch.formats.gptq import QuantTensor, dequantize_t
from exllama_tpu_torch.ops.norms import rms_norm

GEMV_MAX_M = 32   # the JAX package's decode/prefill switch (a TPU number)


def _q4_matmul_plain(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """x [M, K] @ dequant(qt) with f32 accumulation, in x.dtype."""
    # f32 products in full precision on the card as well (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    w = dequantize_t(qt, torch.bfloat16)
    out = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)
    return out.to(x.dtype)


def check_qt_tensors(qt: QuantTensor, device: torch.device):
    """Raise unless qt's tensors are what the kernels read, on ``device``."""
    if qt.groupsize not in (32, 64, 128):
        raise ValueError(f"groupsize {qt.groupsize}: kernels take 32/64/128")
    for name, t, dt in (("qweight", qt.qweight, torch.int32),
                        ("scales", qt.scales, torch.bfloat16),
                        ("zscale", qt.zscale, torch.bfloat16)):
        if t.dtype != dt or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name}: need contiguous {dt} on {device}")


def _check_qt(x: torch.Tensor, qt: QuantTensor):
    if x.dim() != 2 or x.shape[1] != qt.in_features:
        raise ValueError(f"x {tuple(x.shape)} vs in_features {qt.in_features}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bf16, got {x.dtype}")
    check_qt_tensors(qt, x.device)


def q4_gemv_plain(x, qt, norm_w=None, norm_eps=1e-6):
    if norm_w is not None:
        x = rms_norm(x, norm_w, norm_eps)
    if qt.x_map is not None:
        x = x.index_select(1, qt.x_map.to(torch.long))
    return _q4_matmul_plain(x, qt)


def q4_gemv(x: torch.Tensor, qt: QuantTensor, norm_w=None, norm_eps=1e-6):
    """K1: rms_norm(x)·w (optional) -> gather by x_map (optional) -> x @ W.

    x [M <= 32, K] bf16 -> [M, N] bf16."""
    if x.device.type == "cpu":
        return q4_gemv_plain(x, qt, norm_w, norm_eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"q4_gemv: unsupported device {x.device}")
    _check_qt(x, qt)
    m, k = x.shape
    if m > GEMV_MAX_M:
        raise ValueError(f"q4_gemv takes M <= {GEMV_MAX_M}, got {m}")
    x = x.contiguous()
    if norm_w is not None:
        norm_w = norm_w.to(torch.bfloat16).contiguous()
        if norm_w.shape != (k,):
            raise ValueError(f"norm_w shape {tuple(norm_w.shape)} != ({k},)")
    xm = qt.x_map
    if xm is not None and (xm.dtype != torch.int32 or xm.shape != (k,)):
        raise ValueError("x_map must be int32 [K]")
    out = torch.empty((m, qt.out_features), dtype=torch.bfloat16,
                      device=x.device)
    kernels.check(kernels.launcher("q4_gemv")(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), kernels.ptr(norm_w), kernels.ptr(xm),
        out.data_ptr(), m, k, qt.out_features, qt.groupsize, float(norm_eps),
        kernels.stream_of(x),
    ), "q4_gemv")
    q4_gemv.launches += 1
    return out


q4_gemv.launches = 0


def q4_dequant_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """K2: x [M, K] bf16 (already in the weight's row order) @ W -> bf16."""
    if x.device.type == "cpu":
        return _q4_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise RuntimeError(f"q4_dequant_matmul: unsupported device {x.device}")
    _check_qt(x, qt)
    m, k = x.shape
    if k % 32:
        raise ValueError(f"q4_dequant_matmul needs K % 32 == 0, got {k}")
    x = x.contiguous()
    if x.data_ptr() % 16:       # the kernel loads x in 16-byte vectors
        x = x.clone()
    out = torch.empty((m, qt.out_features), dtype=torch.bfloat16,
                      device=x.device)
    kernels.check(kernels.launcher("q4_matmul")(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), out.data_ptr(), m, k, qt.out_features,
        qt.groupsize, kernels.stream_of(x),
    ), "q4_matmul")
    q4_dequant_matmul.launches += 1
    return out


q4_dequant_matmul.launches = 0


def q4_matmul(
    x: torch.Tensor,
    qt: QuantTensor,
    norm_w: "torch.Tensor | None" = None,
    norm_eps: float = 1e-6,
) -> torch.Tensor:
    """``[rms_norm](x) @ dequant(qt)``; x [..., in_features] bf16 ->
    [..., out_features] bf16. Dispatches by M = prod(leading dims)."""
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if x2.shape[0] <= GEMV_MAX_M:
        out = q4_gemv(x2, qt, norm_w, norm_eps)
    else:
        if norm_w is not None:
            x2 = rms_norm(x2, norm_w, norm_eps)
        if qt.x_map is not None:
            x2 = x2.index_select(1, qt.x_map.to(torch.long))
        out = q4_dequant_matmul(x2, qt)
    return out.reshape(*lead, qt.out_features)
