"""Dense bf16 matmul for the lm_head (port of exllama_tpu/ops/dense.py).

M <= 32 rows go to kernel K4 ``dense_gemv`` (csrc/dense_gemv.cu), the port
of the TPU's ``dense.py:_kernel``; larger M stays a plain product, exactly
where the JAX package leaves it to ``jnp.dot``. The greedy head
``head_argmax`` (final norm -> lm_head -> argmax, no logits kept) is kernel
K5 (csrc/head_argmax.cu), the port of ``dense.py:_head_argmax_kernel``.
"""

from __future__ import annotations

import torch

from exllama_tpu_torch import kernels
from exllama_tpu_torch.ops import full_f32_matmul
from exllama_tpu_torch.ops.norms import rms_norm

GEMV_MAX_M = 32   # the JAX package's switch (a TPU number)


def dense_gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] bf16 @ w [K, V] bf16 -> f32 [M, V], f32 accumulation."""
    with full_f32_matmul():
        return x.to(torch.float32) @ w.to(torch.float32)


def dense_gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4: x [M <= 32, K] bf16 @ w [K, V] bf16 -> f32 [M, V]."""
    if x.device.type == "cpu":
        return dense_gemv_plain(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"dense_gemv: unsupported device {x.device}")
    m, k = x.shape
    v = w.shape[1]
    if w.shape[0] != k or m > GEMV_MAX_M or v % 2:
        raise ValueError(f"dense_gemv: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("dense_gemv takes bf16 x and w")
    if not w.is_contiguous() or w.device != x.device or w.data_ptr() % 4:
        raise ValueError(
            "dense_gemv: w must be contiguous, 4-byte aligned, on x's device")
    x = x.contiguous()
    out = torch.empty((m, v), dtype=torch.float32, device=x.device)
    kernels.check(kernels.launcher("dense_gemv")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, v,
        kernels.stream_of(x),
    ), "dense_gemv")
    dense_gemv.launches += 1
    return out


dense_gemv.launches = 0


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with f32 output."""
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if x2.shape[0] <= GEMV_MAX_M:
        out = dense_gemv(x2.to(w.dtype), w)
    else:
        out = dense_gemv_plain(x2, w)
    return out.reshape(*lead, w.shape[1])


def head_argmax_plain(h: torch.Tensor, norm_w: torch.Tensor, w: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """rms_norm(h) @ w -> argmax (earliest index on ties), int32 [M]."""
    x = rms_norm(h.reshape(-1, h.shape[-1]), norm_w, eps)
    return torch.argmax(dense_gemv_plain(x, w), dim=-1).to(torch.int32)


def _head_argmax_rows(x: torch.Tensor, norm_w: torch.Tensor, w: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """K5 on x [M <= 32, K] bf16 -> int32 [M]."""
    m, k = x.shape
    v = w.shape[1]
    if w.shape[0] != k or v % 2 or norm_w.shape != (k,):
        raise ValueError(f"head_argmax: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("head_argmax takes bf16 x and w")
    if not w.is_contiguous() or w.device != x.device or w.data_ptr() % 4:
        raise ValueError(
            "head_argmax: w must be contiguous, 4-byte aligned, on x's device")
    x = x.contiguous()
    norm_w = norm_w.to(torch.bfloat16).contiguous()
    keys = torch.empty((m,), dtype=torch.int64, device=x.device)
    ids = torch.empty((m,), dtype=torch.int32, device=x.device)
    kernels.check(kernels.launcher("head_argmax")(
        x.data_ptr(), norm_w.data_ptr(), w.data_ptr(), keys.data_ptr(),
        ids.data_ptr(), m, k, v, float(eps), kernels.stream_of(x),
    ), "head_argmax")
    head_argmax.launches += 1
    return ids


def head_argmax(h: torch.Tensor, norm_w: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Greedy head: rms_norm -> lm_head GEMV -> argmax, no logits kept.

    h [B, T, hidden] (or [B, hidden]) -> int32 token ids [B, T] (or [B, 1]).
    K5 for CUDA tensors with B*T <= 32; the plain composition for more rows,
    as the JAX package does (dense.py:183-188), and for CPU tensors."""
    *lead, k = h.shape
    b = lead[0] if lead else 1
    x = h.reshape(-1, k)
    if h.device.type == "cpu" or x.shape[0] > GEMV_MAX_M:
        ids = head_argmax_plain(x, norm_w, w, eps)
    elif h.device.type == "cuda":
        ids = _head_argmax_rows(x, norm_w, w, eps)
    else:
        raise RuntimeError(f"head_argmax: unsupported device {h.device}")
    return ids.reshape(b, -1)


head_argmax.launches = 0
