"""Dense bf16 matmul for the lm_head (port of exllama_tpu/ops/dense.py).

M <= 32 rows go to kernel K4 ``dense_gemv`` (csrc/dense_gemv.cu), the port
of the TPU's ``dense.py:_kernel``; larger M stays a plain product, exactly
where the JAX package leaves it to ``jnp.dot``.
"""

from __future__ import annotations

import torch

from exllama_tpu_torch import kernels

GEMV_MAX_M = 32   # the JAX package's switch (a TPU number)


def dense_gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] bf16 @ w [K, V] bf16 -> f32 [M, V], f32 accumulation."""
    # f32 products in full precision on the card as well (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
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
