"""RMSNorm (port of exllama_tpu/ops/norms.py).

Plain tensor code: on the decode path the norm rides in the q4 GEMV kernel's
prologue (ops/quant.py), elsewhere it is one elementwise pass.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """x * w / sqrt(mean(x^2) + eps); f32 math over the last axis, cast back."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)
