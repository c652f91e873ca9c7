"""Fused decode MLP block (port of exllama_tpu/ops/mlp.py):

    h + down( silu(gate(xn)) * up(xn) ),   xn = rms_norm(h) * w

in one launch of kernel K6 ``q4_mlp`` (csrc/q4_mlp.cu) for M = B*T <= 32
rows on CUDA tensors; ``q4_mlp_plain`` is its plain PyTorch version, the
separate-kernel path's composition with the same cast points, and
``q4_mlp_split_plain`` writes out the kernel's decomposition (two streaming
GEMV phases around silu(gate)*up). Under the
W4A8 values of ``impl`` ("pallas_a8", "pallas_a8x2", "pallas_a8t") both
GEMVs run K9's integer arithmetic (the a8 builds of the same source;
launches count on ``q4_mlp_a8``; over f32 scales on ``launches_f32``). The
caller checks ``fused_mlp_applicable`` first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from exllama_tpu_torch import kernels
from exllama_tpu_torch.config import A8_IMPLS, check_matmul_impl
from exllama_tpu_torch.formats.gptq import QuantTensor
from exllama_tpu_torch.ops.norms import rms_norm
from exllama_tpu_torch.ops.quant import (
    GEMV_MAX_M,
    _check_qt,
    check_qt_tensors,
    count_launch,
    fused_gemv_scratch,
    fused_gemv_split_plain,
    q4_gemv_a8_plain,
    q4_gemv_plain,
)

KERNEL_GROUPSIZES = (32, 64, 128)


def fused_mlp_applicable(gateup, down, hidden: int, m: int,
                         impl: str = "auto", has_lora: bool = False) -> bool:
    """The JAX gate's semantic conditions (mlp.py:249-286): a kernel
    ``impl`` (not the plain "xla"), fused gate|up and down present, no LoRA
    adapter on gate, up or down, no act-order on either, residual width ==
    down's output, one groupsize and one scale dtype, M small enough for
    the GEMV regime. The TPU conditions (npair layout, N_ALIGN padding, the
    VMEM budget) have no counterpart; K6's own limit is the groupsizes its
    GEMV takes."""
    if check_matmul_impl(impl) == "xla":
        return False
    if gateup is None or down is None or has_lora or m > GEMV_MAX_M:
        return False
    if gateup.scales.dtype != down.scales.dtype:
        return False
    if gateup.x_map is not None or down.x_map is not None:
        return False
    if gateup.groupsize != down.groupsize:
        return False
    if gateup.groupsize not in KERNEL_GROUPSIZES:
        return False
    return (down.out_features == hidden and gateup.in_features == hidden
            and gateup.out_features == 2 * down.in_features)


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of bf16 gate and up outputs: silu in f32 rounded to
    bf16, times up in bf16 (mlp.py:_silu_boundary)."""
    return F.silu(g.to(torch.float32)).to(u.dtype) * u


def gemv_plain_of(impl: str):
    """The plain GEMV (x, qt, norm_w=None, eps=1e-6) that ``impl`` runs at
    M <= 32: exact, a8 or a8x2."""
    if check_matmul_impl(impl) not in A8_IMPLS:
        return q4_gemv_plain
    two_pass = impl == "pallas_a8x2"
    return lambda x, qt, norm_w=None, eps=1e-6: q4_gemv_a8_plain(
        x, qt, norm_w, eps, two_pass)


def q4_mlp_plain(h, norm_w, gateup: QuantTensor, down: QuantTensor, eps,
                 impl: str = "auto"):
    """The MLP block as the separate path computes it, h [..., hidden]."""
    gemv = gemv_plain_of(impl)
    *lead, k = h.shape
    h2 = h.reshape(-1, k)
    a = rms_norm(h2, norm_w, eps)
    gu, ni = gemv(a, gateup), down.in_features
    mid = silu_mul(gu[..., :ni], gu[..., ni:])
    return (h2 + gemv(mid, down)).reshape(*lead, k)


def q4_mlp_split_plain(h, norm_w, gateup: QuantTensor, down: QuantTensor,
                       eps, blocks: int, impl: str = "auto", fault=None):
    """K6's decomposition on a grid of ``blocks`` blocks: the gate|up phase
    (norm prologue) and, after a grid barrier, the down phase over silu(gate)
    * up of the bf16 gate|up rows (formed as the down phase stages each unit
    at one row, in a pass of its own between two barriers at 2..32 rows:
    the same values); each phase stream-K (``quant.fused_gemv_split_plain``,
    with ``fault`` planted in the down phase); out = bf16(h + bf16(down))."""
    *lead, k = h.shape
    h2 = h.reshape(-1, k)
    gu = fused_gemv_split_plain(h2, gateup, blocks, norm_w, eps, impl)
    dn = fused_gemv_split_plain(gu, down, blocks, impl=impl,
                                glu=down.in_features, fault=fault)
    return (h2 + dn).reshape(*lead, k)


def q4_mlp(h: torch.Tensor, norm_w: torch.Tensor, gateup: QuantTensor,
           down: QuantTensor, eps: float, impl: str = "auto") -> torch.Tensor:
    """K6: the whole MLP block of h [..., hidden] bf16 in one launch; its
    GEMVs exact, a8 or a8x2 by ``impl``."""
    a8 = check_matmul_impl(impl) in A8_IMPLS
    if h.device.type == "cpu":
        return q4_mlp_plain(h, norm_w, gateup, down, eps, impl)
    if h.device.type != "cuda":
        raise RuntimeError(f"q4_mlp: unsupported device {h.device}")
    *lead, hidden = h.shape
    h2 = h.reshape(-1, hidden).contiguous()
    m = h2.shape[0]
    inter = down.in_features
    if not fused_mlp_applicable(gateup, down, hidden, m, impl):
        raise ValueError("q4_mlp: shapes outside fused_mlp_applicable")
    _check_qt(h2, gateup)
    check_qt_tensors(down, h.device)
    norm_w = norm_w.to(torch.bfloat16).contiguous()
    # scratch: gate|up [M, 2*inter] bf16, then the barrier counter
    gu_bytes = -(-m * 2 * inter * 2 // 256) * 256
    scratch = torch.empty((gu_bytes + 256,), dtype=torch.uint8, device=h.device)
    base = scratch.data_ptr()
    gpart, gticket = fused_gemv_scratch(h.device, m, 2 * inter)
    out = torch.empty_like(h2)
    lib = kernels.scaled("q4_mlp" if not a8 else (
        "q4_mlp_a8x2" if impl == "pallas_a8x2" else "q4_mlp_a8"),
        gateup.scales)
    kernels.check(kernels.launcher(lib)(
        h2.data_ptr(), norm_w.data_ptr(), gateup.qweight.data_ptr(),
        gateup.scales.data_ptr(), gateup.zscale.data_ptr(),
        down.qweight.data_ptr(), down.scales.data_ptr(),
        down.zscale.data_ptr(), base, base + gu_bytes,
        kernels.ptr(gpart), kernels.ptr(gticket), out.data_ptr(),
        m, hidden, inter, gateup.groupsize, float(eps), kernels.stream_of(h2),
    ), lib)
    count_launch(q4_mlp_a8 if a8 else q4_mlp, gateup)
    return out.reshape(*lead, hidden)


def q4_mlp_a8(h, norm_w, gateup, down, eps, two_pass: bool = False):
    """K6 with K9's arithmetic in both GEMVs (``two_pass``: a8x2)."""
    return q4_mlp(h, norm_w, gateup, down, eps,
                  "pallas_a8x2" if two_pass else "pallas_a8")


q4_mlp.launches = q4_mlp.launches_f32 = 0
q4_mlp_a8.launches = q4_mlp_a8.launches_f32 = 0
