"""4-bit GPTQ matmul (port of exllama_tpu/ops/quant.py:q4_matmul).

Six hand-written CUDA kernels, chosen by ``impl`` (the JAX package's
``TuningParams.matmul_impl`` values) and by the row count M exactly where
the JAX package switches its Pallas kernels (``GEMV_MAX_M = 32``, a
threshold measured on a TPU and kept for now):

  * M <= 32, exact ("auto" / "pallas"): K1 ``q4_gemv`` (csrc/q4_gemv.cu) --
    f32 group partial sums of exact nibbles, with the optional RMSNorm and
    act-order gather in its prologue; one row at groupsize 32 / 64 / 128
    takes the streaming GEMV (csrc/q4_stream.cuh, stream-K over the grid),
    2..32 rows (or another groupsize) the tensor-core route
    (csrc/q4_gemv_tc.cuh), K split across blocks as ``gemv_split_plan``
    says;
  * M <= 32, "pallas_a8" / "pallas_a8x2" / "pallas_a8t": K9 ``q4_gemv_a8``
    (the a8 builds of the same source) -- int8 activations per (row, group)
    against the nibbles in integer arithmetic; a8x2 adds a residual pass;
  * M > 32, exact and "pallas_a8" / "pallas_a8x2": K2 ``q4_dequant_matmul``
    (csrc/q4_matmul.cu) -- bf16 tile dequant + tensor-core products;
  * M > 32, "pallas_a8t": K11 ``w8_matmul`` (csrc/w8_matmul.cu) against the
    tensor's resident int8 image, or K10 ``q4_prefill_a8``
    (csrc/q4_prefill_a8.cu), which re-quantizes the 4-bit tile to int8 in
    the kernel, where the tensor has none; both int8 tensor-core products
    of row-quantized activations;
  * ``glu=(ni, ou)`` at M > 32: K12 ``q4_matmul_glu`` (K2's GLU mode) forms
    silu(gate)*up from the raw fused gate|up output inside the kernel.

K2, K12, K10 and K11 are the exact, GLU, int8 and W8 modes of one
pipelined tensor-core kernel (csrc/q4_ring.cuh).

Act-order x is gathered, and at M > 32 the norm applied, before the
prefill kernels. Each kernel wrapper runs its plain PyTorch version for CPU
tensors only (the tests), launches the kernel for CUDA tensors and raises
otherwise. ``_q4_matmul_plain`` is the analogue of the JAX
``_q4_matmul_xla``: dequantize to bf16, f32-accumulated product, cast to
x.dtype. The a8 plain versions do the kernels' integer arithmetic (int8
values multiplied exactly), not a dequantized product: their noise is the
kernels' noise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from exllama_tpu_torch import kernels
from exllama_tpu_torch.config import A8_IMPLS, check_matmul_impl
from exllama_tpu_torch.formats.gptq import (
    QuantTensor,
    dequantize_t,
    unpack_qweight,
    w8_col_scale,
)
from exllama_tpu_torch.ops import full_f32_matmul
from exllama_tpu_torch.ops.norms import rms_norm

GEMV_MAX_M = 32   # the JAX package's decode/prefill switch (a TPU number)
STREAM_GROUPSIZES = (32, 64, 128)   # the one-row streaming GEMV's groupsizes
GEMV_BN = 128     # columns of the tensor-core GEMV's block tile (q4_gemv_tc.cuh)
GEMV_UNIT = 32    # k of its unit, the least split of K
GEMV_MIN_SPLIT_UNITS = 8
# the one-row GEMV of K1 / K9, K6 and K7 (q4_stream.cuh): tiles of
# STREAM_BN columns, units of STREAM_UNIT k, shared out stream-K
STREAM_BN, STREAM_UNIT = 256, 128


def _q4_matmul_plain(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """x [M, K] @ dequant(qt) with f32 accumulation, in x.dtype."""
    w = dequantize_t(qt, torch.bfloat16)
    with full_f32_matmul():
        out = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)
    return out.to(x.dtype)


def check_qt_tensors(qt: QuantTensor, device: torch.device):
    """Raise unless qt's tensors are what the kernels read, on ``device``:
    any groupsize that is a multiple of 32 and divides K (the reference
    takes any that divides K)."""
    gs, k = qt.groupsize, qt.in_features
    if gs <= 0 or gs % 32 or k % gs:
        raise ValueError(f"groupsize {gs} with K = {k}: the kernels take a "
                         f"multiple of 32 that divides K")
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


def _prologue_plain(x, qt, norm_w, norm_eps):
    """The GEMV prologue: rms_norm(x)*w (optional), then the act-order
    gather (optional)."""
    if norm_w is not None:
        x = rms_norm(x, norm_w, norm_eps)
    if qt.x_map is not None:
        x = x.index_select(1, qt.x_map.to(torch.long))
    return x


def q4_gemv_plain(x, qt, norm_w=None, norm_eps=1e-6):
    return _q4_matmul_plain(_prologue_plain(x, qt, norm_w, norm_eps), qt)


def _quant_rows(xf: torch.Tensor):
    """Symmetric int8 quantization along the last axis: (integer-valued f32
    xq, f32 scale), scale = max(amax, 1e-20)/127, xq = clip(round(x /
    scale), +-127); round is half-to-even, as jnp.round."""
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-20) * (1.0 / 127.0)
    return torch.round(xf / sx).clamp_(-127, 127), sx


def q4_gemv_a8_plain(x, qt, norm_w=None, norm_eps=1e-6, two_pass=False,
                     out_dtype=None):
    """K9's arithmetic in plain tensor code (quant.py:
    _q4_gemv_kernel_npair_a8): per (row, group) int8 activations, integer
    nibble products (exact in f32: at most 128*127*15 < 2^24 a group), one
    f32 rescale per (group, column), the zero-point term on the exact f32
    group sum of x. ``two_pass``: a second int8 pass over the residual
    r = x - sx*xq at scale sx/254. ``out_dtype`` (default x.dtype):
    float32 returns the sums before the output rounding, which is what a
    kernel's bf16 output is held against to half a bf16 step."""
    x = _prologue_plain(x, qt, norm_w, norm_eps)
    m, k = x.shape
    gs, n = qt.groupsize, qt.out_features
    xf = x.to(torch.float32).reshape(m, k // gs, gs)
    q = unpack_qweight(qt.qweight).to(torch.float32).reshape(k // gs, gs, n)
    s = qt.scales.to(torch.float32)
    z = qt.zscale.to(torch.float32)
    xq, sx = _quant_rows(xf)
    with full_f32_matmul():
        d = torch.einsum("mgk,gkn->mgn", xq, q) * sx
        if two_pass:
            sx2 = sx * (1.0 / 254.0)
            xq2 = torch.round((xf - xq * sx) / sx2).clamp_(-127, 127)
            d = d + torch.einsum("mgk,gkn->mgn", xq2, q) * sx2
    out = (d * s - xf.sum(dim=-1, keepdim=True) * z).sum(dim=1)
    return out.to(out_dtype or x.dtype)


def _gemv_checks(name, x, qt, norm_w):
    _check_qt(x, qt)
    m, k = x.shape
    if m > GEMV_MAX_M:
        raise ValueError(f"{name} takes M <= {GEMV_MAX_M}, got {m}")
    if norm_w is not None:
        norm_w = norm_w.to(torch.bfloat16).contiguous()
        if norm_w.shape != (k,):
            raise ValueError(f"norm_w shape {tuple(norm_w.shape)} != ({k},)")
    xm = qt.x_map
    if xm is not None and (xm.dtype != torch.int32 or xm.shape != (k,)):
        raise ValueError("x_map must be int32 [K]")
    return x.contiguous(), norm_w


def gemv_tc_route(m: int, gs: int) -> bool:
    """Whether K1 / K9 take the tensor-core route for m rows at groupsize
    gs: 2..32 rows, or one row at a groupsize outside the streaming
    GEMV's."""
    return m > 1 or gs not in STREAM_GROUPSIZES


def gemv_split_plan(n: int, k: int, sms: int) -> int:
    """Splits of K for the tensor-core GEMV of an N-column, K-deep weight on
    a card of ``sms`` SMs: as many (128-column tile, split) blocks as fit
    in one wave of two an SM (the kernel's residency), each split at least
    8 units of 32 k, none empty (the normalisation of
    csrc/q4_gemv_tc.cuh:plan_splits, its nsplit > 0 branch)."""
    units = k // GEMV_UNIT
    tiles = -(-n // GEMV_BN)
    nsplit = max(1, min(2 * sms // tiles,
                        max(1, units // GEMV_MIN_SPLIT_UNITS)))
    per = -(-units // nsplit)
    return -(-units // per)


def gemv_rows(m: int) -> int:
    """Rows the tensor-core GEMV pads m to: one or two m16 tiles."""
    return 16 if m <= 16 else 32


_GEMV_SCRATCH: dict = {}


def gemv_scratch(dev, n_part: int, n_ticket: int):
    """The tensor-core GEMV's split partials (f32) and column-tile tickets
    (int32, zero between launches: the last block of each tile resets its
    own), grown per device and kept, as K3's decode scratch. K1, K9, K6 and
    K7 run on one stream and share them."""
    part, ticket = _GEMV_SCRATCH.get(dev, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty((max(n_part, 1),), dtype=torch.float32, device=dev)
    if ticket is None or ticket.numel() < n_ticket:
        ticket = torch.zeros((max(n_ticket, 1),), dtype=torch.int32, device=dev)
    _GEMV_SCRATCH[dev] = (part, ticket)
    return part, ticket


def fused_split_plan(n: int, k: int, gs: int, blocks: int) -> tuple[int, int]:
    """The splits of K, and the units of 32 k in each, that the fused
    kernels K6 / K7 give an N-column, K-deep GEMV phase at 2..32 rows on a
    persistent grid of ``blocks`` blocks (csrc/q4_gemv_tc.cuh:plan_splits):
    as many splits as keep every (column tile, split) item in one wave of
    the grid, each at least 8 units, at group boundaries."""
    units, tiles = k // GEMV_UNIT, -(-n // GEMV_BN)
    most = max(1, units // GEMV_MIN_SPLIT_UNITS)
    gu = max(1, gs // GEMV_UNIT)
    groups = max(1, units // gu)
    s = max(1, min(blocks // tiles, most))
    ups = -(-groups // s) * gu
    return -(-units // ups), ups


def fused_gemv_items(n: int, k: int, gs: int, blocks: int):
    """The plan written out: for each block, its items [(column tile, first
    unit, end unit)] in the order it takes them (item i = tile i // nsplit,
    split i % nsplit)."""
    ns, ups = fused_split_plan(n, k, gs, blocks)
    units, tiles = k // GEMV_UNIT, -(-n // GEMV_BN)
    plan = [[] for _ in range(blocks)]
    for item in range(tiles * ns):
        t, sp = divmod(item, ns)
        plan[item % blocks].append((t, sp * ups, min(units, (sp + 1) * ups)))
    return plan


def stream_k_ranges(tiles: int, ku: int, grid: int):
    """Stream-K's work division (csrc/dense_stream.cuh, csrc/q4_stream.cuh):
    the tiles x ku (tile, unit) items, tile after tile, shared out as
    contiguous ranges among ``grid`` blocks. For each block its ranges
    [(tile, first unit, end unit, slot)], units counted within the tile;
    slot 0 / 1 is the scratch slot of a range that shares its tile with
    other blocks (the block's first / last range), None for a whole tile."""
    total = tiles * ku
    plan = []
    for b in range(grid):
        u0, u1 = b * total // grid, (b + 1) * total // grid
        ranges, u = [], u0
        while u < u1:
            t = u // ku
            end = min(u1, (t + 1) * ku)
            whole = u == t * ku and end == (t + 1) * ku
            ranges.append((t, u - t * ku, end - t * ku,
                           None if whole else (0 if u == u0 else 1)))
            u = end
        plan.append(ranges)
    return plan


def q4_stream_plan(n: int, k: int, grid: int):
    """The one-row GEMV's ranges (``stream_k_ranges`` over STREAM_BN-column
    tiles and STREAM_UNIT-deep units) on a grid of ``grid`` blocks, of
    which the first min(grid, units) share the units (the others have
    none)."""
    tiles, ku = -(-n // STREAM_BN), -(-k // STREAM_UNIT)
    g = min(grid, tiles * ku)
    return stream_k_ranges(tiles, ku, g) + [[] for _ in range(grid - g)]


def fused_gemv_split_plain(x, qt, blocks: int, norm_w=None, eps=1e-6,
                           impl: str = "auto"):
    """A fused GEMV phase's decomposition on a grid of ``blocks`` blocks in
    plain tensor code: f32 partials of K9's integer arithmetic per (row,
    group) under the a8 values of ``impl``, else of the exact group sums
    s * (x . q) - z * sum(x); at one row each block's ranges of 128-k units
    (``q4_stream_plan``), a tile shared among blocks added in block order
    (of k), at 2..32 rows each item's split (``fused_split_plan``), a tile's
    splits added in split order -- as the last block of a tile adds them;
    rounded to x.dtype."""
    x = _prologue_plain(x, qt, norm_w, eps)
    a8 = check_matmul_impl(impl) in A8_IMPLS
    m, k = x.shape
    gs, n = qt.groupsize, qt.out_features
    xf = x.to(torch.float32).reshape(m, k // gs, gs)
    q = unpack_qweight(qt.qweight).to(torch.float32).reshape(k // gs, gs, n)
    with full_f32_matmul():
        if a8:
            xq, sx = _quant_rows(xf)
            d = torch.einsum("mgk,gkn->mgn", xq, q) * sx
            if impl == "pallas_a8x2":
                sx2 = sx * (1.0 / 254.0)
                xq2 = torch.round((xf - xq * sx) / sx2).clamp_(-127, 127)
                d = d + torch.einsum("mgk,gkn->mgn", xq2, q) * sx2
        else:
            d = torch.einsum("mgk,gkn->mgn", xf, q)
    per_group = (d * qt.scales.to(torch.float32)
                 - xf.sum(dim=-1, keepdim=True) * qt.zscale.to(torch.float32))
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    if m == 1:
        gpu = STREAM_UNIT // gs                       # groups a unit
        parts: dict = {}
        for ranges in q4_stream_plan(n, k, blocks):
            for t, a, e, slot in ranges:
                cols = slice(t * STREAM_BN, min((t + 1) * STREAM_BN, n))
                s = per_group[:, a * gpu:e * gpu, cols].sum(dim=1)
                if slot is None:
                    out[:, cols] = s
                else:
                    parts.setdefault(t, []).append(s)
        for t, ps in parts.items():                   # in block order
            total = torch.zeros_like(ps[0])
            for s in ps:
                total = total + s
            out[:, t * STREAM_BN:min((t + 1) * STREAM_BN, n)] = total
    else:
        ns, ups = fused_split_plan(n, k, gs, blocks)
        gpu = GEMV_UNIT * ups // gs                   # groups a split
        for sp in range(ns):                          # in split order
            out = out + per_group[:, sp * gpu:(sp + 1) * gpu].sum(dim=1)
    return out.to(x.dtype)


def fused_gemv_scratch(dev, m: int, widest_n: int, tickets: int = 0):
    """The split scratch of the fused kernels K6 / K7 at m rows (and of K1
    / K9 at one row), for a grid of at most 4 blocks an SM: partials for
    two ranges a block at one row (the streaming GEMV), one item a block
    at 2..32 rows;
    tickets for the widest GEMV phase or ``tickets`` (K7's (batch row, kv
    head) pairs), whichever is more."""
    blocks = 4 * kernels.sm_count(dev)
    n_part = (2 * blocks * STREAM_BN if m <= 1
              else blocks * gemv_rows(m) * GEMV_BN)
    return gemv_scratch(dev, n_part,
                        max(tickets, -(-widest_n // GEMV_BN)))


def _gemv_launch(lib, x, qt, norm_w, norm_eps):
    m, k = x.shape
    n = qt.out_features
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    nsplit, part, ticket = 1, None, None
    if gemv_tc_route(m, qt.groupsize):
        nsplit = gemv_split_plan(n, k, kernels.sm_count(x.device))
        tiles = -(-n // GEMV_BN)
        part, ticket = gemv_scratch(
            x.device, tiles * nsplit * gemv_rows(m) * GEMV_BN, tiles)
    else:
        part, ticket = fused_gemv_scratch(x.device, 1, n)
    kernels.check(kernels.launcher(lib)(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), kernels.ptr(norm_w), kernels.ptr(qt.x_map),
        out.data_ptr(), kernels.ptr(part), kernels.ptr(ticket), m, k, n,
        qt.groupsize, nsplit, float(norm_eps), kernels.stream_of(x),
    ), lib)
    return out


def q4_gemv(x: torch.Tensor, qt: QuantTensor, norm_w=None, norm_eps=1e-6):
    """K1: rms_norm(x)·w (optional) -> gather by x_map (optional) -> x @ W.

    x [M <= 32, K] bf16 -> [M, N] bf16."""
    if x.device.type == "cpu":
        return q4_gemv_plain(x, qt, norm_w, norm_eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"q4_gemv: unsupported device {x.device}")
    x, norm_w = _gemv_checks("q4_gemv", x, qt, norm_w)
    out = _gemv_launch("q4_gemv", x, qt, norm_w, norm_eps)
    q4_gemv.launches += 1
    return out


q4_gemv.launches = 0


def q4_gemv_a8(x: torch.Tensor, qt: QuantTensor, norm_w=None, norm_eps=1e-6,
               two_pass: bool = False):
    """K9: K1's function with W4A8 arithmetic (``two_pass``: a8x2).

    x [M <= 32, K] bf16 -> [M, N] bf16."""
    if x.device.type == "cpu":
        return q4_gemv_a8_plain(x, qt, norm_w, norm_eps, two_pass)
    if x.device.type != "cuda":
        raise RuntimeError(f"q4_gemv_a8: unsupported device {x.device}")
    x, norm_w = _gemv_checks("q4_gemv_a8", x, qt, norm_w)
    out = _gemv_launch("q4_gemv_a8x2" if two_pass else "q4_gemv_a8", x, qt,
                       norm_w, norm_eps)
    q4_gemv_a8.launches += 1
    return out


q4_gemv_a8.launches = 0


def _prefill_input(name, x, qt):
    _check_qt(x, qt)
    if x.shape[1] % 32:
        raise ValueError(f"{name} needs K % 32 == 0, got {x.shape[1]}")
    x = x.contiguous()
    if x.data_ptr() % 16:       # the kernels load x in 16-byte vectors
        x = x.clone()
    return x


def q4_dequant_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """K2: x [M, K] bf16 (already in the weight's row order) @ W -> bf16."""
    if x.device.type == "cpu":
        return _q4_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise RuntimeError(f"q4_dequant_matmul: unsupported device {x.device}")
    x = _prefill_input("q4_dequant_matmul", x, qt)
    m, k = x.shape
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


def glu_silu_mul(x: torch.Tensor, ni: int, ou: int) -> torch.Tensor:
    """silu(gate)*up of a raw fused gate|up output x [..., W] (gate in
    columns [0, ni), up in [ou, ou + ni)): silu in f32 rounded to bf16, times
    up in bf16 (quant.py:_glu_silu_mul)."""
    g, u = x[..., :ni], x[..., ou:ou + ni]
    return F.silu(g.to(torch.float32)).to(u.dtype) * u


def q4_matmul_glu_plain(x, qt, ni, ou):
    return _q4_matmul_plain(glu_silu_mul(x, ni, ou), qt)


def q4_matmul_glu(x: torch.Tensor, qt: QuantTensor, ni: int,
                  ou: int) -> torch.Tensor:
    """K12: (silu(x[:, :ni]) * x[:, ou:ou+ni]) @ W with the activation
    formed inside the kernel; x [M, W] bf16, ni = qt.in_features."""
    if x.device.type == "cpu":
        return q4_matmul_glu_plain(x, qt, ni, ou)
    if x.device.type != "cuda":
        raise RuntimeError(f"q4_matmul_glu: unsupported device {x.device}")
    m, w_in = x.shape
    if (x.dtype != torch.bfloat16 or ni != qt.in_features or ni % 32
            or ou % 8 or w_in % 8 or ou + ni > w_in):
        raise ValueError(f"q4_matmul_glu: x {tuple(x.shape)} {x.dtype}, "
                         f"glu ({ni}, {ou}) vs in_features {qt.in_features}")
    check_qt_tensors(qt, x.device)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty((m, qt.out_features), dtype=torch.bfloat16,
                      device=x.device)
    kernels.check(kernels.launcher("q4_matmul_glu")(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), out.data_ptr(), m, ni, qt.out_features,
        qt.groupsize, w_in, ou, kernels.stream_of(x),
    ), "q4_matmul_glu")
    q4_matmul_glu.launches += 1
    return out


q4_matmul_glu.launches = 0


def w8_matmul_plain(x, w8, ws, out_dtype=None):
    """K11's arithmetic in plain tensor code (quant.py:_q4_matmul_w8):
    float(xq @ w8.t()) * sx * ws with xq, sx the per-row int8 quantization
    of x; w8 the integer-valued K-major image [N, K]. The product runs in
    f64, where it is exact (|sum| <= 127*127*K < 2^53). ``out_dtype`` as in
    q4_gemv_a8_plain."""
    xq, sx = _quant_rows(x.to(torch.float32))
    acc = xq.to(torch.float64) @ w8.to(torch.float64).t()
    out = acc.to(torch.float32) * sx * ws.to(torch.float32)
    return out.to(out_dtype or x.dtype)


def q4_prefill_a8_plain(x, qt, ws, out_dtype=None):
    """K10's arithmetic in plain tensor code (quant.py:
    _q4_prefill_kernel_npair_a8): the f32 dequantized weight re-quantized
    per column as clip(round(w * (1/ws)), +-127), then K11's product."""
    w = dequantize_t(qt, torch.float32)
    inv = 1.0 / ws.to(torch.float32).clamp_min(1e-22)
    return w8_matmul_plain(x, torch.round(w * inv).clamp_(-127, 127).t(), ws,
                           out_dtype)


def _int8_operands(name, x, qt, ws):
    x = _prefill_input(name, x, qt)
    n = qt.out_features
    if (ws.dtype != torch.float32 or ws.shape != (n,) or ws.device != x.device
            or not ws.is_contiguous()):
        raise ValueError(f"{name}: column scales must be contiguous f32 "
                         f"[{n}] on {x.device}")
    m, k = x.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    return x, xq, sx, out


def w8_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """K11: x [M, K] bf16 (already normed, in the weight's row order) against
    qt's resident int8 image -> [M, N] bf16. The rows of x are quantized to
    int8 by a small kernel of the same launch."""
    if qt.w8 is None or qt.w8_scale is None:
        raise ValueError("w8_matmul: the tensor carries no int8 image")
    if x.device.type == "cpu":
        return w8_matmul_plain(x, qt.w8, qt.w8_scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"w8_matmul: unsupported device {x.device}")
    x, xq, sx, out = _int8_operands("w8_matmul", x, qt, qt.w8_scale)
    m, k = x.shape
    w8 = qt.w8
    if (w8.dtype != torch.int8 or w8.shape != (qt.out_features, k)
            or w8.device != x.device or not w8.is_contiguous()
            or w8.data_ptr() % 16):
        raise ValueError(f"w8: need contiguous, 16-byte aligned int8 "
                         f"[{qt.out_features}, {k}] on {x.device}")
    kernels.check(kernels.launcher("w8_matmul")(
        x.data_ptr(), w8.data_ptr(), qt.w8_scale.data_ptr(), xq.data_ptr(),
        sx.data_ptr(), out.data_ptr(), m, k, qt.out_features,
        kernels.stream_of(x),
    ), "w8_matmul")
    w8_matmul.launches += 1
    return out


w8_matmul.launches = 0


def q4_prefill_a8(x: torch.Tensor, qt: QuantTensor,
                  ws: torch.Tensor) -> torch.Tensor:
    """K10: x [M, K] bf16 (already normed, in the weight's row order) @ W
    through int8: the 4-bit tile re-quantized in the kernel against the
    column scales ws f32 [N] -> [M, N] bf16."""
    if x.device.type == "cpu":
        return q4_prefill_a8_plain(x, qt, ws)
    if x.device.type != "cuda":
        raise RuntimeError(f"q4_prefill_a8: unsupported device {x.device}")
    x, xq, sx, out = _int8_operands("q4_prefill_a8", x, qt, ws)
    m, k = x.shape
    kernels.check(kernels.launcher("q4_prefill_a8")(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), ws.data_ptr(), xq.data_ptr(), sx.data_ptr(),
        out.data_ptr(), m, k, qt.out_features, qt.groupsize,
        kernels.stream_of(x),
    ), "q4_prefill_a8")
    q4_prefill_a8.launches += 1
    return out


q4_prefill_a8.launches = 0


def q4_matmul(
    x: torch.Tensor,
    qt: QuantTensor,
    impl: str = "auto",
    norm_w: "torch.Tensor | None" = None,
    norm_eps: float = 1e-6,
    glu: "tuple[int, int] | None" = None,
) -> torch.Tensor:
    """``[rms_norm](x) @ dequant(qt)``; x [..., in_features] bf16 ->
    [..., out_features] bf16. Dispatches by ``impl`` and M = prod(leading
    dims) as the module docstring says (quant.py:_q4_matmul_pallas without
    its TPU block choosers).

    ``glu=(ni, ou)``: x is the raw fused gate|up output [..., W] and the
    product runs over silu(x[..., :ni]) * x[..., ou:ou+ni]; in the kernel
    (K12) at M > 32 without act-order and outside "pallas_a8t", formed up
    front otherwise. Composes with neither ``norm_w`` nor act-order fusion.
    """
    impl = check_matmul_impl(impl)
    if glu is not None:
        ni, ou = glu
        if norm_w is not None or ou + ni > x.shape[-1]:
            raise ValueError(f"glu {glu} with x {tuple(x.shape)}, norm_w "
                             f"{'set' if norm_w is not None else 'None'}")
        *lead, w_in = x.shape
        x2 = x.reshape(-1, w_in)
        if (x2.shape[0] > GEMV_MAX_M and qt.x_map is None
                and impl != "pallas_a8t" and qt.in_features == ni
                and ou % 8 == 0 and w_in % 8 == 0):
            return q4_matmul_glu(x2, qt, ni, ou).reshape(
                *lead, qt.out_features)
        x = glu_silu_mul(x, ni, ou)
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if x2.shape[0] <= GEMV_MAX_M:
        if impl in A8_IMPLS:
            out = q4_gemv_a8(x2, qt, norm_w, norm_eps,
                             two_pass=impl == "pallas_a8x2")
        else:
            out = q4_gemv(x2, qt, norm_w, norm_eps)
    else:
        x2 = _prologue_plain(x2, qt, norm_w, norm_eps)
        if impl != "pallas_a8t":
            out = q4_dequant_matmul(x2, qt)
        elif qt.w8 is not None:
            out = w8_matmul(x2, qt)
        else:
            ws = qt.w8_scale if qt.w8_scale is not None else w8_col_scale(qt)
            out = q4_prefill_a8(x2, qt, ws)
    return out.reshape(*lead, qt.out_features)
