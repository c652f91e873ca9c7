"""Fused decode MLP block (port of exllama_tpu/ops/mlp.py):

    h + down( silu(gate(xn)) * up(xn) ),   xn = rms_norm(h) * w

in one launch of kernel K6 ``q4_mlp`` (csrc/q4_mlp.cu) for M = B*T <= 32
rows on CUDA tensors; ``q4_mlp_plain`` is its plain PyTorch version, the
separate-kernel path's composition with the same cast points, and
``q4_mlp_split_plain`` writes out the kernel's decomposition: in the exact
mode the Hopper kernel's (csrc/fused_wg.cuh; ``q4_mlp_plan``, the GEMV
phases as ``fused_wg_gemv_split_plain``), or with ``blocks=`` the parent's
(two streaming GEMV phases around silu(gate)*up). Under the
W4A8 values of ``impl`` ("pallas_a8", "pallas_a8x2", "pallas_a8t") both
GEMVs run K9's integer arithmetic (the a8 builds of the same source, on the
parent's streaming GEMV; launches count on ``q4_mlp_a8``; over f32 scales on
``launches_f32``). The caller checks ``fused_mlp_applicable`` first.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from exllama_tpu_torch import kernels
from exllama_tpu_torch.config import A8_IMPLS, check_matmul_impl
from exllama_tpu_torch.formats.gptq import QuantTensor, unpack_qweight
from exllama_tpu_torch.ops import full_f32_matmul
from exllama_tpu_torch.ops.norms import rms_norm
from exllama_tpu_torch.ops.quant import (
    GEMV_MAX_M,
    _check_qt,
    check_qt_tensors,
    count_launch,
    fused_gemv_scratch,
    fused_gemv_split_plain,
    gemv_scratch,
    q4_gemv_a8_plain,
    q4_gemv_plain,
    stream_k_ranges,
)

KERNEL_GROUPSIZES = (32, 64, 128)


def fused_mlp_applicable(gateup, down, hidden: int, m: int,
                         impl: str = "auto", has_lora: bool = False) -> bool:
    """The JAX gate's semantic conditions (mlp.py:249-286): a kernel
    ``impl`` (not the plain "xla"), fused gate|up and down present, no LoRA
    adapter on gate, up or down, no act-order on either, residual width ==
    down's output, one groupsize and one scale dtype, M small enough for
    the GEMV regime. The TPU conditions (npair layout, N_ALIGN padding, the
    VMEM budget) have no counterpart; K6's own limits are the groupsizes its
    GEMV takes and, in the exact mode, a width that is a multiple of 8 (the
    rows its Hopper kernel loads by TMA; the a8 modes take any width)."""
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
    if hidden % 8 and check_matmul_impl(impl) not in A8_IMPLS:
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


# ------------------------------- K6 / K7 on Hopper: the plan in plain code

# csrc/fused_wg.cuh: GEMV phases of FWG_BN-column tiles, k in FWG_BK-deep
# slabs, x's rows in a row tile of 8, 16 or 32 (wgmma's N); one block an SM
FWG_BN, FWG_BK, FWG_ROW_TILES = 256, 64, (8, 16, 32)


def fused_row_tile(m: int) -> int:
    """The Hopper K6 / K7's row tile for m <= 32 rows (fused_wg.cuh:
    row_tile)."""
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"K6 / K7 take 1..{GEMV_MAX_M} rows, got {m}")
    return next(t for t in FWG_ROW_TILES if m <= t)


@dataclass(frozen=True)
class FusedPhase:
    """One GEMV phase of the Hopper K6 / K7: an [m, k] x [k, n] product
    whose (tile, slab) units are shared out stream-K among the first
    ``grid`` blocks (the phase's units, where they are fewer than the
    launch's blocks); its x follows grid barrier ``dep`` (0: an input)."""
    name: str
    k: int
    n: int
    grid: int
    dep: int

    @property
    def tiles(self):
        return -(-self.n // FWG_BN)

    @property
    def ktiles(self):
        return -(-self.k // FWG_BK)

    def ranges(self, blocks: int):
        """Each of the launch's ``blocks`` blocks' ranges [(tile, first
        slab, end slab, slot)] (``quant.stream_k_ranges``; none past the
        phase's grid)."""
        return (stream_k_ranges(self.tiles, self.ktiles, self.grid)
                + [[] for _ in range(blocks - self.grid)])


@dataclass(frozen=True)
class FusedPlan:
    """A Hopper K6 / K7 launch on ``blocks`` blocks (one an SM): its GEMV
    phases in order, attention (K7) before phase ``attn_at`` (-1: none),
    the grid barriers between consecutive phases."""
    m: int
    bm: int
    blocks: int
    phases: tuple
    attn_at: int = -1

    def phase(self, name: str) -> FusedPhase:
        return next(p for p in self.phases if p.name == name)

    def units(self):
        """For each block, the (phase index, tile, slab) units in the order
        in which its producer warp streams their weights: phase after
        phase, each phase's ranges in order, from the launch's start."""
        out = [[] for _ in range(self.blocks)]
        for i, ph in enumerate(self.phases):
            for b, ranges in enumerate(ph.ranges(self.blocks)):
                out[b] += [(i, t, kt) for t, kb, ke, _ in ranges
                           for kt in range(kb, ke)]
        return out

    def barriers(self) -> int:
        """The grid barriers of the launch."""
        return len(self.phases) - 1 + (self.attn_at >= 0)


def fused_plan(m: int, sms: int, shapes, attn_at: int = -1) -> FusedPlan:
    """The plan of a launch of the Hopper K6 / K7 on ``sms`` SMs over the
    GEMV phases ``shapes`` [(name, k, n)], attention before phase
    ``attn_at`` (fused_wg.cuh: add_phase, the consumers' barriers)."""
    phases = []
    for i, (name, k, n) in enumerate(shapes):
        units = -(-n // FWG_BN) * -(-k // FWG_BK)
        dep = i + (0 <= attn_at <= i)
        phases.append(FusedPhase(name, k, n, min(sms, units), dep))
    return FusedPlan(m, fused_row_tile(m), sms, tuple(phases), attn_at)


@functools.lru_cache(maxsize=256)
def q4_mlp_plan(m: int, hidden: int, inter: int, sms: int) -> FusedPlan:
    """K6's Hopper plan: gate|up (the norm staged first), one grid barrier,
    down (silu(gate) * up staged from gate|up's rows)."""
    return fused_plan(m, sms, (("gateup", hidden, 2 * inter),
                               ("down", inter, hidden)))


def fused_wg_gemv_split_plain(x, qt: QuantTensor, phase: FusedPhase,
                              blocks: int, norm_w=None, eps=1e-6,
                              glu: int = 0, out_dtype=None, drop=None):
    """One GEMV phase of the Hopper K6 / K7 in plain tensor code: x staged
    as its staging warps stage it -- bf16(rms_norm(x) * w) (the normed row
    rounded before the products: ``rms_norm``), silu(gate) * up of the bf16
    gate|up rows x[:, :glu], x[:, glu:2 glu] (``silu_mul``), or x as it is
    --; per 32-deep half slab the f32 products with the nibbles as 128 + q,
    folded as s * p - (zs + 128 s) * sum(x_half) (K1's fold); each block's
    ranges of ``phase`` (on a launch of ``blocks`` blocks) summed over their
    halves, a tile cut between blocks added from its pieces in block order
    (the order of k); rounded once to ``out_dtype`` (default x's). ``drop``
    = (block, range index) leaves that range out (a planted fault)."""
    if glu:
        x = silu_mul(x[:, :glu], x[:, glu:2 * glu])
    elif norm_w is not None:
        x = rms_norm(x, norm_w, eps)
    m, k = x.shape
    n, gs = qt.out_features, qt.groupsize
    if (phase.k, phase.n) != (k, n):
        raise ValueError(f"phase {phase.name} is {phase.k}x{phase.n}, "
                         f"got {k}x{n}")
    f32 = torch.float32
    halves = k // 32
    xh = x.to(f32).reshape(m, halves, 32)
    q = unpack_qweight(qt.qweight).to(f32).reshape(halves, 32, n) + 128.0
    with full_f32_matmul():
        p = torch.einsum("mhk,hkn->hmn", xh, q)
    grp = torch.arange(halves, device=x.device) * 32 // gs
    s = qt.scales.to(f32)[grp][:, None, :]
    zc = 128.0 * s + qt.zscale.to(f32)[grp][:, None, :]
    contrib = s * p - zc * xh.sum(-1).t()[:, :, None]          # [H, m, n]
    out = torch.zeros((m, n), dtype=f32, device=x.device)
    parts: dict = {}
    for b, ranges in enumerate(phase.ranges(blocks)):
        for i, (t, kb, ke, slot) in enumerate(ranges):
            if drop == (b, i):
                continue
            cols = slice(t * FWG_BN, min((t + 1) * FWG_BN, n))
            piece = contrib[2 * kb:min(2 * ke, halves), :, cols].sum(dim=0)
            if slot is None:
                out[:, cols] = piece
            else:
                parts.setdefault(t, []).append(piece)
    for t, ps in parts.items():                       # in block order
        total = ps[0]
        for piece in ps[1:]:
            total = total + piece
        out[:, t * FWG_BN:min((t + 1) * FWG_BN, n)] = total
    return out.to(out_dtype or x.dtype)


def fused_wg_scratch(dev, m: int, widest_n: int, tickets: int = 0):
    """The Hopper K6 / K7's scratch, from the GEMVs' per-device scratch
    (which graphs hold): two stream-K pieces of row tile x FWG_BN f32 for
    each block (one an SM), one ticket a tile of the widest phase or
    ``tickets`` (K7's (batch row, kv head) pairs), whichever is more, and
    the grid barrier's two counters, the ticket array's last two entries
    (zero between launches: each launch's last block resets them). Returns
    (part, ticket, the counters' address)."""
    blocks = kernels.sm_count(dev)
    part, ticket = gemv_scratch(dev, 2 * blocks * fused_row_tile(m) * FWG_BN,
                                max(tickets, -(-widest_n // FWG_BN)) + 2)
    return part, ticket, ticket.data_ptr() + 4 * (ticket.numel() - 2)


def q4_mlp_split_plain(h, norm_w, gateup: QuantTensor, down: QuantTensor,
                       eps, blocks=None, impl: str = "auto", fault=None, *,
                       plan: FusedPlan = None):
    """K6's decomposition. With ``plan`` (``q4_mlp_plan``) the Hopper
    kernel's: the gate|up phase over the normed rows, a grid barrier, the
    down phase over silu(gate) * up of the bf16 gate|up rows, each as
    ``fused_wg_gemv_split_plain``; out = bf16(h + bf16(down)). ``fault``
    plants "silu_up" (silu applied to up, not to gate) or "residual_twice"
    (h added twice). With ``blocks`` the parent's on a grid of that many
    blocks: each phase stream-K (``quant.fused_gemv_split_plain``, ``impl``
    its arithmetic, ``fault`` planted in the down phase), silu(gate) * up
    formed as the down phase stages each unit at one row, in a pass of its
    own between two barriers at 2..32 rows (the same values)."""
    *lead, k = h.shape
    h2 = h.reshape(-1, k)
    if plan is None:
        gu = fused_gemv_split_plain(h2, gateup, blocks, norm_w, eps, impl)
        dn = fused_gemv_split_plain(gu, down, blocks, impl=impl,
                                    glu=down.in_features, fault=fault)
        return (h2 + dn).reshape(*lead, k)
    ni = down.in_features
    gu = fused_wg_gemv_split_plain(h2, gateup, plan.phase("gateup"),
                                   plan.blocks, norm_w, eps)
    if fault == "silu_up":
        gu = torch.cat([gu[:, ni:2 * ni], gu[:, :ni]], dim=1)
    dn = fused_wg_gemv_split_plain(gu, down, plan.phase("down"), plan.blocks,
                                   glu=ni)
    out = h2 + dn
    if fault == "residual_twice":
        out = out + h2
    return out.reshape(*lead, k)


def q4_mlp(h: torch.Tensor, norm_w: torch.Tensor, gateup: QuantTensor,
           down: QuantTensor, eps: float, impl: str = "auto") -> torch.Tensor:
    """K6: the whole MLP block of h [..., hidden] bf16 in one launch; its
    GEMVs exact (the Hopper kernel, csrc/fused_wg.cuh), a8 or a8x2 (the
    streaming GEMV) by ``impl``."""
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
    if not a8 and (h2.data_ptr() % 16 or norm_w.data_ptr() % 16):
        h2, norm_w = h2.clone(), norm_w.clone()     # rows TMA loads
    # scratch: gate|up [M, 2*inter] bf16, then (a8) the barrier counter
    gu_bytes = -(-m * 2 * inter * 2 // 256) * 256
    scratch = torch.empty((gu_bytes + 256,), dtype=torch.uint8, device=h.device)
    base = scratch.data_ptr()
    if a8:
        gpart, gticket = fused_gemv_scratch(h.device, m, 2 * inter)
        bar = base + gu_bytes
    else:
        gpart, gticket, bar = fused_wg_scratch(h.device, m, 2 * inter)
    out = torch.empty_like(h2)
    lib = kernels.scaled("q4_mlp" if not a8 else (
        "q4_mlp_a8x2" if impl == "pallas_a8x2" else "q4_mlp_a8"),
        gateup.scales)
    kernels.check(kernels.launcher(lib)(
        h2.data_ptr(), norm_w.data_ptr(), gateup.qweight.data_ptr(),
        gateup.scales.data_ptr(), gateup.zscale.data_ptr(),
        down.qweight.data_ptr(), down.scales.data_ptr(),
        down.zscale.data_ptr(), base, bar,
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
