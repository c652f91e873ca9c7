"""4-bit GPTQ matmul (port of exllama_tpu/ops/quant.py:q4_matmul).

Six hand-written CUDA kernels, chosen by ``impl`` (the JAX package's
``TuningParams.matmul_impl`` values) and by the row count M exactly where
the JAX package switches its Pallas kernels (``GEMV_MAX_M = 32``, a
threshold measured on a TPU and kept for now):

  * M <= 32, exact ("auto" / "pallas"): K1 ``q4_gemv`` (csrc/q4_gemv.cu) --
    f32 group partial sums of exact nibbles, with the optional RMSNorm and
    act-order gather in its prologue; by ``gemv_tc_route``, one row at
    groupsize 32 / 64 / 128 takes the streaming GEMV (csrc/q4_stream.cuh,
    stream-K over the grid; K6 and K7 run it at every row count), 2..32
    rows (or another groupsize) the Hopper kernel (csrc/q4_gemv_wg.cuh:
    TMA, wgmma with the nibbles as its register operand and x's rows as its
    N, stream-K as ``q4_gemv_plan`` says);
  * M <= 32, "pallas_a8" / "pallas_a8x2" / "pallas_a8t": K9 ``q4_gemv_a8``
    (the a8 builds of the same source) -- int8 activations per (row, group)
    against the nibbles in integer arithmetic; a8x2 adds a residual pass;
    at 2..32 rows on the mma.sync tensor-core route (csrc/q4_gemv_tc.cuh),
    its K split across blocks as ``gemv_split_plan`` says (that route's
    exact mode, K1's kernel before the Hopper one, is reached by no wrapper
    here);
  * M > 32, exact and "pallas_a8" / "pallas_a8x2": K2 ``q4_dequant_matmul``
    (csrc/q4_matmul.cu, csrc/q4_wgmma.cuh) -- TMA, the weight dequantized
    into wgmma's register operand, the row tile by M, a persistent grid and
    stream-K where the tiles do not fill the card (``q4_matmul_plan``);
  * M > 32, "pallas_a8t": K11 ``w8_matmul`` (csrc/w8_matmul.cu) against the
    tensor's resident int8 image, or K10 ``q4_prefill_a8``
    (csrc/q4_prefill_a8.cu), which re-quantizes the 4-bit tile to int8 in
    the kernel, where the tensor has none; both int8 tensor-core products
    of row-quantized activations;
  * ``glu=(ni, ou)`` at M > 32: K12 ``q4_matmul_glu`` (the ring's GLU mode) forms
    silu(gate)*up from the raw fused gate|up output inside the kernel.

K12, K10 and K11 are the GLU, int8 and W8 modes of one pipelined
mma.sync kernel (csrc/q4_ring.cuh), whose exact mode was K2's before the
Hopper kernel and is reached by no wrapper here. ``lora=(A, B)`` adds a
LoRA adapter's low-rank term after any of them (``lora_delta``: two
f32-accumulated products in plain tensor code, which is where the JAX
package computes it too).

``impl="xla"`` is the plain path, ``_q4_matmul_plain`` on any device (the
JAX package's ``impl == "xla"`` branch): an oracle that runs only where it is
named, never a fallback. A tensor with f32 scales (``scale_dtype="f32"``)
runs each kernel's f32-scale build (``kernels.scaled``); its launches count
on the wrapper's ``launches_f32``, not on ``launches``.

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

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from exllama_tpu_torch import kernels
from exllama_tpu_torch.config import A8_IMPLS, check_matmul_impl
from exllama_tpu_torch.formats.gptq import (
    SCALE_TORCH_DTYPES,
    QuantTensor,
    dequantize_t,
    unpack_qweight,
    w8_col_scale,
)
from exllama_tpu_torch.ops import full_f32_matmul
from exllama_tpu_torch.ops.norms import rms_norm

GEMV_MAX_M = 32   # the JAX package's decode/prefill switch (a TPU number)
STREAM_GROUPSIZES = (32, 64, 128)   # the streaming GEMV's groupsizes
GEMV_BN = 128     # columns of the tensor-core GEMV's block tile (q4_gemv_tc.cuh)
GEMV_UNIT = 32    # k of its unit, the least split of K
GEMV_MIN_SPLIT_UNITS = 8
# the streaming GEMV of K1 / K9 (one row), K6 and K7 (q4_stream.cuh): tiles
# of STREAM_BN columns, units of STREAM_UNIT k, shared out stream-K; rows
# in one row tile of 1, 8, 16, 24 or 32
STREAM_BN, STREAM_UNIT = 256, 128


def _q4_matmul_plain(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """x [M, K] @ dequant(qt) with f32 accumulation, in x.dtype."""
    w = dequantize_t(qt, torch.bfloat16)
    with full_f32_matmul():
        out = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)
    return out.to(x.dtype)


SCALE_DTYPES = tuple(SCALE_TORCH_DTYPES.values())


def check_qt_tensors(qt: QuantTensor, device: torch.device):
    """Raise unless qt's tensors are what the kernels read, on ``device``:
    any groupsize that is a multiple of 32 and divides K (the reference
    takes any that divides K); scales and zero-scales both bf16 or both f32
    (each scale type has its own kernel builds)."""
    gs, k = qt.groupsize, qt.in_features
    if gs <= 0 or gs % 32 or k % gs:
        raise ValueError(f"groupsize {gs} with K = {k}: the kernels take a "
                         f"multiple of 32 that divides K")
    sdt = qt.scales.dtype
    if sdt not in SCALE_DTYPES:
        raise ValueError(f"scales: need one of {SCALE_DTYPES}, got {sdt}")
    for name, t, dt in (("qweight", qt.qweight, torch.int32),
                        ("scales", qt.scales, sdt),
                        ("zscale", qt.zscale, sdt)):
        if t.dtype != dt or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name}: need contiguous {dt} on {device}")


def count_launch(fn, qt: QuantTensor):
    """One more launch on ``fn``'s counter: ``launches``, or
    ``launches_f32`` for the f32-scale build (qt's scales are f32)."""
    attr = "launches_f32" if qt.scales.dtype == torch.float32 else "launches"
    setattr(fn, attr, getattr(fn, attr) + 1)


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
    """Whether K1 / K9 leave the streaming GEMV for m rows at groupsize gs:
    2..32 rows, or one row at a groupsize outside the streaming GEMV's --
    K1 then takes its Hopper kernel (``q4_gemv_plan``), K9 its tensor-core
    route (csrc/q4_gemv.cu makes the same choice; PERF.md §6 says why
    neither runs the streaming GEMV at 2..32 rows, where K6 and K7 do)."""
    return m > 1 or gs not in STREAM_GROUPSIZES


def stream_row_tile(m: int) -> int:
    """The streaming GEMV's row tile for m rows (csrc/q4_stream.cuh:
    row_tile): 1, 8, 16, 24 or 32; its mma tiles 8 rows at a time, so m
    rows are staged padded to a multiple of 8."""
    return next(t for t in (1, 8, 16, 24, 32) if m <= t)


def gemv_split_plan(n: int, k: int, sms: int) -> int:
    """Splits of K for the tensor-core GEMV (K9 at 2..32 rows, and K1's
    parent) of an N-column, K-deep weight on
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
    own), grown per device and kept, as K3's decode scratch. K1, K2, K9,
    K4-K7 run on one stream and share them. A graph holds the buffers it
    captured (``kernels.scratch_in_use``); growing under capture raises."""
    part, ticket = _GEMV_SCRATCH.get(dev, (None, None))
    if part is None or part.numel() < n_part:
        kernels.no_growth_under_capture("the GEMV partials")
        part = torch.empty((max(n_part, 1),), dtype=torch.float32, device=dev)
    if ticket is None or ticket.numel() < n_ticket:
        kernels.no_growth_under_capture("the GEMV tickets")
        ticket = torch.zeros((max(n_ticket, 1),), dtype=torch.int32, device=dev)
    _GEMV_SCRATCH[dev] = (part, ticket)
    return part, ticket


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
    """The streaming GEMV's ranges (``stream_k_ranges`` over STREAM_BN-column
    tiles and STREAM_UNIT-deep units) on a grid of ``grid`` blocks, of
    which the first min(grid, units) share the units (the others have
    none). The units do not depend on the row count: every row of x rides
    in each unit's slab."""
    tiles, ku = -(-n // STREAM_BN), -(-k // STREAM_UNIT)
    g = min(grid, tiles * ku)
    return stream_k_ranges(tiles, ku, g) + [[] for _ in range(grid - g)]


def tile_grid(tiles: int, ktiles: int, sms: int, max_pieces=None):
    """The grid of a persistent kernel of one block an SM over ``tiles``
    output tiles ``ktiles`` slabs deep (K1, K2, K4): whole tiles
    data-parallel if their last wave is at least Q4MM_FILL full, else
    stream-K over the (tile, slab) units on at most ``sms`` blocks, and at
    most ``max_pieces`` blocks a tile. (grid, stream_k)."""
    waves = -(-tiles // sms)
    if tiles >= Q4MM_FILL * waves * sms:
        return min(sms, tiles), False
    grid = min(sms, tiles * ktiles)
    if max_pieces is not None:
        grid = min(grid, tiles * max_pieces)
    return grid, True


def tile_ranges(tiles: int, ktiles: int, grid: int, stream_k: bool):
    """Each block's ranges [(tile, first slab, end slab, slot)] under
    ``tile_grid``'s plan: slot None for a whole tile, else the scratch slot
    (0: the block's first range, 1: its last) of a tile cut between
    blocks."""
    if stream_k:
        return stream_k_ranges(tiles, ktiles, grid)
    return [[(t, 0, ktiles, None) for t in range(b, tiles, grid)]
            for b in range(grid)]


def fused_gemv_split_plain(x, qt, blocks: int, norm_w=None, eps=1e-6,
                           impl: str = "auto", glu: int = 0, fault=None):
    """A streaming GEMV phase's decomposition (K1 / K9 at one row, K6 and
    K7 at every row count) on a grid of ``blocks`` blocks in plain tensor
    code: f32 partials of K9's integer arithmetic per (row, group) under the
    a8 values of ``impl``, else of the exact group sums s * (x . q) - z *
    sum(x); each block's ranges of 128-k units (``q4_stream_plan``, the
    same at every M: all rows ride in each unit), a tile shared among
    blocks added in block order (of k), as the last block of a tile adds
    them; rounded to x.dtype. ``glu`` > 0: x is a gate|up [M, >= 2 * glu]
    and the phase's x is silu(gate) * up (``mlp.silu_mul``'s bf16 values),
    which K6 / K7 form as the down phase stages each unit at one row and in
    a pass of their own at 2..32 rows -- elementwise, the same values either
    way. ``fault`` plants a fault the card tests
    must catch: "drop" leaves out the last unit of the first range whose
    tile is shared among blocks; "swap" swaps x's rows 0 and 1 (two rows of
    the mma's B operand) in the first unit."""
    if glu:
        g, u = x[:, :glu], x[:, glu:2 * glu]
        x = (F.silu(g.to(torch.float32)).to(u.dtype) * u)
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
    gpu = STREAM_UNIT // gs                           # groups a unit
    if fault == "swap":                               # rows 0, 1 of unit 0
        cols = slice(0, min(STREAM_BN, n))
        per_group[[0, 1], :gpu, cols] = per_group[[1, 0], :gpu, cols]
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    parts: dict = {}
    dropped = fault != "drop"
    for ranges in q4_stream_plan(n, k, blocks):
        for t, a, e, slot in ranges:
            if not dropped and slot is not None:
                e, dropped = e - 1, True
            cols = slice(t * STREAM_BN, min((t + 1) * STREAM_BN, n))
            s = per_group[:, a * gpu:e * gpu, cols].sum(dim=1)
            if slot is None:
                out[:, cols] = s
            else:
                parts.setdefault(t, []).append(s)
    for t, ps in parts.items():                       # in block order
        total = torch.zeros_like(ps[0])
        for s in ps:
            total = total + s
        out[:, t * STREAM_BN:min((t + 1) * STREAM_BN, n)] = total
    return out.to(x.dtype)


def fused_gemv_scratch(dev, m: int, widest_n: int, tickets: int = 0):
    """The split scratch of the streaming GEMV at m rows (K6 / K7, and K1 /
    K9 at one row), for a grid of at most 4 blocks an SM: partials for two
    ranges a block, m x STREAM_BN f32 each; tickets for the widest GEMV
    phase or ``tickets`` (K7's (batch row, kv head) pairs), whichever is
    more."""
    blocks = 4 * kernels.sm_count(dev)
    return gemv_scratch(dev, blocks * max(m, 1) * 2 * STREAM_BN,
                        max(tickets, -(-widest_n // GEMV_BN)))


def _gemv_launch(lib, x, qt, norm_w, norm_eps):
    m, k = x.shape
    n = qt.out_features
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    nsplit = 1
    if gemv_tc_route(m, qt.groupsize):
        nsplit = gemv_split_plan(n, k, kernels.sm_count(x.device))
        tiles = -(-n // GEMV_BN)
        part, ticket = gemv_scratch(
            x.device, tiles * nsplit * gemv_rows(m) * GEMV_BN, tiles)
    else:
        part, ticket = fused_gemv_scratch(x.device, 1, n)
    lib = kernels.scaled(lib, qt.scales)
    kernels.check(kernels.launcher(lib)(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), kernels.ptr(norm_w), kernels.ptr(qt.x_map),
        out.data_ptr(), kernels.ptr(part), kernels.ptr(ticket), m, k, n,
        qt.groupsize, nsplit, float(norm_eps), kernels.stream_of(x),
    ), lib)
    return out


# K1 at 2..32 rows on Hopper (csrc/q4_gemv_wg.cuh): tiles of Q4GV_BN weight
# columns, k in Q4GV_BK-deep slabs, x's rows in a row tile of 16 or 32
# (wgmma's N); 256 consumer threads, each of which leaves a quarter of the
# row tile's sums of x^2 beside its partial sums in a stream-K piece
Q4GV_BN, Q4GV_BK, Q4GV_ROW_TILES = 256, 64, (16, 32)
Q4GV_CONSUMERS = 256
# the most blocks a stream-K tile of K1 or K4 is cut among: its last block
# reads every piece back, so a narrow weight (one or two tiles) takes fewer
# blocks rather than a long combine
SPLIT_MAX_PIECES = 16


@dataclass(frozen=True)
class Q4GemvPlan:
    """K1's Hopper plan for an [m <= 32, k] x [k, n] GEMV on ``grid``
    blocks: one row tile of ``bm`` rows, tiles of Q4GV_BN columns, k in
    ``ktiles`` slabs of Q4GV_BK; whole tiles data-parallel (block b takes
    tiles b, b + grid, ...) or, under ``stream_k``, the tiles x ktiles
    (tile, slab) units shared out as contiguous ranges
    (``stream_k_ranges``)."""
    m: int
    n: int
    k: int
    bm: int
    grid: int
    stream_k: bool

    @property
    def tiles(self):
        return -(-self.n // Q4GV_BN)

    @property
    def ktiles(self):
        return -(-self.k // Q4GV_BK)

    @property
    def piece(self):
        """f32 of a stream-K piece: the partial sums, then the rows' sums
        of x^2 (csrc/q4_gemv_wg.cuh: Cfg::PIECE)."""
        return self.bm * Q4GV_BN + self.bm // 4 * Q4GV_CONSUMERS

    def ranges(self):
        """Each block's ranges (``tile_ranges``)."""
        return tile_ranges(self.tiles, self.ktiles, self.grid, self.stream_k)


@functools.lru_cache(maxsize=1024)
def q4_gemv_plan(m: int, n: int, k: int, sms: int) -> Q4GemvPlan:
    """K1's Hopper plan on a card of ``sms`` SMs (one block an SM): the row
    tile 16 or 32 (m padded to it), then whole column tiles data-parallel if
    their last wave is at least Q4MM_FILL full, else stream-K over (tile,
    slab) units, which fills the card whatever the tile count (every
    Llama-7B projection and its tp shards: 12-86 tiles), on at most
    SPLIT_MAX_PIECES blocks a tile."""
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"q4_gemv_plan takes 1..{GEMV_MAX_M} rows, got {m}")
    bm = next(t for t in Q4GV_ROW_TILES if m <= t)
    grid, stream_k = tile_grid(-(-n // Q4GV_BN), -(-k // Q4GV_BK), sms,
                               SPLIT_MAX_PIECES)
    return Q4GemvPlan(m, n, k, bm, grid, stream_k)


def q4_gemv_split_plain(x, qt, plan: Q4GemvPlan, norm_w=None, eps=1e-6,
                        drop=None):
    """K1's Hopper decomposition in plain tensor code: x staged as the kernel
    stages it (bf16(x * w) under the norm, gathered by x_map); per 32-deep
    half slab (one group each) the f32 products with the nibbles as 128 + q,
    folded as s * p - (zs + 128 s) * sum(x_half); each block's ranges of
    ``plan`` summed over their halves, a tile cut between blocks added from
    its pieces in block order (the order of k, as the tile's last block adds
    them); under the norm each row times 1 / sqrt(mean(x^2) + eps) last; one
    bf16 rounding. ``drop`` = (block, range index) leaves that range out (a
    planted fault the tests must see)."""
    m, k = x.shape
    n, gs = qt.out_features, qt.groupsize
    if (plan.m, plan.n, plan.k) != (m, n, k):
        raise ValueError(f"plan for {plan.m}x{plan.k}x{plan.n}, x {m}x{k}")
    f32 = torch.float32
    xf = x.to(f32)
    xs = xf if norm_w is None else (xf * norm_w.to(f32)).to(torch.bfloat16)
    xs = xs.to(torch.bfloat16).to(f32)
    if qt.x_map is not None:
        xs = xs.index_select(1, qt.x_map.to(torch.long))
    halves = k // 32
    xh = xs.reshape(m, halves, 32)
    q = unpack_qweight(qt.qweight).to(f32).reshape(halves, 32, n) + 128.0
    with full_f32_matmul():
        p = torch.einsum("mhk,hkn->hmn", xh, q)
    grp = torch.arange(halves, device=x.device) * 32 // gs
    s = qt.scales.to(f32)[grp][:, None, :]
    zc = 128.0 * s + qt.zscale.to(f32)[grp][:, None, :]
    contrib = s * p - zc * xh.sum(-1).t()[:, :, None]          # [H, m, n]
    out = torch.zeros((m, n), dtype=f32, device=x.device)
    parts: dict = {}
    for b, ranges in enumerate(plan.ranges()):
        for i, (t, kb, ke, slot) in enumerate(ranges):
            if drop == (b, i):
                continue
            cols = slice(t * Q4GV_BN, min((t + 1) * Q4GV_BN, n))
            piece = contrib[2 * kb:min(2 * ke, halves), :, cols].sum(dim=0)
            if slot is None:
                out[:, cols] = piece
            else:
                parts.setdefault(t, []).append(piece)
    for t, ps in parts.items():                       # in block order
        total = ps[0]
        for piece in ps[1:]:
            total = total + piece
        out[:, t * Q4GV_BN:min((t + 1) * Q4GV_BN, n)] = total
    if norm_w is not None:
        out = out * torch.rsqrt((xf * xf).sum(-1, keepdim=True) / k + eps)
    return out.to(x.dtype)


def q4_gemv_scratch(dev, plan: Q4GemvPlan):
    """K1's stream-K scratch (the GEMVs' per-device partials and tickets,
    grown to the plan's need and kept, so that a captured graph holds
    them): two pieces a block, one ticket a tile."""
    if not plan.stream_k:
        return gemv_scratch(dev, 0, 0)
    return gemv_scratch(dev, 2 * plan.grid * plan.piece, plan.tiles)


def _q4_gemv_wg(x, qt, norm_w, norm_eps):
    """K1's Hopper kernel on checked operands."""
    m, k = x.shape
    n = qt.out_features
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    plan = q4_gemv_plan(m, n, k, kernels.sm_count(x.device))
    part, ticket = q4_gemv_scratch(x.device, plan)
    lib = kernels.scaled("q4_gemv_wg", qt.scales)
    kernels.check(kernels.launcher(lib)(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), kernels.ptr(norm_w), kernels.ptr(qt.x_map),
        out.data_ptr(), part.data_ptr(), ticket.data_ptr(), m, k, n,
        qt.groupsize, plan.bm, plan.grid, int(plan.stream_k),
        float(norm_eps), kernels.stream_of(x),
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
    if gemv_tc_route(x.shape[0], qt.groupsize):
        out = _q4_gemv_wg(x, qt, norm_w, norm_eps)
    else:
        out = _gemv_launch("q4_gemv", x, qt, norm_w, norm_eps)
    count_launch(q4_gemv, qt)
    return out


q4_gemv.launches = q4_gemv.launches_f32 = 0


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
    count_launch(q4_gemv_a8, qt)
    return out


q4_gemv_a8.launches = q4_gemv_a8.launches_f32 = 0


# K2 (csrc/q4_wgmma.cuh): output tiles of a row tile chosen by M (wgmma's
# N) by a column tile, k in 64-deep slabs; the tiles it is built for
Q4MM_BK = 64
Q4MM_TILES = {64: 256, 128: 128, 256: 128}   # row tile -> column tile
Q4MM_TILE_ROWS = 64   # a tile's fixed work (its weight dequantized), in rows
Q4MM_FILL = 0.9       # stream-K below this share of the last wave filled


@dataclass(frozen=True)
class Q4MatmulPlan:
    """K2's plan for an [m, k] x [k, n] product on ``grid`` blocks: tiles
    of ``bm`` rows x ``bn`` columns, row tile fastest (tile t is row tile
    t % mtiles of column tile t // mtiles), ``ktiles`` slabs deep; whole
    tiles data-parallel (block b takes tiles b, b + grid, ...), or, under
    ``stream_k``, the tiles x ktiles (tile, slab) units shared out as
    contiguous ranges (``stream_k_ranges``)."""
    m: int
    n: int
    k: int
    bm: int
    bn: int
    grid: int
    stream_k: bool

    @property
    def mtiles(self):
        return -(-self.m // self.bm)

    @property
    def tiles(self):
        return self.mtiles * -(-self.n // self.bn)

    @property
    def ktiles(self):
        return -(-self.k // Q4MM_BK)

    def ranges(self):
        """Each block's ranges (``tile_ranges``)."""
        return tile_ranges(self.tiles, self.ktiles, self.grid, self.stream_k)


def q4_matmul_row_tile(m: int) -> int:
    """K2's row tile for m rows: the one of Q4MM_TILES with the least
    padded work, counting Q4MM_TILE_ROWS rows of fixed work a tile (each
    row tile dequantizes its weight columns again); the larger on a tie."""
    return min(Q4MM_TILES,
               key=lambda bm: (-(-m // bm) * (bm + Q4MM_TILE_ROWS), -bm))


@functools.lru_cache(maxsize=1024)
def q4_matmul_plan(m: int, n: int, k: int, sms: int) -> Q4MatmulPlan:
    """K2's plan on a card of ``sms`` SMs (one block an SM): the tile by M
    (64 x 256 up to 64 rows: each x slab serves twice the weight columns
    where the weight's bytes bound the time), then whole tiles
    data-parallel if their last wave is at least Q4MM_FILL full (the
    blocks in flight then share their weight columns and x in L2), else
    stream-K over (tile, slab) units, which fills the card whatever the
    tile count (M <= 256 on o and down, the tp shards)."""
    bm = q4_matmul_row_tile(m)
    bn = Q4MM_TILES[bm]
    grid, stream_k = tile_grid(-(-m // bm) * -(-n // bn), -(-k // Q4MM_BK),
                               sms)
    return Q4MatmulPlan(m, n, k, bm, bn, grid, stream_k)


def q4_dequant_matmul_split_plain(x, qt, plan: Q4MatmulPlan, drop=None):
    """K2's decomposition in plain tensor code: the bf16 dequantized weight
    (``_q4_matmul_plain``'s), each block's ranges of ``plan`` as f32
    products over their slabs' k, a tile cut between blocks added from
    its pieces in block order (the order of k, as the tile's last block
    adds them), one bf16 rounding. ``drop`` = (block, range index) leaves
    that range out (a planted fault the tests must see)."""
    m, k = x.shape
    n = qt.out_features
    if (plan.m, plan.n, plan.k) != (m, n, k):
        raise ValueError(f"plan for {plan.m}x{plan.k}x{plan.n}, x {m}x{k}")
    w = dequantize_t(qt, torch.bfloat16).to(torch.float32)
    xf = x.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    parts: dict = {}
    for b, ranges in enumerate(plan.ranges()):
        for i, (t, kb, ke, slot) in enumerate(ranges):
            if drop == (b, i):
                continue
            r0, c0 = (t % plan.mtiles) * plan.bm, (t // plan.mtiles) * plan.bn
            rows = slice(r0, min(r0 + plan.bm, m))
            cols = slice(c0, min(c0 + plan.bn, n))
            ks = slice(kb * Q4MM_BK, min(ke * Q4MM_BK, k))
            with full_f32_matmul():
                p = xf[rows, ks] @ w[ks, cols]
            if slot is None:
                out[rows, cols] = p
            else:
                parts.setdefault(t, []).append((rows, cols, p))
    for pieces in parts.values():
        rows, cols, total = pieces[0]
        for _, _, p in pieces[1:]:
            total = total + p
        out[rows, cols] = total
    return out.to(x.dtype)


def q4_matmul_scratch(dev, plan: Q4MatmulPlan):
    """K2's stream-K scratch (the GEMVs' per-device partials and tickets,
    grown to the plan's need and kept, so that a captured graph holds
    them): two [bm, bn] f32 slots a block, one ticket a tile."""
    if not plan.stream_k:
        return gemv_scratch(dev, 0, 0)
    return gemv_scratch(dev, 2 * plan.grid * plan.bm * plan.bn, plan.tiles)


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
    n = qt.out_features
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    plan = q4_matmul_plan(m, n, k, kernels.sm_count(x.device))
    part, ticket = q4_matmul_scratch(x.device, plan)
    lib = kernels.scaled("q4_matmul", qt.scales)
    kernels.check(kernels.launcher(lib)(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), out.data_ptr(), part.data_ptr(),
        ticket.data_ptr(), m, k, n, qt.groupsize, plan.bm, plan.bn,
        plan.grid, int(plan.stream_k), kernels.stream_of(x),
    ), lib)
    count_launch(q4_dequant_matmul, qt)
    return out


q4_dequant_matmul.launches = q4_dequant_matmul.launches_f32 = 0


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
    lib = kernels.scaled("q4_matmul_glu", qt.scales)
    kernels.check(kernels.launcher(lib)(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), out.data_ptr(), m, ni, qt.out_features,
        qt.groupsize, w_in, ou, kernels.stream_of(x),
    ), lib)
    count_launch(q4_matmul_glu, qt)
    return out


q4_matmul_glu.launches = q4_matmul_glu.launches_f32 = 0


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
    lib = kernels.scaled("q4_prefill_a8", qt.scales)
    kernels.check(kernels.launcher(lib)(
        x.data_ptr(), qt.qweight.data_ptr(), qt.scales.data_ptr(),
        qt.zscale.data_ptr(), ws.data_ptr(), xq.data_ptr(), sx.data_ptr(),
        out.data_ptr(), m, k, qt.out_features, qt.groupsize,
        kernels.stream_of(x),
    ), lib)
    count_launch(q4_prefill_a8, qt)
    return out


q4_prefill_a8.launches = q4_prefill_a8.launches_f32 = 0


def q4_matmul(
    x: torch.Tensor,
    qt: QuantTensor,
    impl: str = "auto",
    norm_w: "torch.Tensor | None" = None,
    norm_eps: float = 1e-6,
    glu: "tuple[int, int] | None" = None,
    lora: "tuple[torch.Tensor, torch.Tensor] | None" = None,
) -> torch.Tensor:
    """``[rms_norm](x) @ dequant(qt)``; x [..., in_features] bf16 ->
    [..., out_features] bf16. Dispatches by ``impl`` and M = prod(leading
    dims) as the module docstring says (quant.py:_q4_matmul_pallas without
    its TPU block choosers).

    ``glu=(ni, ou)``: x is the raw fused gate|up output [..., W] and the
    product runs over silu(x[..., :ni]) * x[..., ou:ou+ni]; in the kernel
    (K12) at M > 32 without act-order and outside "pallas_a8t", formed up
    front otherwise. Composes with neither ``norm_w`` nor act-order fusion.
    ``impl="xla"``: the plain path on any device, no kernel.

    ``lora=(A, B)``: a LoRA adapter's low-rank term ``lora_delta(x, lora)``
    added to the kernel's output (quant.py:1717-1718). The adapter consumes
    x as given, so it composes with neither ``norm_w`` (norm first) nor
    ``glu``.
    """
    impl = check_matmul_impl(impl)
    if lora is not None and (norm_w is not None or glu is not None):
        raise ValueError("q4_matmul: lora composes with neither norm_w nor "
                         "glu (norm first)")
    if glu is not None:
        ni, ou = glu
        if norm_w is not None or ou + ni > x.shape[-1]:
            raise ValueError(f"glu {glu} with x {tuple(x.shape)}, norm_w "
                             f"{'set' if norm_w is not None else 'None'}")
        *lead, w_in = x.shape
        x2 = x.reshape(-1, w_in)
        if (x2.shape[0] > GEMV_MAX_M and qt.x_map is None
                and impl not in ("xla", "pallas_a8t") and qt.in_features == ni
                and ou % 8 == 0 and w_in % 8 == 0):
            return q4_matmul_glu(x2, qt, ni, ou).reshape(
                *lead, qt.out_features)
        x = glu_silu_mul(x, ni, ou)
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if impl == "xla":
        out = q4_gemv_plain(x2, qt, norm_w, norm_eps)
    elif x2.shape[0] <= GEMV_MAX_M:
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
    out = out.reshape(*lead, qt.out_features)
    if lora is not None:
        out = out + lora_delta(x, lora)
    return out


def lora_delta(x: torch.Tensor, lora) -> torch.Tensor:
    """The low-rank LoRA term ``x @ A @ B`` (quant.py:1722-1744), in x's
    dtype. A / B are [in, r] / [r, out] (one adapter for the whole batch)
    or [B, in, r] / [B, r, out] (one adapter a batch row; zero rows: a row
    without an adapter) for x [B, T, in]. Each product accumulates in f32
    and is rounded to x's dtype, as the JAX function's
    ``preferred_element_type=f32`` dots. Plain tensor code on every device:
    the JAX package computes it outside its kernels too."""
    a, b = lora
    f32 = torch.float32
    a = a.to(x.dtype).to(f32)
    b = b.to(x.dtype).to(f32)
    if a.dim() == 2:
        xr = torch.matmul(x.to(f32), a).to(x.dtype)
        return torch.matmul(xr.to(f32), b).to(x.dtype)
    xr = torch.einsum("bti,bir->btr", x.to(f32), a).to(x.dtype)
    return torch.einsum("btr,bro->bto", xr.to(f32), b).to(x.dtype)
