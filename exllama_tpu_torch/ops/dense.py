"""Dense bf16 matmul for the lm_head (port of exllama_tpu/ops/dense.py).

Kernel K4 ``dense_gemv`` (csrc/dense_gemv.cu, csrc/dense_wg.cuh), the port
of the TPU's ``dense.py:_kernel``, takes every row count on the card: the
JAX package leaves more than 32 rows to ``jnp.dot``, which the port's rule
(a kernel's plain version runs on the card only where ``"xla"`` names it)
gives to K4 too (``dense_plan``: the row tile by M, stream-K where the
tiles do not fill the card). CPU tensors keep the plain product at every M.
The greedy head ``head_argmax`` (final norm -> lm_head -> argmax, no logits
kept) is kernel K5 (csrc/head_argmax.cu), the port of
``dense.py:_head_argmax_kernel``, on K4's Hopper kernel (csrc/dense_wg.cuh,
K4's plan) with the norm staged into each x slab and an argmax epilogue, at
<= 32 rows; above, the JAX package's composition (dense.py:183-188) with K4
for the product. Both take any vocabulary size. The stream-K loop of
csrc/dense_stream.cuh, K4's and K5's kernel before the Hopper one, stays as
their parents (``dense_grid``, ``dense_stream_plan``,
``dense_gemv_split_plain`` write its decomposition).
``impl="xla"`` (the model's ``matmul_impl``) runs the plain versions on any
device, as the JAX package sends its head to ``jnp.dot`` under "xla": an
oracle, never a fallback.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from exllama_tpu_torch import kernels
from exllama_tpu_torch.config import check_matmul_impl
from exllama_tpu_torch.ops import full_f32_matmul
from exllama_tpu_torch.ops.norms import rms_norm
from exllama_tpu_torch.ops.quant import (
    SPLIT_MAX_PIECES,
    gemv_scratch,
    stream_k_ranges,
    tile_grid,
    tile_ranges,
)

GEMV_MAX_M = 32   # the JAX package's switch (a TPU number): K5's rows
# the parents' loop (csrc/dense_stream.cuh; K4's and K5's before the Hopper
# kernel): tiles of
# DENSE_BN columns, units of DENSE_ROWS rows of k, shared out as contiguous
# ranges among one block an SM
DENSE_BN, DENSE_ROWS = 256, 32
# K4 on Hopper (csrc/dense_wg.cuh): tiles of a row tile (wgmma's N, by M) by
# DWG_BN columns, k in DWG_BK-deep slabs
DWG_BN, DWG_BK, DWG_ROW_TILES = 256, 64, (8, 32, 64)


def dense_gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] bf16 @ w [K, V] bf16 -> f32 [M, V], f32 accumulation."""
    with full_f32_matmul():
        return x.to(torch.float32) @ w.to(torch.float32)


def _pow2(m: int) -> int:
    """The rows K4 pads m to (common.cuh:pick_mb): a power of two."""
    return 1 << (m - 1).bit_length()


def dense_grid(k: int, v: int, sms: int) -> "tuple[int, int]":
    """The parents' (K4's and K5's stream-K loop) column tiles and grid: one
    block an SM, fewer where there are fewer (tile, unit) items."""
    tiles = -(-v // DENSE_BN)
    return tiles, min(sms, tiles * -(-k // DENSE_ROWS))


def dense_stream_plan(k: int, v: int, grid: int):
    """The parents' work division (csrc/dense_stream.cuh) written out: for
    each
    block, its ranges [(tile, first unit, end unit, slot)], units counted
    within the tile; slot 0 / 1 is the scratch slot of a range that shares
    its tile with other blocks (the block's first / last range), None for a
    whole tile."""
    return stream_k_ranges(-(-v // DENSE_BN), -(-k // DENSE_ROWS), grid)


def dense_gemv_split_plain(x: torch.Tensor, w: torch.Tensor,
                           grid: int) -> torch.Tensor:
    """The stream-K loop's decomposition (K4's and K5's parents) in plain
    tensor code, f32: each block's range sums over its units, a tile shared
    among blocks then added in the order of its blocks (of k), as the
    kernel's last block does."""
    m, k = x.shape
    v = w.shape[1]
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    out = torch.empty((m, v), dtype=torch.float32)
    parts: dict = {}
    with full_f32_matmul():
        for ranges in dense_stream_plan(k, v, grid):
            for t, a, e, slot in ranges:
                cols = slice(t * DENSE_BN, min((t + 1) * DENSE_BN, v))
                rows = slice(a * DENSE_ROWS, min(e * DENSE_ROWS, k))
                s = xf[:, rows] @ wf[rows, cols]
                if slot is None:
                    out[:, cols] = s
                else:
                    parts.setdefault(t, []).append(s)
    for t, ps in parts.items():
        total = torch.zeros_like(ps[0])
        for s in ps:
            total = total + s
        out[:, t * DENSE_BN:min((t + 1) * DENSE_BN, v)] = total
    return out


@dataclass(frozen=True)
class DensePlan:
    """K4's plan for an [m, k] x [k, v] product on ``grid`` blocks: tiles
    of ``bm`` rows x DWG_BN columns, row tile fastest (tile t is row tile
    t % mtiles of column tile t // mtiles), ``ktiles`` slabs of DWG_BK;
    whole tiles data-parallel (block b takes tiles b, b + grid, ...) or,
    under ``stream_k``, the tiles x ktiles (tile, slab) units shared out as
    contiguous ranges (``stream_k_ranges``)."""
    m: int
    k: int
    v: int
    bm: int
    grid: int
    stream_k: bool

    @property
    def mtiles(self):
        return -(-self.m // self.bm)

    @property
    def tiles(self):
        return self.mtiles * -(-self.v // DWG_BN)

    @property
    def ktiles(self):
        return -(-self.k // DWG_BK)

    def ranges(self):
        """Each block's ranges (``quant.tile_ranges``)."""
        return tile_ranges(self.tiles, self.ktiles, self.grid, self.stream_k)


@functools.lru_cache(maxsize=1024)
def dense_plan(m: int, k: int, v: int, sms: int) -> DensePlan:
    """K4's plan on a card of ``sms`` SMs (one block an SM): the row tile
    8, 32 or 64 (the least of DWG_ROW_TILES that holds m, 64 above: more
    rows take more row tiles), then whole tiles data-parallel if their last
    wave is at least Q4MM_FILL full (a perplexity chunk), else stream-K
    over (tile, slab) units, which fills the card whatever the tile count,
    on at most SPLIT_MAX_PIECES blocks a tile (a narrow vocabulary; the
    Llama vocabulary's 125 column tiles at V = 32000 fill the card)."""
    bm = next((t for t in DWG_ROW_TILES if m <= t), DWG_ROW_TILES[-1])
    grid, stream_k = tile_grid(-(-m // bm) * -(-v // DWG_BN),
                               -(-k // DWG_BK), sms, SPLIT_MAX_PIECES)
    return DensePlan(m, k, v, bm, grid, stream_k)


def dense_split_plain(x: torch.Tensor, w: torch.Tensor, plan: DensePlan,
                      drop=None) -> torch.Tensor:
    """K4's decomposition in plain tensor code, f32: each block's ranges of
    ``plan`` as f32 products over their slabs' k, a tile cut between blocks
    added from its pieces in block order (the order of k, as the tile's
    last block adds them). ``drop`` = (block, range index) leaves that range
    out (a planted fault the tests must see)."""
    m, k = x.shape
    v = w.shape[1]
    if (plan.m, plan.k, plan.v) != (m, k, v):
        raise ValueError(f"plan for {plan.m}x{plan.k}x{plan.v}, x {m}x{k}")
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    out = torch.zeros((m, v), dtype=torch.float32, device=x.device)
    parts: dict = {}
    for b, ranges in enumerate(plan.ranges()):
        for i, (t, kb, ke, slot) in enumerate(ranges):
            if drop == (b, i):
                continue
            r0, c0 = (t % plan.mtiles) * plan.bm, (t // plan.mtiles) * DWG_BN
            rows = slice(r0, min(r0 + plan.bm, m))
            cols = slice(c0, min(c0 + DWG_BN, v))
            ks = slice(kb * DWG_BK, min(ke * DWG_BK, k))
            with full_f32_matmul():
                piece = xf[rows, ks] @ wf[ks, cols]
            if slot is None:
                out[rows, cols] = piece
            else:
                parts.setdefault(t, []).append((rows, cols, piece))
    for pieces in parts.values():
        rows, cols, total = pieces[0]
        for _, _, piece in pieces[1:]:
            total = total + piece
        out[rows, cols] = total
    return out


def dense_scratch(dev, plan: DensePlan):
    """K4's stream-K scratch (the GEMVs' per-device partials and tickets,
    grown to the plan's need and kept, so that a captured graph holds
    them): two [bm, DWG_BN] f32 slots a block, one ticket a tile."""
    if not plan.stream_k:
        return gemv_scratch(dev, 0, 0)
    return gemv_scratch(dev, 2 * plan.grid * plan.bm * DWG_BN, plan.tiles)


def dense_gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4: x [M, K] bf16 @ w [K, V] bf16 -> f32 [M, V], any M."""
    if x.device.type == "cpu":
        return dense_gemv_plain(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"dense_gemv: unsupported device {x.device}")
    m, k = x.shape
    v = w.shape[1]
    if w.shape[0] != k or 0 in (m, k, v):
        raise ValueError(f"dense_gemv: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("dense_gemv takes bf16 x and w")
    if not w.is_contiguous() or w.device != x.device:
        raise ValueError("dense_gemv: w must be contiguous, on x's device")
    x = x.contiguous()
    ldx = -(-k // 8) * 8        # TMA reads x's rows: 16-byte strides
    if ldx != k or x.data_ptr() % 16:
        x = F.pad(x, (0, ldx - k))
    plan = dense_plan(m, k, v, kernels.sm_count(x.device))
    part, ticket = dense_scratch(x.device, plan)
    out = torch.empty((m, v), dtype=torch.float32, device=x.device)
    kernels.check(kernels.launcher("dense_gemv")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(),
        ticket.data_ptr(), m, k, v, ldx, plan.bm, plan.grid,
        int(plan.stream_k), kernels.stream_of(x),
    ), "dense_gemv")
    dense_gemv.launches += 1
    return out


dense_gemv.launches = 0


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """x [..., K] @ w [K, N] with f32 output; ``impl="xla"``: plain. K4 on
    the card at any row count; on the CPU the plain product (as K4's plain
    version up to 32 rows)."""
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if ((x2.shape[0] <= GEMV_MAX_M or x2.device.type == "cuda")
            and check_matmul_impl(impl) != "xla"):
        out = dense_gemv(x2.to(w.dtype), w)
    else:
        out = dense_gemv_plain(x2, w)
    return out.reshape(*lead, w.shape[1])


def head_argmax_plain(h: torch.Tensor, norm_w: torch.Tensor, w: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """rms_norm(h) @ w -> argmax (earliest index on ties), int32 [M]."""
    x = rms_norm(h.reshape(-1, h.shape[-1]), norm_w, eps)
    return torch.argmax(dense_gemv_plain(x, w), dim=-1).to(torch.int32)


def argmax_keys(logits: torch.Tensor) -> torch.Tensor:
    """K5's 64-bit key of every f32 logit [M, V] (csrc/head_argmax.cu:
    argmax_key), as int64 shifted by 2^63 so that signed order is the
    kernel's unsigned order: an order-preserving image of the value in the
    high half (-0 as +0), ~index in the low half (the earliest index of
    equal values is the largest key)."""
    v = torch.where(logits == 0, torch.zeros_like(logits), logits)
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    img = torch.where(bits >= 1 << 31, 0xFFFFFFFF - bits, bits | 1 << 31)
    idx = torch.arange(logits.shape[-1], dtype=torch.int64,
                       device=logits.device)
    return (img - (1 << 31)) * (1 << 32) + (0xFFFFFFFF - idx)


def ids_of_keys(keys: torch.Tensor) -> torch.Tensor:
    """The token ids of K5's keys: the low half inverted."""
    return (0xFFFFFFFF - (keys & 0xFFFFFFFF)).to(torch.int32)


def head_argmax_split_plain(h: torch.Tensor, norm_w: torch.Tensor,
                            w: torch.Tensor, eps: float,
                            plan: DensePlan) -> torch.Tensor:
    """K5's decomposition in plain tensor code: the normed rows rounded to
    bf16, K4's split sums over ``plan`` (``dense_split_plain``: a split
    tile's pieces added in the order of k), each column's 64-bit key
    emitted once by the block that finishes its tile, each block's best
    key per row and the max of the blocks' keys, as the kernel's atomicMax
    combines them. Which block finishes a split tile does not change the
    max. int32 ids [M]."""
    x = rms_norm(h.reshape(-1, h.shape[-1]), norm_w, eps)
    keys = argmax_keys(dense_split_plain(x, w, plan))
    return ids_of_keys(keys.amax(dim=1))


_HEAD_KEYS: dict = {}


def head_argmax_scratch(dev) -> torch.Tensor:
    """K5's keys (32) and grid ticket, int64 [33] zeros, per device: every
    launch leaves them zero (its last block resets them). Allocated at the
    first launch on a device, which must not be under capture."""
    keys = _HEAD_KEYS.get(dev)
    if keys is None:
        kernels.no_growth_under_capture("K5's keys")
        keys = _HEAD_KEYS[dev] = torch.zeros((GEMV_MAX_M + 1,),
                                             dtype=torch.int64, device=dev)
    return keys


def _head_argmax_rows(x: torch.Tensor, norm_w: torch.Tensor, w: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """K5 on x [M <= 32, K] bf16 -> int32 [M], on K4's plan
    (``dense_plan``)."""
    m, k = x.shape
    v = w.shape[1]
    if w.shape[0] != k or norm_w.shape != (k,) or 0 in (m, k, v):
        raise ValueError(f"head_argmax: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("head_argmax takes bf16 x and w")
    if not w.is_contiguous() or w.device != x.device:
        raise ValueError("head_argmax: w must be contiguous, on x's device")
    x = x.contiguous()
    ldx = -(-k // 8) * 8        # TMA reads x's rows: 16-byte strides
    if ldx != k or x.data_ptr() % 16:
        x = F.pad(x, (0, ldx - k))
    norm_w = norm_w.to(torch.bfloat16).contiguous()
    plan = dense_plan(m, k, v, kernels.sm_count(x.device))
    part, ticket = dense_scratch(x.device, plan)
    ids = torch.empty((m,), dtype=torch.int32, device=x.device)
    kernels.check(kernels.launcher("head_argmax")(
        x.data_ptr(), norm_w.data_ptr(), w.data_ptr(),
        head_argmax_scratch(x.device).data_ptr(), ids.data_ptr(),
        part.data_ptr(), ticket.data_ptr(), m, k, v, ldx, plan.bm, plan.grid,
        int(plan.stream_k), float(eps), kernels.stream_of(x),
    ), "head_argmax")
    head_argmax.launches += 1
    return ids


def head_argmax(h: torch.Tensor, norm_w: torch.Tensor, w: torch.Tensor,
                eps: float, impl: str = "auto") -> torch.Tensor:
    """Greedy head: rms_norm -> lm_head GEMV -> argmax, no logits kept.

    h [B, T, hidden] (or [B, hidden]) -> int32 token ids [B, T] (or [B, 1]).
    K5 for CUDA tensors with B*T <= 32; for more rows on the card the JAX
    package's composition (dense.py:183-188): rms_norm, K4, argmax; the
    plain composition for CPU tensors and under ``impl="xla"``."""
    *lead, k = h.shape
    b = lead[0] if lead else 1
    x = h.reshape(-1, k)
    if h.device.type == "cpu" or check_matmul_impl(impl) == "xla":
        ids = head_argmax_plain(x, norm_w, w, eps)
    elif h.device.type != "cuda":
        raise RuntimeError(f"head_argmax: unsupported device {h.device}")
    elif x.shape[0] > GEMV_MAX_M:
        logits = dense_gemv(rms_norm(x, norm_w, eps).to(w.dtype), w)
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        ids = _head_argmax_rows(x, norm_w, w, eps)
    return ids.reshape(b, -1)


head_argmax.launches = 0
