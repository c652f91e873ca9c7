"""GPTQ tensor format and the port's on-device quantized-matrix layout.

GPTQ checkpoints store, per linear layer:

  * ``qweight``  int32 [K/8,  N]   -- 8 4-bit weights per word packed along K:
                                     bits 4*i of qweight[r, n] hold W[r*8+i, n]
  * ``qzeros``   int32 [K/gs, N/8] -- 8 4-bit zero-points per word packed along
                                     N; the stored value is zero-1, so
                                     w = (q - (z+1)) * s
  * ``scales``   fp16  [K/gs, N]
  * ``g_idx``    int32 [K]         -- act-order models only: group of each row

The port keeps GPTQ's K-packed qweight as its own layout: a warp reading one
int32 per output column reads 128 contiguous bytes, which is what the Hopper
kernels want, so a checkpoint without act-order loads with no repack at all.
Act-order rows are sorted group-sequential at load and the activation is
permuted by ``x_map`` instead. The zero-point is folded into
``zscale = (z+1)*s``, computed in f32 and rounded once to the scale dtype
(bf16 by default, or f32: ``TuningParams.scale_dtype``), so the dequantized
weights ``q*s - zscale`` are bit-identical to the JAX package's under the
same ``scale_dtype``.

Host-side helpers work on numpy arrays; ``QuantTensor`` holds torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# GPTQ wire-format pack/unpack (host, numpy)
# ---------------------------------------------------------------------------


def unpack_gptq_qweight(qweight: np.ndarray) -> np.ndarray:
    """int32 [K/8, N] -> uint8 [K, N] of 4-bit values (row-packed)."""
    assert qweight.dtype == np.int32 and qweight.ndim == 2
    kw, n = qweight.shape
    w = qweight.astype(np.uint32)
    out = np.empty((kw, 8, n), dtype=np.uint8)
    for i in range(8):
        out[:, i, :] = (w >> (4 * i)) & 0xF
    return out.reshape(kw * 8, n)


def pack_gptq_qweight(q: np.ndarray) -> np.ndarray:
    """uint8 [K, N] of 4-bit values -> int32 [K/8, N] (row-packed)."""
    k, n = q.shape
    assert k % 8 == 0
    q = q.reshape(k // 8, 8, n).astype(np.uint32)
    out = np.zeros((k // 8, n), dtype=np.uint32)
    for i in range(8):
        out |= (q[:, i, :] & 0xF) << (4 * i)
    return out.astype(np.int32)


def unpack_gptq_qzeros(qzeros: np.ndarray) -> np.ndarray:
    """int32 [G, N/8] -> uint8 [G, N] of stored zero-points (column-packed)."""
    assert qzeros.dtype == np.int32 and qzeros.ndim == 2
    g, nw = qzeros.shape
    z = qzeros.astype(np.uint32)
    out = np.empty((g, nw, 8), dtype=np.uint8)
    for i in range(8):
        out[:, :, i] = (z >> (4 * i)) & 0xF
    return out.reshape(g, nw * 8)


def pack_gptq_qzeros(z: np.ndarray) -> np.ndarray:
    """uint8 [G, N] -> int32 [G, N/8] (column-packed)."""
    g, n = z.shape
    assert n % 8 == 0
    z = z.reshape(g, n // 8, 8).astype(np.uint32)
    out = np.zeros((g, n // 8), dtype=np.uint32)
    for i in range(8):
        out |= (z[:, :, i] & 0xF) << (4 * i)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Act-order -> sequential rows + activation permutation
# ---------------------------------------------------------------------------


def make_sequential(
    q: np.ndarray, g_idx: np.ndarray, groupsize: int
) -> tuple[np.ndarray, np.ndarray]:
    """Reorder rows of the unpacked weight so groups are sequential.

    Returns (q_sequential, x_map) with ``q_sequential[i] = q[x_map[i]]``;
    the activation is permuted the same way: ``x[..., x_map] @ W_seq ==
    x @ W``.
    """
    k = q.shape[0]
    assert g_idx.shape == (k,)
    counts = np.bincount(g_idx, minlength=(k + groupsize - 1) // groupsize)
    if not np.all(counts[: k // groupsize] == groupsize):
        raise ValueError("g_idx does not assign exactly groupsize rows/group")
    x_map = np.argsort(g_idx, kind="stable").astype(np.int32)
    return q[x_map], x_map


# The JAX package's npair layout (int32 [K/4, N_pad/2], columns padded to
# 1024): kept only to convert JAX-built parameters (loader.params_from_jax).
_NPAIR_ALIGN = 1024


def unpack_npair(words: np.ndarray, n: Optional[int] = None) -> np.ndarray:
    """JAX npair layout int32 [K/4, N_pad/2] -> uint8 [K, N]."""
    kw, npk = words.shape
    k = kw * 4
    n_pad = npk * 2
    half = _NPAIR_ALIGN // 2
    w = words.astype(np.uint32)
    bts = np.empty((k, npk), np.uint8)
    for j in range(4):
        bts[j::4] = (w >> (8 * j)) & 0xFF
    nb = n_pad // _NPAIR_ALIGN
    lo = (bts & 0x0F).reshape(k, nb, half)
    hi = (((bts >> 4) & 0x0F) ^ 8).reshape(k, nb, half)
    q = np.stack([lo, hi], axis=2).reshape(k, n_pad)
    return q[:, :n] if n is not None else q


def npair_padded_n(n: int) -> int:
    """Stored width of an N-column tensor in the JAX npair layout."""
    return -(-n // _NPAIR_ALIGN) * _NPAIR_ALIGN


# ---------------------------------------------------------------------------
# QuantTensor -- one quantized linear layer on the device
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantTensor:
    """A quantized (in_features x out_features) matrix.

    Dequantization of row k (group g = k // groupsize), column n:
        w[k, n] = q[k, n] * scales[g, n] - zscale[g, n]
    Rows are group-sequential; act-order tensors carry ``x_map`` and the
    activation is gathered by it (``x[..., x_map]``) before the product.
    """

    qweight: torch.Tensor            # int32 [K/8, N], GPTQ K-packed nibbles
    scales: torch.Tensor             # bf16 or f32 [K/gs, N]
    zscale: torch.Tensor             # as scales [K/gs, N] = (stored_zero+1)*scales
    x_map: Optional[torch.Tensor]    # int32 [K] or None
    groupsize: int
    # turbo prefill (with_w8 / with_w8_scale): the weight re-quantized per
    # column to int8, w ~ w8.t() * w8_scale, K-major (row n of w8 is column n
    # of the weight); k in the stored (sequential) order
    w8: Optional[torch.Tensor] = None         # int8 [N, K]
    w8_scale: Optional[torch.Tensor] = None   # f32  [N]

    @property
    def in_features(self) -> int:
        return self.qweight.shape[0] * 8

    @property
    def out_features(self) -> int:
        return self.qweight.shape[1]

    @property
    def act_order(self) -> bool:
        return self.x_map is not None

    @property
    def device(self) -> torch.device:
        return self.qweight.device

    def to(self, device) -> "QuantTensor":
        def mv(t):
            return None if t is None else t.to(device)

        return QuantTensor(
            qweight=mv(self.qweight), scales=mv(self.scales),
            zscale=mv(self.zscale), x_map=mv(self.x_map),
            groupsize=self.groupsize, w8=mv(self.w8),
            w8_scale=mv(self.w8_scale),
        )


SCALE_TORCH_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _store(a: np.ndarray, dtype=torch.bfloat16) -> torch.Tensor:
    """f32 numpy -> torch ``dtype``, rounded to nearest even once."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def load_quant_tensor(
    qweight: np.ndarray,
    qzeros: np.ndarray,
    scales: np.ndarray,
    g_idx: Optional[np.ndarray] = None,
    device="cpu",
    scale_dtype: str = "bf16",
) -> QuantTensor:
    """Build a :class:`QuantTensor` from GPTQ wire-format tensors.

    Groupsize is inferred from the qweight/qzeros shapes. An all-trivial
    g_idx (sequential groups) is treated as absent. ``scale_dtype`` ("bf16"
    or "f32") is the storage type of scales and zscale.
    """
    k = qweight.shape[0] * 8
    n = qweight.shape[1]
    groups = qzeros.shape[0]
    if k % groups:
        raise ValueError("qweight rows not divisible by zero-point groups")
    groupsize = k // groups
    if scales.shape != (groups, n):
        raise ValueError(f"scales shape {scales.shape} != {(groups, n)}")

    if g_idx is not None:
        g_idx = np.asarray(g_idx)
        if np.array_equal(g_idx, np.arange(k) // groupsize):
            g_idx = None

    x_map = None
    words = np.asarray(qweight, np.int32)
    if g_idx is not None:
        q, x_map = make_sequential(
            unpack_gptq_qweight(words), g_idx, groupsize
        )
        words = pack_gptq_qweight(q)
    z = unpack_gptq_qzeros(np.asarray(qzeros, np.int32)).astype(np.float32)
    s32 = np.asarray(scales).astype(np.float32)
    sdt = SCALE_TORCH_DTYPES[scale_dtype]
    return QuantTensor(
        qweight=torch.from_numpy(np.ascontiguousarray(words)).to(device),
        scales=_store(s32, sdt).to(device),
        zscale=_store((z + 1.0) * s32, sdt).to(device),   # round once, at store
        x_map=None if x_map is None else torch.from_numpy(x_map).to(device),
        groupsize=groupsize,
    )


def unpack_qweight(qweight: torch.Tensor) -> torch.Tensor:
    """int32 [K/8, N] -> int32 [K, N] of 4-bit values, on qweight's device."""
    kw, n = qweight.shape
    shifts = torch.arange(0, 32, 4, device=qweight.device, dtype=torch.int32)
    q = (qweight[:, None, :] >> shifts[None, :, None]) & 0xF
    return q.reshape(kw * 8, n)


def dequantize_t(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize on qt's device -> [K, N]: q*s - zscale in f32, then cast
    (the scales broadcast over each group's rows)."""
    gs = qt.groupsize
    q = unpack_qweight(qt.qweight).to(torch.float32)
    k, n = q.shape
    s = qt.scales.to(torch.float32)[:, None, :]
    zs = qt.zscale.to(torch.float32)[:, None, :]
    return (q.view(k // gs, gs, n) * s - zs).reshape(k, n).to(dtype)


def dequantize(qt: QuantTensor) -> np.ndarray:
    """Host-side full dequantization -> f32 [K, N]. Test/validation oracle.

    Rows are in sequential order; for act-order tensors the caller permutes
    the activation by ``x_map`` (not the output of this).
    """
    return dequantize_t(qt.to("cpu"), torch.float32).numpy()


def w8_col_scale(qt: QuantTensor) -> torch.Tensor:
    """Per-column int8 re-quantization scale max(colmax, 1e-20)/127 of the
    f32 dequantized weight, f32 [N] (exllama_tpu formats/gptq._build_w8 and
    ops/quant._w8_col_scale: one formula for the image and for the
    in-kernel requant)."""
    amax = dequantize_t(qt, torch.float32).abs().amax(dim=0)
    return amax.clamp_min(1e-20) * (1.0 / 127.0)


def with_w8_scale(qt: QuantTensor) -> QuantTensor:
    """Attach only the column scales (4 bytes a column): the in-kernel
    requant of turbo prefill (K10) then skips its per-call dequantize and
    reduce."""
    if qt.w8_scale is not None:
        return qt
    return dataclasses.replace(qt, w8_scale=w8_col_scale(qt))


W8_CHUNK = 2048     # columns dequantized at a time while an image is built


def with_w8(qt: QuantTensor) -> QuantTensor:
    """Attach the resident int8 image for turbo prefill (K11): the f32
    dequantized weight re-quantized per column, clip(round(w / scale),
    +-127), stored K-major as w8 [N, K] (the JAX image transposed), the
    layout the kernel copies into its tensor-core tiles as it is. Load-time
    plain tensor code on qt's device, W8_CHUNK columns at a time, so the f32
    temporary stays K x W8_CHUNK; costs K*N bytes, twice the packed 4-bit
    weight."""
    if qt.w8 is not None:
        return qt
    k, n = qt.in_features, qt.out_features
    w8 = torch.empty((n, k), dtype=torch.int8, device=qt.device)
    scale = torch.empty((n,), dtype=torch.float32, device=qt.device)
    for c0 in range(0, n, W8_CHUNK):
        cols = slice(c0, min(c0 + W8_CHUNK, n))
        w = dequantize_t(dataclasses.replace(
            qt, qweight=qt.qweight[:, cols], scales=qt.scales[:, cols],
            zscale=qt.zscale[:, cols]), torch.float32)
        s = w.abs().amax(dim=0).clamp_min(1e-20) * (1.0 / 127.0)
        w8[cols] = torch.round(w / s).clamp_(-127, 127).to(torch.int8).t()
        scale[cols] = s
    return dataclasses.replace(qt, w8=w8, w8_scale=scale)


def concat_quant_tensors(qts: "list[QuantTensor]") -> QuantTensor:
    """Fuse same-input QuantTensors along output columns (qkv, gate|up).

    The port's layout has no column padding, so part ``i`` starts at column
    ``sum(out_features of parts before it)``. Act-order tensors cannot be
    fused: their activations need different permutations. The int8 image
    (a row a column) and its scales are per column, so they concatenate
    too, and are carried only when every part has them.
    """
    first = qts[0]
    for qt in qts:
        assert qt.in_features == first.in_features
        assert qt.groupsize == first.groupsize
        assert qt.x_map is None, "cannot fuse act-order tensors"

    def cat(name, dim):
        parts = [getattr(qt, name) for qt in qts]
        if any(p is None for p in parts):
            return None
        return torch.cat(parts, dim=dim)

    return QuantTensor(
        qweight=cat("qweight", 1), scales=cat("scales", 1),
        zscale=cat("zscale", 1), x_map=None, groupsize=first.groupsize,
        w8=cat("w8", 0), w8_scale=cat("w8_scale", 0),
    )


def permute_out_columns(qt: QuantTensor, perm) -> QuantTensor:
    """New output column j holds old column perm[j] (the act-order fold)."""
    perm = torch.as_tensor(np.asarray(perm, np.int64), device=qt.device)
    return dataclasses.replace(
        qt,
        qweight=qt.qweight[:, perm].contiguous(),
        scales=qt.scales[:, perm].contiguous(),
        zscale=qt.zscale[:, perm].contiguous(),
        w8=None if qt.w8 is None else qt.w8[perm].contiguous(),
        w8_scale=None if qt.w8_scale is None else qt.w8_scale[perm],
    )


# ---------------------------------------------------------------------------
# Synthetic quantization (test fixtures / benchmarks)
# ---------------------------------------------------------------------------


def quantize_matrix(
    w: np.ndarray,
    groupsize: int = 128,
    act_order: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> dict[str, np.ndarray]:
    """Asymmetric 4-bit min/max quantization of f32 [K, N] -> GPTQ tensors.

    For act_order a random row->group assignment is drawn (each group exactly
    groupsize rows). Same algorithm and random draws as the JAX package's
    ``quantize_matrix``, so one seed gives one checkpoint in both.
    """
    k, n = w.shape
    assert k % groupsize == 0 and k % 8 == 0 and n % 8 == 0
    groups = k // groupsize
    rng = rng or np.random.default_rng(0)

    if act_order:
        perm = rng.permutation(k).astype(np.int64)
        g_idx = np.empty(k, dtype=np.int32)
        g_idx[perm] = (np.arange(k) // groupsize).astype(np.int32)
    else:
        g_idx = (np.arange(k) // groupsize).astype(np.int32)

    order = np.argsort(g_idx, kind="stable")
    wg = w[order].reshape(groups, groupsize, n)
    wmin = wg.min(axis=1)
    wmax = wg.max(axis=1)
    scales = ((wmax - wmin) / 15.0).astype(np.float32)
    scales = np.maximum(scales, 1e-8)
    # true zero-point >= 1 so the stored zero-1 is >= 0
    zero = np.clip(np.round(-wmin / scales), 1, 15).astype(np.uint8)

    qg = np.clip(
        np.round(wg / scales[:, None, :]) + zero[:, None, :].astype(np.float32),
        0,
        15,
    ).astype(np.uint8)
    q = np.empty((k, n), dtype=np.uint8)
    q[order] = qg.reshape(k, n)

    out = {
        "qweight": pack_gptq_qweight(q),
        "qzeros": pack_gptq_qzeros(zero - 1),   # GPTQ stores zero-1
        "scales": scales.astype(np.float16),
    }
    if act_order:
        out["g_idx"] = g_idx
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel slicing (exllama_tpu formats/gptq.py:599-795 in the port's
# layout). The JAX package retiles a global tensor into tp padded segments
# and shard_map hands each device its own; here each rank keeps only its
# own slice. Uneven splits take a uniform chunk whose tail is zero words
# with zero scales and zero-scales, so the padding dequantizes to exactly 0
# and every rank runs the same kernels at the same shapes.
# ---------------------------------------------------------------------------

# The port's K rule: the kernels take K in whole groups of a multiple of 32
# rows (``ops.quant.check_qt_tensors``), so a row chunk is a multiple of
# lcm(TP_K_STEP, groupsize). The JAX package's step is 128, a TPU lane.
TP_K_STEP = 32


def tp_chunk(total: int, tp: int, step: int) -> int:
    """Uniform per-rank chunk covering ``total`` split ``tp`` ways at
    ``step`` alignment; the last rank(s) may hold fewer true elements."""
    per_rank = -(-total // tp)
    return -(-per_rank // step) * step


def tp_row_step(qt: QuantTensor) -> int:
    """Alignment of a row chunk of ``qt``: whole groups the kernels take."""
    import math

    return math.lcm(TP_K_STEP, qt.groupsize)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-extended along ``dim`` to ``size``, contiguous."""
    extra = size - t.shape[dim]
    if extra == 0:
        return t.contiguous()
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim).contiguous()


def slice_out_columns(qt: QuantTensor, tp: int, rank: int,
                      chunk: "int | None" = None) -> QuantTensor:
    """Rank ``rank``'s output columns of a column-parallel tensor (q, k, v,
    gate, up): true columns ``[rank*chunk, min((rank+1)*chunk, N))``,
    zero-extended to ``chunk`` (default N / tp, which must be whole). The
    K-side permutation ``x_map`` stays whole."""
    assert qt.w8 is None and qt.w8_scale is None, \
        "slice before attaching the int8 image"
    n = qt.out_features
    if chunk is None:
        assert n % tp == 0, (n, tp)
        chunk = n // tp
    assert chunk * tp >= n, (chunk, tp, n)
    lo, hi = min(rank * chunk, n), min((rank + 1) * chunk, n)

    def cols(t):
        return _pad_to(t[:, lo:hi], 1, chunk)

    return dataclasses.replace(qt, qweight=cols(qt.qweight),
                               scales=cols(qt.scales),
                               zscale=cols(qt.zscale))


def slice_in_rows(qt: QuantTensor, tp: int, rank: int,
                  chunk: "int | None" = None) -> QuantTensor:
    """Rank ``rank``'s input rows of a row-parallel tensor (o, down): true
    rows ``[rank*chunk, min((rank+1)*chunk, K))``, zero-extended to
    ``chunk`` (default ``tp_chunk(K, tp, tp_row_step(qt))``; whole groups).
    The rank's product is a partial sum the caller all-reduces; its input
    must carry zeros where the padding is (a column-parallel producer
    sliced with the same chunk does). An act-order ``x_map`` is sliced with
    the rows (global indices; padded entries 0, on zero-scale rows)."""
    assert qt.w8 is None and qt.w8_scale is None, \
        "slice before attaching the int8 image"
    k, gs = qt.in_features, qt.groupsize
    if chunk is None:
        chunk = tp_chunk(k, tp, tp_row_step(qt))
    assert chunk % gs == 0 and chunk * tp >= k, (chunk, gs, tp, k)
    lo, hi = min(rank * chunk, k), min((rank + 1) * chunk, k)
    assert lo % gs == 0 and hi % gs == 0, (lo, hi, gs)
    xm = None
    if qt.x_map is not None:
        xm = _pad_to(qt.x_map[lo:hi], 0, chunk)
    return dataclasses.replace(
        qt,
        qweight=_pad_to(qt.qweight[lo // 8:hi // 8], 0, chunk // 8),
        scales=_pad_to(qt.scales[lo // gs:hi // gs], 0, chunk // gs),
        zscale=_pad_to(qt.zscale[lo // gs:hi // gs], 0, chunk // gs),
        x_map=xm,
    )
