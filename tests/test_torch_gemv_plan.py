"""K1 at 2..32 rows and K4 on Hopper, on the CPU: their plans and their
decompositions (ops/quant.py: q4_gemv_plan, q4_gemv_split_plain; ops/dense.py:
dense_plan, dense_split_plain). Each plan covers every output element and
every k once on at most one block an SM, with the row tile chosen by M; the
range-by-range f32 sums with the kernels' combine order agree with the JAX
package (q4_matmul and dense_matmul, their Pallas kernels in interpret mode
at M <= 32) and with the port's plain versions; a plan that drops a k-range
is caught."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.ops import dense as jdense
from exllama_tpu.ops import quant as jquant
from exllama_tpu_torch import kernels
from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.ops import dense, quant

SMS = 132      # an H100 SXM
# Llama-7B's four projections (K, N), their tp = 2 / 4 shards (o and down
# cut along K, qkv and gate|up along N; down at tp = 4 padded to whole
# groups) and ragged widths (N % 8 != 0: the kernel's plain loads; N off the
# 256-column tile)
K1_SHAPES = {
    "qkv": (4096, 12288), "o": (4096, 4096), "gateup": (4096, 22016),
    "down": (11008, 4096),
    "tp2 qkv": (4096, 6144), "tp2 o": (2048, 4096), "tp2 gateup": (4096, 11008),
    "tp2 down": (5504, 4096),
    "tp4 qkv": (4096, 3072), "tp4 o": (1024, 4096), "tp4 gateup": (4096, 5504),
    "tp4 down": (2816, 4096),
    "N=100": (4096, 100), "N=130": (4096, 130), "N=4168": (4096, 4168),
}
K1_ROWS = (2, 8, 9, 16, 17, 18, 24, 25, 32)
K4_ROWS = (1, 2, 8, 32, 40, 64, 1919)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the shapes are tiny and the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_of(u, units, grid):
    """csrc/stream_k.cuh:block_of, the block whose range holds unit u."""
    return ((u + 1) * grid + units - 1) // units - 1


def _check_cover(plan, mtiles, ntiles, ktiles):
    """Every (tile, slab) unit once; no block idles; a cut tile's pieces
    are consecutive blocks, contiguous in k, the first and last those the
    kernel's combine reads."""
    assert 1 <= plan.grid <= SMS
    assert plan.tiles == mtiles * ntiles and plan.ktiles == ktiles
    ranges = plan.ranges()
    assert len(ranges) == plan.grid and all(ranges)
    cover = np.zeros((plan.tiles, ktiles), np.int64)
    pieces: dict = {}
    for b, rs in enumerate(ranges):
        for i, (t, kb, ke, slot) in enumerate(rs):
            assert 0 <= kb < ke <= ktiles
            cover[t, kb:ke] += 1
            if slot is None:
                assert (kb, ke) == (0, ktiles)
            else:
                assert plan.stream_k and slot == (0 if i == 0 else 1)
                assert i in (0, len(rs) - 1)
                pieces.setdefault(t, []).append((b, kb, ke))
    assert (cover == 1).all()
    units = plan.tiles * ktiles
    for t, ps in pieces.items():
        assert [kb for _, kb, _ in ps] == [0] + [ke for _, _, ke in ps[:-1]]
        assert ps[-1][2] == ktiles
        blocks = [b for b, _, _ in ps]
        assert blocks == list(range(blocks[0], blocks[-1] + 1))
        assert blocks[0] == _block_of(t * ktiles, units, plan.grid)
        assert blocks[-1] == _block_of((t + 1) * ktiles - 1, units, plan.grid)


@pytest.mark.parametrize("shape", list(K1_SHAPES))
@pytest.mark.parametrize("m", K1_ROWS)
def test_q4_gemv_plan_covers_each_output_and_k_once(m, shape):
    k, n = K1_SHAPES[shape]
    plan = quant.q4_gemv_plan(m, n, k, SMS)
    assert plan.bm == (16 if m <= 16 else 32) and m <= plan.bm
    _check_cover(plan, 1, -(-n // quant.Q4GV_BN), -(-k // quant.Q4GV_BK))
    # the tiles do not fill the card at any of these widths: stream-K, on
    # every SM where there are as many slabs and a tile is cut among at most
    # SPLIT_MAX_PIECES blocks, each block within one slab of the same work
    assert plan.stream_k and plan.grid == min(
        SMS, plan.tiles * plan.ktiles, plan.tiles * quant.SPLIT_MAX_PIECES)
    pieces = [sum(1 for rs in plan.ranges() for t, *_ in rs if t == tile)
              for tile in range(plan.tiles)]
    assert max(pieces) <= quant.SPLIT_MAX_PIECES + 1
    work = [sum(ke - kb for _, kb, ke, _ in rs) for rs in plan.ranges()]
    assert max(work) - min(work) <= 1


@pytest.mark.parametrize("v", [32000, 32001])
@pytest.mark.parametrize("m", K4_ROWS)
def test_dense_plan_covers_each_output_and_k_once(m, v):
    k = 4096
    plan = dense.dense_plan(m, k, v, SMS)
    assert plan.bm == (8 if m <= 8 else 32 if m <= 32 else 64)
    mtiles = -(-m // plan.bm)
    assert plan.mtiles == mtiles and (mtiles - 1) * plan.bm < m
    _check_cover(plan, mtiles, -(-v // dense.DWG_BN), -(-k // dense.DWG_BK))
    # 125-126 column tiles a row tile: whole tiles fill 95% of the card;
    # a perplexity chunk's 30 row tiles too
    assert not plan.stream_k


def test_plans_on_other_cards():
    """At most one block an SM whatever the SM count; fewer units than
    SMs: a block a unit; a few tiles on many SMs: stream-K."""
    for sms in (1, 7, 78, 114, 132):
        for m, (k, n) in ((2, K1_SHAPES["o"]), (32, K1_SHAPES["N=100"])):
            plan = quant.q4_gemv_plan(m, n, k, sms)
            assert 1 <= plan.grid <= sms
        for m in (1, 40, 1919):
            assert 1 <= dense.dense_plan(m, 4096, 32001, sms).grid <= sms
    plan = quant.q4_gemv_plan(2, 200, 64, SMS)        # one tile, one slab
    assert (plan.tiles, plan.ktiles, plan.grid) == (1, 1, 1)
    plan = dense.dense_plan(40, 4096, 1000, SMS)      # 4 tiles, 16 blocks each
    assert plan.stream_k and plan.grid == 4 * quant.SPLIT_MAX_PIECES
    with pytest.raises(ValueError):
        quant.q4_gemv_plan(33, 4096, 4096, SMS)


def test_split_scratch_is_held_for_graphs():
    """Both kernels' stream-K scratch is the per-device GEMV scratch, grown
    to the plan's need (K1: two pieces of partial sums and sums of x^2 a
    block; K4: two [bm, 256] slots a block; a ticket a tile), in
    ``kernels.scratch_in_use`` (what a captured graph keeps)."""
    dev = torch.device("cpu")
    plan = quant.q4_gemv_plan(18, 4096, 4096, SMS)
    part, ticket = quant.q4_gemv_scratch(dev, plan)
    assert plan.piece == 32 * 256 + 8 * 256
    assert part.numel() >= 2 * plan.grid * plan.piece
    assert ticket.numel() >= plan.tiles and not ticket.any()
    held = kernels.scratch_in_use(dev)
    assert any(h is part for h in held) and any(h is ticket for h in held)
    dplan = dense.dense_plan(40, 4096, 1000, SMS)
    assert dplan.stream_k
    part, ticket = dense.dense_scratch(dev, dplan)
    assert part.numel() >= 2 * dplan.grid * dplan.bm * dense.DWG_BN
    assert ticket.numel() >= dplan.tiles and not ticket.any()
    held = kernels.scratch_in_use(dev)
    assert any(h is part for h in held) and any(h is ticket for h in held)


# ------------------------------------------------------------- arithmetic

def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _q4_case(m, k, n, gs, act_order, norm, seed):
    """A GPTQ tensor quantized at [k, n8] (n rounded up to 8) for the JAX
    package and cut to its first n columns for the port (as a ragged shard
    is), x [m, k] and the norm weights."""
    rng = np.random.default_rng(seed)
    n8 = -(-n // 8) * 8
    w = rng.normal(size=(k, n8)).astype(np.float32) * 0.1
    t = gptq.quantize_matrix(w, gs, act_order, rng)
    x = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
    nw = (rng.random(k) + 0.5).astype(np.float32) if norm else None
    jqt = jgptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                  t.get("g_idx"))
    qt = gptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                t.get("g_idx"))
    cut = dataclasses.replace(qt, qweight=qt.qweight[:, :n].contiguous(),
                              scales=qt.scales[:, :n].contiguous(),
                              zscale=qt.zscale[:, :n].contiguous())
    return x, nw, jqt, cut


@pytest.mark.parametrize("m,k,n,gs,act_order,norm,sms", [
    (2, 256, 520, 32, False, True, 5),      # stream-K, a tile cut three ways
    (18, 512, 130, 128, False, False, 7),   # N % 8 != 0
    (32, 512, 264, 512, False, True, 3),    # one group a column (gs = K)
    (9, 256, 264, 64, True, True, 64),      # act-order, a block a unit
    (17, 320, 520, 32, True, False, 2),     # K % 64 == 32 (the port alone)
    (24, 256, 200, 128, False, True, 1),    # one block, data-parallel
])
def test_q4_gemv_split_plain_matches_jax(m, k, n, gs, act_order, norm, sms):
    """q4_gemv_split_plain against the JAX package's q4_matmul
    (impl="pallas_interpret": its GEMV kernel at M <= 32, the norm in its
    prologue) within 2e-2 of the output's scale (rtol 2e-2, atol 2e-2 x
    max |ref|: the Hopper kernel applies 1/rms after the products, so an
    output near 0 carries the rounding of x * w on its own; the JAX
    kernel's K blocks are whole multiples of 128, so K = 320 is held
    against the port alone), and against the port's plain version within
    1e-2 of the scale (the limit chip_smoke.py holds K1 to: f32 group sums
    of exact nibbles vs bf16-rounded weights)."""
    x, nw, jqt, qt = _q4_case(m, k, n, gs, act_order, norm,
                              seed=m + k + gs + sms)
    plan = quant.q4_gemv_plan(m, n, k, sms)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    nwb = None if nw is None else torch.from_numpy(nw).to(torch.bfloat16)
    got = quant.q4_gemv_split_plain(xb, qt, plan, nwb, 1e-6)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    if k % 128 == 0:
        ref = np.asarray(jquant.q4_matmul(
            _jnp_bf16(x), jqt, impl="pallas_interpret",
            norm_w=None if nw is None else _jnp_bf16(nw), norm_eps=1e-6)
            .astype(jnp.float32))[:, :n]
        np.testing.assert_allclose(_np(got), ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())
    plain = _np(quant.q4_gemv_plain(xb, qt, nwb, 1e-6))
    assert np.abs(_np(got) - plain).max() <= 1e-2 * np.abs(plain).max()
    # on the CPU the wrapper is the plain version
    assert torch.equal(quant.q4_gemv(xb, qt, nwb, 1e-6),
                       quant.q4_gemv_plain(xb, qt, nwb, 1e-6))


@pytest.mark.parametrize("m,k,v,sms", [
    (1, 256, 1000, 5),       # stream-K
    (8, 512, 1001, 7),       # an odd vocab
    (32, 320, 520, 3),       # K % 64 == 32
    (40, 256, 1000, 132),    # above 32 rows: the JAX package's jnp.dot
    (130, 512, 1001, 11),    # three row tiles
])
def test_dense_split_plain_matches_jax(m, k, v, sms):
    """dense_split_plain against the JAX package's dense_matmul (its Pallas
    kernel in interpret mode at M <= 32, jnp.dot above) within rtol = atol
    = 1e-5, the limit of the JAX package's own test
    (tests/test_dense.py:19), and against the port's plain product within
    the 1e-4 chip_smoke.py holds K4 to."""
    rng = np.random.default_rng(m + k + v)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, v)) * 0.02).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    plan = dense.dense_plan(m, k, v, sms)
    got = dense.dense_split_plain(xb, wb, plan)
    ref = np.asarray(jdense.dense_matmul(_jnp_bf16(x), _jnp_bf16(w),
                                         impl="pallas_interpret"))
    assert got.shape == (m, v) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)
    plain = _np(dense.dense_gemv_plain(xb, wb))
    assert np.abs(_np(got) - plain).max() <= 1e-4 * np.abs(plain).max()
    # on the CPU the wrappers are the plain product at every row count
    assert torch.equal(dense.dense_matmul(xb, wb), dense.dense_gemv_plain(xb, wb))


@pytest.mark.parametrize("m,k,n,gs,sms,drop", [
    (18, 512, 520, 32, 5, (1, 0)),     # a piece of a tile cut by stream-K
    (2, 512, 520, 128, 5, (0, 0)),
    (32, 256, 264, 64, 1, (0, 1)),     # a whole tile, data-parallel
])
def test_q4_gemv_dropped_range_is_caught(m, k, n, gs, sms, drop):
    """Leaving one range of the plan out moves K1's output by more than 3x
    the 1e-2 limit the card holds it to."""
    x, nw, _, qt = _q4_case(m, k, n, gs, False, True, seed=7)
    plan = quant.q4_gemv_plan(m, n, k, sms)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    nwb = torch.from_numpy(nw).to(torch.bfloat16)
    good = _np(quant.q4_gemv_split_plain(xb, qt, plan, nwb))
    bad = _np(quant.q4_gemv_split_plain(xb, qt, plan, nwb, drop=drop))
    assert np.abs(bad - good).max() > 3 * 1e-2 * np.abs(good).max()


@pytest.mark.parametrize("m,k,v,sms,drop", [
    (1, 512, 1000, 5, (1, 0)),
    (40, 512, 1001, 7, (0, 0)),
    (130, 256, 520, 2, (1, 1)),        # whole tiles, data-parallel
])
def test_dense_dropped_range_is_caught(m, k, v, sms, drop):
    """Leaving one range of the plan out moves K4's output by more than 3x
    the 1e-4 limit the card holds it to."""
    gen = torch.Generator().manual_seed(m + v)
    x = torch.randn((m, k), generator=gen).bfloat16()
    w = (torch.randn((k, v), generator=gen) * 0.02).bfloat16()
    plan = dense.dense_plan(m, k, v, sms)
    good = _np(dense.dense_split_plain(x, w, plan))
    bad = _np(dense.dense_split_plain(x, w, plan, drop=drop))
    assert np.abs(bad - good).max() > 3 * 1e-4 * np.abs(good).max()


def test_head_argmax_above_32_rows_on_the_cpu_is_plain():
    """The CPU keeps the plain composition at every row count (the card
    runs rms_norm, K4 and argmax above K5's 32 rows)."""
    gen = torch.Generator().manual_seed(3)
    h = torch.randn((2, 20, 256), generator=gen).bfloat16()
    nw = (torch.rand(256, generator=gen) + 0.5).bfloat16()
    w = torch.randn((256, 300), generator=gen).bfloat16()
    got = dense.head_argmax(h, nw, w, 1e-6)
    assert got.shape == (2, 20)
    assert torch.equal(got.reshape(-1),
                       dense.head_argmax_plain(h.reshape(40, 256), nw, w, 1e-6))
