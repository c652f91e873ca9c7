"""K2's plan and decomposition on the CPU (ops/quant.py: q4_matmul_plan,
q4_dequant_matmul_split_plain): the plan covers every output element and
every k once on at most one block an SM, with the tile chosen by M; the
tile-by-tile, range-by-range f32 sums with the kernel's combine order agree
with the JAX package's q4_matmul (Pallas, interpret mode) and with the
port's plain product; a plan that drops a k-range is caught."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.ops import quant as jquant
from exllama_tpu_torch import kernels
from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.ops import quant

SMS = 132      # an H100 SXM
# Llama-7B's four projections (K, N), their tp = 2 / 4 shards (o and down
# cut along K, qkv and gate|up along N; down at tp = 4 padded to whole
# groups), and a 4-bit lm_head at an odd vocab (N % 8 != 0)
SHAPES = {
    "qkv": (4096, 12288), "o": (4096, 4096), "gateup": (4096, 22016),
    "down": (11008, 4096),
    "tp2 qkv": (4096, 6144), "tp2 o": (2048, 4096), "tp2 gateup": (4096, 11008),
    "tp2 down": (5504, 4096),
    "tp4 qkv": (4096, 3072), "tp4 o": (1024, 4096), "tp4 gateup": (4096, 5504),
    "tp4 down": (2816, 4096),
    "head 32001": (4096, 32001),
}
ROWS = (33, 40, 64, 127, 129, 256, 257, 1919)
# the row tile each M takes: the least padded work at 64 rows of fixed
# work a tile (33..64 in one 64-row tile, 65..128 in one of 128, 129..256
# in one of 256, 257 in three of 128, 1919 in eight of 256)
ROW_TILE = {33: 64, 40: 64, 64: 64, 127: 128, 129: 256, 256: 256, 257: 128,
            1919: 256}


def _block_of(u, units, grid):
    """csrc/stream_k.cuh:block_of, the block whose range holds unit u."""
    return ((u + 1) * grid + units - 1) // units - 1


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("m", ROWS)
def test_plan_covers_each_output_and_k_once(m, shape):
    k, n = SHAPES[shape]
    plan = quant.q4_matmul_plan(m, n, k, SMS)
    assert (plan.bm, plan.bn) == (ROW_TILE[m], quant.Q4MM_TILES[ROW_TILE[m]])
    assert 1 <= plan.grid <= SMS
    # the tiles cover [m, n] once: row tile t % mtiles of column tile
    # t // mtiles, the last of each ragged
    assert (plan.mtiles - 1) * plan.bm < m <= plan.mtiles * plan.bm
    ntiles = plan.tiles // plan.mtiles
    assert (ntiles - 1) * plan.bn < n <= ntiles * plan.bn
    assert (plan.ktiles - 1) * quant.Q4MM_BK < k <= plan.ktiles * quant.Q4MM_BK
    ranges = plan.ranges()
    assert len(ranges) == plan.grid and all(ranges)   # no block idles
    cover = np.zeros((plan.tiles, plan.ktiles), np.int64)
    pieces: dict = {}
    for b, rs in enumerate(ranges):
        for i, (t, kb, ke, slot) in enumerate(rs):
            assert 0 <= kb < ke <= plan.ktiles
            cover[t, kb:ke] += 1
            if slot is None:
                assert (kb, ke) == (0, plan.ktiles)
            else:   # the block's first range in slot 0, its last in slot 1
                assert plan.stream_k and slot == (0 if i == 0 else 1)
                assert i in (0, len(rs) - 1)
                pieces.setdefault(t, []).append((b, kb, ke))
    assert (cover == 1).all()
    # a cut tile's pieces are consecutive blocks, contiguous in k, and the
    # first and last are the blocks the kernel's combine reads
    units = plan.tiles * plan.ktiles
    for t, ps in pieces.items():
        assert [kb for _, kb, _ in ps] == [0] + [ke for _, _, ke in ps[:-1]]
        assert ps[-1][2] == plan.ktiles
        blocks = [b for b, _, _ in ps]
        assert blocks == list(range(blocks[0], blocks[-1] + 1))
        assert blocks[0] == _block_of(t * plan.ktiles, units, plan.grid)
        assert blocks[-1] == _block_of((t + 1) * plan.ktiles - 1, units,
                                       plan.grid)


@pytest.mark.parametrize("m,shape,stream_k", [
    (40, "o", True), (64, "down", True), (127, "gateup", True),
    (1919, "gateup", False), (1919, "qkv", False), (257, "gateup", False),
])
def test_plan_fills_the_card(m, shape, stream_k):
    """Whole tiles data-parallel where their last wave is at least 90%
    full, stream-K over (tile, slab) units otherwise; either way each block
    gets within one tile (data-parallel) or one slab (stream-K) of the
    same work."""
    k, n = SHAPES[shape]
    plan = quant.q4_matmul_plan(m, n, k, SMS)
    assert plan.stream_k == stream_k and plan.grid == SMS
    work = [sum(ke - kb for _, kb, ke, _ in rs) for rs in plan.ranges()]
    assert max(work) - min(work) <= (1 if stream_k else plan.ktiles)


def test_plan_on_other_cards():
    """At most one block an SM whatever the SM count; fewer units than
    SMs: a block a unit."""
    for sms in (1, 7, 78, 114, 132):
        for m, (k, n) in ((40, SHAPES["o"]), (1919, SHAPES["gateup"])):
            plan = quant.q4_matmul_plan(m, n, k, sms)
            assert 1 <= plan.grid <= sms
    plan = quant.q4_matmul_plan(40, 200, 64, SMS)     # one tile, one slab
    assert (plan.tiles, plan.ktiles, plan.grid) == (1, 1, 1)


def test_split_scratch_is_held_for_graphs():
    """The stream-K scratch is the per-device GEMV scratch, grown to the
    plan's need: two [bm, bn] f32 slots a block, a ticket a tile, in
    ``kernels.scratch_in_use`` (what a captured graph keeps)."""
    plan = quant.q4_matmul_plan(40, 4096, 4096, SMS)
    assert plan.stream_k
    dev = torch.device("cpu")
    part, ticket = quant.q4_matmul_scratch(dev, plan)
    assert part.numel() >= 2 * plan.grid * plan.bm * plan.bn
    assert ticket.numel() >= plan.tiles and not ticket.any()
    held = kernels.scratch_in_use(dev)
    assert any(t is part for t in held) and any(t is ticket for t in held)


# ------------------------------------------------------------- arithmetic

def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _case(m, k, n, gs, act_order, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.1
    t = gptq.quantize_matrix(w, gs, act_order, rng)
    x = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
    jqt = jgptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                  t.get("g_idx"))
    qt = gptq.load_quant_tensor(t["qweight"], t["qzeros"], t["scales"],
                                t.get("g_idx"))
    return x, jqt, qt


def _gathered(x, qt):
    """x in the weight's row order, as the caller hands it to K2."""
    xb = _bf16(x)
    return xb if qt.x_map is None else xb.index_select(
        1, qt.x_map.to(torch.long))


@pytest.mark.parametrize("m,k,n,gs,act_order,sms", [
    (40, 256, 520, 32, False, 5),       # stream-K, a tile cut three ways
    (40, 256, 520, 128, False, 64),     # a block a slab
    (64, 512, 264, 512, False, 7),      # one group a column (gs = K)
    (130, 256, 264, 32, True, 3),       # act-order, 256-row tile
    (300, 320, 136, 64, False, 11),     # K % 64 == 32, ragged tiles
    (300, 256, 200, 128, True, 1),      # one block, data-parallel
])
def test_split_plain_matches_jax(m, k, n, gs, act_order, sms):
    """q4_dequant_matmul_split_plain against the JAX package's q4_matmul
    (impl="pallas_interpret": its prefill kernel at M > 32) within 2e-2,
    as tests/test_torch_ops.py:44, and against the port's plain product
    within 1e-2 (the same bf16 weights; f32 sums in another order)."""
    torch.set_num_threads(1)
    x, jqt, qt = _case(m, k, n, gs, act_order, seed=m + k + gs + sms)
    plan = quant.q4_matmul_plan(m, n, k, sms)
    xg = _gathered(x, qt)
    got = quant.q4_dequant_matmul_split_plain(xg, qt, plan)
    ref = np.asarray(jquant.q4_matmul(_jnp_bf16(x), jqt,
                                      impl="pallas_interpret")
                     .astype(jnp.float32))
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), ref, rtol=2e-2, atol=2e-2)
    plain = _np(quant._q4_matmul_plain(xg, qt))
    assert np.abs(_np(got) - plain).max() <= 1e-2 * np.abs(plain).max()
    # on the CPU the wrapper is the plain version
    assert torch.equal(quant.q4_dequant_matmul(xg, qt),
                       quant._q4_matmul_plain(xg, qt))


@pytest.mark.parametrize("m,k,n,gs,sms,drop", [
    (40, 256, 520, 32, 5, (1, 0)),      # a piece of a tile cut by stream-K
    (40, 256, 520, 32, 5, (0, 0)),
    (300, 320, 136, 64, 2, (1, 0)),     # a whole tile, data-parallel
])
def test_a_dropped_range_is_caught(m, k, n, gs, sms, drop):
    """Leaving one range of the plan out moves the output by more than 3x
    the 1e-2 limit the card holds K2 to."""
    torch.set_num_threads(1)
    x, _, qt = _case(m, k, n, gs, False, seed=7)
    plan = quant.q4_matmul_plan(m, n, k, sms)
    xb = _bf16(x)
    good = _np(quant.q4_dequant_matmul_split_plain(xb, qt, plan))
    bad = _np(quant.q4_dequant_matmul_split_plain(xb, qt, plan, drop=drop))
    assert np.abs(bad - good).max() > 3 * 1e-2 * np.abs(good).max()
