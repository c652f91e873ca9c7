"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips where no card is present. On the H100:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts=""

(``--noconftest``: the suite's conftest.py sets up JAX, which that machine
does not have; ``-o addopts=""`` drops the suite's xdist options.)

The shapes are small and ragged on purpose (N not a multiple of the column
tile, odd M, GQA, head_dim 64); chip_smoke.py covers the Llama-7B shapes.
"""

import dataclasses

import pytest
import torch

from exllama_tpu_torch.formats.gptq import (
    QuantTensor,
    w8_col_scale,
    with_w8,
)
from exllama_tpu_torch.ops import (
    attention,
    attn_block,
    dense,
    mlp,
    norms,
    quant,
    rope,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _qt(gen, k, n, gs, act_order):
    words = torch.randint(-(2 ** 31), 2 ** 31 - 1, (k // 8, n), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    s = torch.rand((k // gs, n), generator=gen, device="cuda") * 0.01 + 0.002
    z = s * torch.randint(1, 16, s.shape, generator=gen, device="cuda")
    xm = (torch.randperm(k, generator=gen, device="cuda").to(torch.int32)
          if act_order else None)
    return QuantTensor(words, s.bfloat16(), z.bfloat16(), xm, gs)


def _close(got, ref, rel):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= rel * ref.abs().max()


@pytest.mark.parametrize("m,k,n,gs,act,norm", [
    (1, 256, 520, 32, False, True),
    (3, 512, 200, 64, True, False),
    (7, 1024, 1000, 128, True, True),
    (32, 768, 96, 128, False, False),
    # the tensor-core route: M = 2..32, groupsizes beyond 128 (gs = K too,
    # one row included), N % 8 != 0 (plain loads), a K split over many
    # blocks (two column tiles, 32 splits: the ticketed combine)
    (2, 1024, 264, 256, False, True),
    (16, 512, 136, 512, False, False),
    (18, 2048, 200, 128, True, True),
    (4, 256, 100, 32, False, False),
    (1, 1024, 264, 256, False, True),
    (1, 512, 264, 512, False, False),
    (17, 2048, 384, 2048, False, True),
    (18, 8192, 256, 128, False, False),
    # the Hopper kernel's row tiles (16 / 32) at their edges, K % 64 == 32,
    # a tile cut among many blocks, data-parallel whole tiles, N % 8 != 0
    (9, 1024, 520, 64, False, True),
    (24, 320, 264, 32, True, False),
    (25, 4096, 4096, 128, False, True),
    (32, 256, 40000, 128, False, False),
    (17, 512, 130, 128, True, True),
])
def test_q4_gemv_matches_plain(gen, m, k, n, gs, act, norm):
    """1e-2 of the output scale: f32 group sums of exact nibbles vs a
    product of bf16-rounded weights, both rounded to bf16; the same bits
    from a second call (the split tiles' combine has a fixed order)."""
    qt = _qt(gen, k, n, gs, act)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    nw = (torch.rand(k, generator=gen, device="cuda") + 0.5).bfloat16() \
        if norm else None
    before = quant.q4_gemv.launches
    got = quant.q4_gemv(x, qt, nw, 1e-5)
    assert quant.q4_gemv.launches == before + 1
    _close(got, quant.q4_gemv_plain(x, qt, nw, 1e-5), 1e-2)
    assert torch.equal(quant.q4_gemv(x, qt, nw, 1e-5), got)


def _outliers(gen, x, gs, factor=50.0):
    """One element per group of gs scaled up: the int8 step of its group
    grows with it, which is the noise the a8x2 residual pass removes."""
    m, k = x.shape
    idx = torch.randint(0, gs, (m, k // gs), generator=gen, device=x.device)
    idx = idx + torch.arange(0, k, gs, device=x.device)
    return x.scatter(1, idx, (x.gather(1, idx).float() * factor).bfloat16())


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("m,k,n,gs,act,norm", [
    (1, 256, 520, 32, False, True),
    (3, 512, 200, 64, True, False),
    (7, 1024, 1000, 128, True, True),
    (32, 768, 96, 128, False, False),
    (18, 4096, 264, 128, False, False),
    # the tensor-core route beyond groupsize 128 (a group over two staged
    # chunks: gs = K = 2048 at 16 rows), one row at gs 256, N % 8 != 0
    (2, 1024, 264, 256, False, True),
    (5, 2048, 200, 2048, False, False),
    (1, 1024, 264, 256, True, False),
    (4, 256, 100, 32, False, False),
])
def test_q4_gemv_a8_matches_plain(gen, m, k, n, gs, act, norm, two_pass):
    """K9 through K1's entry point. 5e-3 of the output scale against the
    plain version's unrounded f32 sums: the same int8 activations and the
    same integer group sums on both sides, so what is left is the kernel's
    bf16 output rounding (half a step, at most 2^-8 = 0.39% of an element)
    and the order of the f32 sums over groups. The faults a kernel could
    make -- the zero-point term dropped, the even nibbles of every word
    dropped and, with groups of 128 (where one outlier sets the int8 step
    of 127 other values), the residual pass dropped -- each move the plain
    output by more than 3x that on these inputs."""
    qt = _qt(gen, k, n, gs, act)
    x = _outliers(gen, torch.randn((m, k), generator=gen,
                                   device="cuda").bfloat16(), gs)
    nw = (torch.rand(k, generator=gen, device="cuda") + 0.5).bfloat16() \
        if norm else None
    ref = quant.q4_gemv_a8_plain(x, qt, nw, 1e-5, two_pass, torch.float32)
    scale = ref.abs().max()
    faults = [dataclasses.replace(qt, zscale=torch.zeros_like(qt.zscale)),
              dataclasses.replace(qt, qweight=qt.qweight & ~0x0F0F0F0F)]
    moved = [quant.q4_gemv_a8_plain(x, f, nw, 1e-5, two_pass, torch.float32)
             for f in faults]
    if two_pass and gs == 128:
        moved.append(quant.q4_gemv_a8_plain(x, qt, nw, 1e-5, False,
                                            torch.float32))
    for other in moved:
        assert (other - ref).abs().max() > 3 * 5e-3 * scale
    before = quant.q4_gemv_a8.launches, quant.q4_gemv.launches
    got = quant.q4_gemv_a8(x, qt, nw, 1e-5, two_pass=two_pass)
    assert (quant.q4_gemv_a8.launches, quant.q4_gemv.launches) == (
        before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16
    _close(got, ref, 5e-3)


@pytest.mark.parametrize("m,k,n,gs", [
    (33, 256, 520, 32), (130, 512, 136, 64), (257, 1024, 384, 128),
    (1919, 384, 264, 128), (40, 512, 264, 256), (64, 1024, 136, 1024),
    # K10's ring: a K that ends in half a 64-deep slab, N % 8 != 0 (the
    # producers' plain loads, element-wise output), gs = K, M = 1919
    (33, 288, 100, 32), (130, 512, 260, 256), (257, 768, 132, 768),
    (1919, 320, 136, 32), (1919, 1024, 260, 128),
])
def test_int8_prefill_kernels_match_plain(gen, m, k, n, gs):
    """K10 (in-kernel requant) and K11 (the resident K-major image; both
    modes of the ring). 5e-3 against the plain versions' unrounded f32
    values: the same int8 operands and exact integer sums on both sides,
    then the kernel's bf16 output rounding (at most 0.39%). The even
    nibbles of every word dropped, and the image's bytes read as [K, N],
    move the plain output by more than 3x that. Shapes are ragged in M and
    N (M tails of the 256-row tile, N tails of the 128-column tile and off
    a multiple of 8, a K that is not a multiple of the 64-deep step)."""
    qt = _qt(gen, k, n, gs, False)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    ws = w8_col_scale(qt)
    ref = quant.q4_prefill_a8_plain(x, qt, ws, torch.float32)
    broken = dataclasses.replace(qt, qweight=qt.qweight & ~0x0F0F0F0F)
    moved = quant.q4_prefill_a8_plain(x, broken, ws, torch.float32) - ref
    assert moved.abs().max() > 3 * 5e-3 * ref.abs().max()
    before = quant.q4_prefill_a8.launches
    got = quant.q4_prefill_a8(x, qt, ws)
    assert quant.q4_prefill_a8.launches == before + 1
    _close(got, ref, 5e-3)
    assert torch.equal(quant.q4_matmul(x, qt, "pallas_a8t"), got)

    qt8 = with_w8(qt)
    ref8 = quant.w8_matmul_plain(x, qt8.w8, qt8.w8_scale, torch.float32)
    mistaken = quant.w8_matmul_plain(x, qt8.w8.reshape(k, n).t(),
                                     qt8.w8_scale, torch.float32)
    assert (mistaken - ref8).abs().max() > 3 * 5e-3 * ref8.abs().max()
    before = quant.w8_matmul.launches
    got8 = quant.w8_matmul(x, qt8)
    assert quant.w8_matmul.launches == before + 1
    _close(got8, ref8, 5e-3)
    # through the dispatcher: the image when there is one, else K10
    assert torch.equal(quant.q4_matmul(x, qt8, "pallas_a8t"), got8)


@pytest.mark.parametrize("m,ni,n,gs,gap,tail", [
    (33, 256, 520, 32, 8, 0), (130, 512, 136, 64, 8, 0),
    (257, 1024, 384, 128, 8, 0), (40, 512, 264, 256, 8, 0),
    (64, 1024, 136, 1024, 8, 0),
    # the 128-row ring: ou = ni, up not at the end of the row, a K that ends
    # in half a 64-deep slab, N % 8 != 0, gs = K, M = 1919
    (1919, 256, 264, 128, 0, 0), (33, 288, 100, 32, 24, 16),
    (130, 512, 260, 512, 8, 0), (257, 768, 132, 256, 0, 8),
    (1919, 320, 136, 32, 8, 8),
])
def test_q4_matmul_glu_matches_plain(gen, m, ni, n, gs, gap, tail):
    """K12. 1e-2, as K2: the same bf16 activation silu(gate)*up (same cast
    order) and the same bf16 weights on both sides; the kernel's silu (one
    tanh.approx) against torch's can move an activation by a bf16 step. up starts at ou = ni + gap, which need not be a multiple of
    the width, and the row may hold ``tail`` more columns after it. A
    dropped silu moves the plain output by more than 3x the limit."""
    qt = _qt(gen, ni, n, gs, False)
    ou = ni + gap
    x = torch.randn((m, ou + ni + tail), generator=gen,
                    device="cuda").bfloat16()
    ref = quant.q4_matmul_glu_plain(x, qt, ni, ou)
    no_silu = quant._q4_matmul_plain(x[:, :ni] * x[:, ou:ou + ni], qt)
    assert ((no_silu.float() - ref.float()).abs().max()
            > 3 * 1e-2 * ref.float().abs().max())
    before = quant.q4_matmul_glu.launches, quant.q4_dequant_matmul.launches
    got = quant.q4_matmul(x, qt, glu=(ni, ou))
    assert (quant.q4_matmul_glu.launches,
            quant.q4_dequant_matmul.launches) == (before[0] + 1, before[1])
    _close(got, ref, 1e-2)
    # the other half of the input matters: up negated negates the output
    flipped = torch.cat([x[:, :ou], -x[:, ou:]], dim=1)
    assert torch.equal(quant.q4_matmul(flipped, qt, glu=(ni, ou)), -got)


@pytest.mark.parametrize("m,k,n,gs,act", [
    (33, 256, 520, 32, False), (130, 512, 136, 64, False),
    (257, 1024, 384, 128, False),
    # M around the row tiles, M = 1919; K % 64 == 32 (a half slab) at
    # g32 and g64 ... 128; N % 8 != 0 (plain loads of weights and scales)
    (127, 256, 264, 128, False), (129, 96, 200, 32, False),
    (1919, 384, 264, 128, False), (64, 256, 100, 64, False),
    (40, 128, 130, 32, False), (200, 512, 136, 128, True),
    (33, 512, 264, 256, False), (64, 1024, 136, 1024, False),
    # stream-K at the verify step's 40 rows and a 64-row chunk on o's
    # shape (16 tiles of 64 x 256 cut among the blocks); the edges of the
    # row tiles (64 / 65, 256 / 257) with ragged column tiles; N = 130 and
    # a 4-bit lm_head's odd vocab on the plain-load producer
    (40, 4096, 4096, 128, False), (64, 4096, 4096, 128, False),
    (65, 1024, 520, 64, False), (256, 512, 264, 32, False),
    (257, 2048, 1032, 128, False), (40, 512, 130, 32, False),
    (1919, 256, 130, 256, False), (33, 4096, 32001, 128, False),
])
def test_q4_dequant_matmul_matches_plain(gen, m, k, n, gs, act):
    """1e-2: the same bf16 weights, f32 sums in another order, bf16 out.
    Act-order: the caller gathers x (ops/quant.py:q4_matmul). A second
    call on the same inputs is bit-equal (the split tiles' sums are added
    in a fixed order)."""
    qt = _qt(gen, k, n, gs, act)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    if act:
        x = x.index_select(1, qt.x_map.long())
    before = quant.q4_dequant_matmul.launches
    got = quant.q4_dequant_matmul(x, qt)
    assert quant.q4_dequant_matmul.launches == before + 1
    _close(got, quant._q4_matmul_plain(x, qt), 1e-2)
    assert torch.equal(quant.q4_dequant_matmul(x, qt), got)


def test_q4_dequant_matmul_graph_holds_its_split_scratch(gen):
    """K2 at 40 rows (stream-K: f32 partials and tickets in the per-device
    scratch) captured in a graph: the graph holds the scratch it writes
    (``kernels.scratch_in_use``), so after the scratch is replaced by a
    larger one (as another kernel's call grows it) and an eager call at
    another shape has written the new one, its replays still give the
    eager output, bit for bit."""
    from exllama_tpu_torch import graphs, kernels

    qt = _qt(gen, 4096, 4096, 128, False)
    x = torch.randn((40, 4096), generator=gen, device="cuda").bfloat16()
    plan = quant.q4_matmul_plan(40, 4096, 4096, kernels.sm_count(x.device))
    assert plan.stream_k
    eager = quant.q4_dequant_matmul(x, qt)
    part, ticket = quant.q4_matmul_scratch(x.device, plan)
    outs = []
    graph, counts = graphs.capture_step(
        lambda: outs.append(quant.q4_dequant_matmul(x, qt)), x.device,
        torch.cuda.Stream(x.device), torch.cuda.graph_pool_handle())
    assert counts == {(quant.q4_dequant_matmul, "launches"): 1}
    held = kernels.scratch_in_use(x.device)
    assert any(t is part for t in held) and any(t is ticket for t in held)
    grown = quant.gemv_scratch(x.device, part.numel() + 1, ticket.numel() + 1)
    assert grown[0] is not part and grown[1] is not ticket
    # a 200-row call (256 x 128 tiles, stream-K) on the new scratch
    big = torch.randn((200, 4096), generator=gen, device="cuda").bfloat16()
    _close(quant.q4_dequant_matmul(big, qt), quant._q4_matmul_plain(big, qt),
           1e-2)
    outs[1].zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(outs[1], eager)
    del held


def test_no_wrapper_launches_the_ring_exact_mode(gen):
    """The mma.sync ring's Exact mode, K2's kernel before the Hopper one,
    is chip_smoke.py's yardstick only: every route of ops/quant.py at M >
    32 (each matmul mode, the GLU route, act-order, f32 scales) leaves its
    launch count where it was."""
    from exllama_tpu_torch import kernels

    ring = kernels.launcher("q4_matmul_ring_launches")
    before = ring()
    for act in (False, True):
        qt = _qt(gen, 512, 264, 128, act)
        f32 = dataclasses.replace(qt, scales=qt.scales.float(),
                                  zscale=qt.zscale.float())
        for m in (33, 64, 130, 300):
            x = torch.randn((m, 512), generator=gen, device="cuda").bfloat16()
            for impl in ("auto", "pallas", "pallas_a8", "pallas_a8x2",
                         "pallas_a8t"):
                quant.q4_matmul(x, qt, impl=impl)
            quant.q4_matmul(x, f32)
            gu = torch.randn((m, 1024), generator=gen,
                             device="cuda").bfloat16()
            quant.q4_matmul(gu, qt, glu=(512, 512))
    torch.cuda.synchronize()
    assert ring() == before


@pytest.mark.parametrize("b,t,h,hkv,d,past,deferred,masked", [
    (2, 1, 8, 2, 64, 70, True, False),
    (1, 1, 4, 4, 128, 0, True, False),
    (2, 37, 8, 2, 64, [5, 40], False, False),
    (2, 19, 4, 1, 128, 0, False, True),
    (1, 130, 4, 4, 64, 3, False, False),
    # the decode path's 64-key split edges: empty, one key, ragged, full
    (1, 1, 4, 4, 128, 1, True, False),
    (1, 1, 4, 4, 128, 63, True, False),
    (1, 1, 4, 4, 128, 64, True, False),
    (1, 1, 4, 4, 128, 65, True, False),
    (1, 1, 4, 4, 64, 127, True, False),
    (4, 1, 8, 2, 128, [0, 63, 64, 191], True, False),
    (2, 1, 8, 2, 128, [150, 9], True, True),
    (2, 1, 8, 2, 128, 100, False, False),       # decode, not deferred
    (2, 3, 8, 2, 64, [10, 100], False, True),   # 12 rows a kv head
    (1, 1, 32, 1, 64, 77, True, False),         # 32 rows: two row groups
    (3, 1, 8, 8, 128, [191, 0, 128], True, True),
    # head_dim 256: decode (split-KV) and prefill (O split over two warps)
    (2, 1, 8, 2, 256, [150, 9], True, True),
    (1, 1, 4, 4, 256, 65, True, False),
    (2, 37, 8, 2, 256, [5, 40], False, False),
    (2, 19, 4, 1, 256, 0, False, True),
])
def test_flash_attn_matches_plain(gen, b, t, h, hkv, d, past, deferred,
                                  masked):
    """2e-2: p is rounded to bf16 against a running max in the kernel and
    against the final max in the plain version. Shapes of both paths:
    split-KV decode (T = 1, or T * H / Hkv <= 16) and the prefill tiles."""
    s_max = 256
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16()
    kc = torch.randn((b, hkv, s_max, d), generator=gen,
                     device="cuda").bfloat16()
    vc = torch.randn_like(kc)
    past_t = (past if isinstance(past, int)
              else torch.tensor(past, dtype=torch.int32, device="cuda"))
    new_kv = None
    if deferred:
        new_kv = tuple(torch.randn((b, 1, hkv, d), generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(2))
    mask = None
    if masked:
        mask = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
        mask[0, :6] = False
    got = attention.attend(q, kc, vc, past_t, 192, mask, new_kv)
    ref = attention.attend_plain(q, kc, vc, past_t, 192, mask, new_kv)
    _close(got, ref, 2e-2)
    if masked:        # rows whose visible keys are all padding average V
        _close(got[0, :6], ref[0, :6], 2e-2)
        assert got[0, :6].abs().max() > 0


@pytest.mark.parametrize("d,kind", [(100, "bf16"), (100, "int4"),
                                    (96, "int8")])
def test_attend_xla_route_on_the_card(gen, d, kind):
    """A head dim K3 does not take routes to the einsum attention
    (attn_impl "auto"); on the card it is the same tensor code as on the
    CPU, counted on its own launch counter. 1e-2: the two devices' f32
    sums and softmax differ in their last bits, each rounded to bf16."""
    b, t, h, hkv, s_max = 2, 5, 8, 2, 64
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16()
    kv = torch.randn((2, b, hkv, s_max, d), generator=gen,
                     device="cuda").bfloat16()
    ks = vs = None
    if kind == "bf16":
        kc, vc = kv[0], kv[1]
    else:
        quant_rows = (attention.quantize_kv_rows4 if kind == "int4"
                      else attention.quantize_kv_rows)
        (kc, ks), (vc, vs) = quant_rows(kv[0]), quant_rows(kv[1])
    past = torch.tensor([3, 40], dtype=torch.int32, device="cuda")
    mask = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
    mask[0, :2] = False
    assert attention.resolve_attn_impl("auto", d) == "xla"
    fn = attention.attend_xla
    attr = "launches" if kind == "bf16" else f"launches_{kind}"
    before = getattr(attention.attend_xla, attr)
    got = fn(q, kc, vc, past, 48, mask, k_scale=ks, v_scale=vs)
    assert getattr(attention.attend_xla, attr) == before + 1
    cpu = [x.cpu() if x is not None else None
           for x in (q, kc, vc, past, mask, ks, vs)]
    ref = attention.attend_xla(*cpu[:3], cpu[3], 48, cpu[4], k_scale=cpu[5],
                               v_scale=cpu[6])
    _close(got.cpu(), ref, 1e-2)
    with pytest.raises(ValueError):
        attention.resolve_attn_impl("flash", d)


@pytest.mark.parametrize("m,k,v", [
    (1, 256, 1000), (5, 512, 130), (32, 128, 64),
    # stream-K: tiles shared among blocks, more blocks than tiles, a K off
    # the 32-row unit; odd vocabularies (the scalar loads)
    (1, 4096, 32000), (2, 4096, 1000), (8, 200, 4096), (16, 1000, 520),
    (1, 4096, 32001), (3, 512, 257), (32, 300, 1001), (2, 100, 1),
    # above 32 rows (K4 takes any M): the verify step's 40, several row
    # tiles, data-parallel whole tiles, an odd vocab
    (40, 4096, 32000), (64, 512, 1000), (130, 256, 1001), (1919, 256, 4096),
])
def test_dense_gemv_matches_plain(gen, m, k, v):
    """1e-4: f32 output of the same bf16 inputs, sums in another order;
    the same bits from two calls (the split's combine has a fixed order)."""
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = torch.randn((k, v), generator=gen, device="cuda").bfloat16()
    before = dense.dense_gemv.launches
    got = dense.dense_gemv(x, w)
    assert dense.dense_gemv.launches == before + 1
    assert got.shape == (m, v) and got.dtype == torch.float32
    _close(got, dense.dense_gemv_plain(x, w), 1e-4)
    assert torch.equal(dense.dense_gemv(x, w), got)


@pytest.mark.parametrize("m", [40, 1919])
def test_lm_head_above_32_rows_runs_k4(gen, m, monkeypatch):
    """On the card the lm_head of more than 32 rows (a verify step, a
    perplexity chunk) is one K4 launch and no plain product, for the logits
    (dense_matmul) and the greedy head (head_argmax: rms_norm, K4, argmax),
    within K4's 1e-4 of the plain product."""
    x = torch.randn((m, 4096), generator=gen, device="cuda").bfloat16()
    nw = (torch.rand(4096, generator=gen, device="cuda") + 0.5).bfloat16()
    w = (torch.randn((4096, 32000), generator=gen, device="cuda")
         * 0.02).bfloat16()
    ref = dense.dense_gemv_plain(x, w)
    ref_ids_logits = dense.dense_gemv_plain(norms.rms_norm(x, nw, 1e-6), w)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(dense, "dense_gemv_plain", refuse)
    monkeypatch.setattr(dense, "head_argmax_plain", refuse)
    before = (dense.dense_gemv.launches, dense.head_argmax.launches)
    got = dense.dense_matmul(x[None], w)[0]
    assert (dense.dense_gemv.launches, dense.head_argmax.launches) == (
        before[0] + 1, before[1])
    _close(got, ref, 1e-4)
    ids = dense.head_argmax(x[None], nw, w, 1e-6)
    assert (dense.dense_gemv.launches, dense.head_argmax.launches) == (
        before[0] + 2, before[1])
    assert ids.shape == (1, m) and ids.dtype == torch.int32
    picked = ref_ids_logits.gather(1, ids[0].long()[:, None])[:, 0]
    assert ((ref_ids_logits.amax(1) - picked).max()
            <= 1e-4 * ref_ids_logits.abs().max())


def test_no_wrapper_launches_the_k1_or_k4_parents(gen):
    """The mma.sync route's exact mode (K1's kernel at 2..32 rows before the
    Hopper one) and the stream-K loop as K4 (K4's before), chip_smoke.py's
    yardsticks only: every route of the wrappers at 1..1919 rows (each
    matmul mode, act-order, f32 scales, the logits and the greedy head)
    leaves their C launch counts where they were."""
    from exllama_tpu_torch import kernels

    names = ("q4_gemv_tc_launches", "q4_gemv_tc_launches_f32",
             "dense_gemv_stream_launches")
    before = [kernels.launcher(n)() for n in names]
    for act in (False, True):
        qt = _qt(gen, 512, 264, 128, act)
        f32 = dataclasses.replace(qt, scales=qt.scales.float(),
                                  zscale=qt.zscale.float())
        for m in (1, 2, 9, 17, 32, 40):
            x = torch.randn((m, 512), generator=gen, device="cuda").bfloat16()
            for impl in ("auto", "pallas", "pallas_a8", "pallas_a8x2"):
                quant.q4_matmul(x, qt, impl=impl)
            quant.q4_matmul(x, f32)
    w = torch.randn((512, 1001), generator=gen, device="cuda").bfloat16()
    nw = torch.ones(512, dtype=torch.bfloat16, device="cuda")
    for m in (1, 8, 33, 300):
        x = torch.randn((1, m, 512), generator=gen, device="cuda").bfloat16()
        dense.dense_matmul(x, w)
        dense.head_argmax(x, nw, w, 1e-6)
    torch.cuda.synchronize()
    assert [kernels.launcher(n)() for n in names] == before


@pytest.mark.parametrize("m,k,v", [(1, 256, 1000), (5, 512, 130),
                                   (32, 128, 64), (1, 512, 1001),
                                   (3, 256, 257), (2, 128, 1),
                                   (32, 256, 2048)])
def test_head_argmax_matches_plain(gen, m, k, v):
    """The kernel's token is a maximum of the plain logits (within their
    f32 sum-order noise, 1e-4 of the scale); two calls give the same
    tokens; a duplicated maximum column resolves to the earlier index on
    both sides (at these shapes every tile's K splits at the same points,
    so the two columns' sums are the same f32 operations)."""
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    nw = (torch.rand(k, generator=gen, device="cuda") + 0.5).bfloat16()
    w = torch.randn((k, v), generator=gen, device="cuda").bfloat16()
    before = dense.head_argmax.launches
    got = dense.head_argmax(x, nw, w, 1e-6)
    assert dense.head_argmax.launches == before + 1
    assert torch.equal(got, dense.head_argmax(x, nw, w, 1e-6))
    assert got.shape == (m, 1) and got.dtype == torch.int32
    logits = dense.dense_gemv_plain(norms.rms_norm(x, nw, 1e-6), w)
    picked = logits.gather(1, got.long())[:, 0]
    assert (logits.amax(1) - picked).max() <= 1e-4 * logits.abs().max()
    # tie: copy row 0's winning column to column 0
    top = int(dense.head_argmax_plain(x[:1], nw, w, 1e-6)[0])
    w[:, 0] = w[:, top]
    assert int(dense.head_argmax(x[:1], nw, w, 1e-6)[0, 0]) == 0
    assert int(dense.head_argmax_plain(x[:1], nw, w, 1e-6)[0]) == 0
    if v % 2:
        # every logit below 0: the lane that owns column V - 1 must not let
        # its empty second column (0) win
        neg = -w.abs()
        got = dense.head_argmax(x.abs(), nw, neg, 1e-6)
        ref = dense.head_argmax_plain(x.abs(), nw, neg, 1e-6)
        logits = dense.dense_gemv_plain(norms.rms_norm(x.abs(), nw, 1e-6), neg)
        assert (logits < 0).all() and (got[:, 0] < v).all()
        picked = logits.gather(1, got.long())[:, 0]
        assert (logits.amax(1) - picked).max() <= 1e-4 * logits.abs().max()
        assert ref.shape == (m,)


@pytest.mark.parametrize("m", [1, 2, 8, 32])
@pytest.mark.parametrize("v", [32000, 32001])
def test_head_argmax_exact_ties_at_llama_widths(gen, m, v):
    """K = 4096 at Llama-7B's vocab (and one token more): rows of +-1 with
    norm weights 1 normalize to +-1 exactly and integer weights give
    integer logits, so every path's sums are exact: the kernel's tokens
    equal the plain argmax, ties included -- row 0's maximum planted in
    columns 255 and 256 (two tiles, split at other points) goes to 255 --
    and two calls give the same tokens."""
    k = 4096
    x = torch.sign(torch.randn((m, k), generator=gen, device="cuda")).bfloat16()
    x[x == 0] = 1
    nw = torch.ones(k, dtype=torch.bfloat16, device="cuda")
    w = torch.randint(-3, 4, (k, v), generator=gen, device="cuda").bfloat16()
    w[:, 255] = w[:, 256] = 4 * x[0]
    got = dense.head_argmax(x, nw, w, 1e-6)
    assert torch.equal(got, dense.head_argmax(x, nw, w, 1e-6))
    assert int(got[0, 0]) == 255
    assert torch.equal(got[:, 0], dense.head_argmax_plain(x, nw, w, 1e-6))


@pytest.mark.parametrize("m,hidden,inter,gs", [
    (1, 512, 384, 32), (5, 1024, 1152, 128), (18, 256, 640, 64),
    (18, 1024, 2816, 128), (32, 512, 1408, 32),
    # the streaming GEMV's row tiles 8 (M = 2, 8) and 16
    (2, 1024, 1152, 128), (8, 512, 1408, 64), (13, 768, 1056, 32),
])
def test_q4_mlp_matches_plain(gen, m, hidden, inter, gs):
    """2e-2 of the output scale: K1's 1e-2 twice over (gate|up, then down),
    with the same bf16 cast points on both sides."""
    gateup = _qt(gen, hidden, 2 * inter, gs, False)
    down = _qt(gen, inter, hidden, gs, False)
    h = torch.randn((m, 1, hidden), generator=gen, device="cuda").bfloat16()
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    before = mlp.q4_mlp.launches
    got = mlp.q4_mlp(h, nw, gateup, down, 1e-6)
    assert mlp.q4_mlp.launches == before + 1
    _close(got, mlp.q4_mlp_plain(h, nw, gateup, down, 1e-6), 2e-2)


@pytest.mark.parametrize("entry,b,hkv,past,masked", [
    ("attn_block_o", 1, 8, 77, False),
    ("layer_tail", 1, 8, 0, False),
    ("layer_tail", 3, 2, [0, 7, 133], False),
    ("layer_step", 2, 2, 200, True),
    ("layer_step", 3, 8, [20, 7, 133], False),
    # 17..32 rows: the tensor-core GEMV phases at two m16 tiles
    ("layer_tail", 18, 2, [150] * 9 + [3] * 9, False),
    ("layer_step", 17, 8, 33, True),
])
def test_layer_tail_matches_plain(gen, entry, b, hkv, past, masked):
    """2e-2 of the output scale: K3's bf16 rounding of p plus the GEMV
    phases' group-sum order (see the K1 and K6 cases)."""
    hidden, heads, d, inter, s_max, gs = 1024, 8, 128, 1152, 256, 128

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.5).bfloat16()

    o = _qt(gen, hidden, hidden, gs, False)
    qkv = _qt(gen, hidden, (heads + 2 * hkv) * d, gs, False)
    gateup = _qt(gen, hidden, 2 * inter, gs, False)
    down = _qt(gen, inter, hidden, gs, False)
    h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
    kc, vc = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d)
    new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
    iw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    past_t = (past if isinstance(past, int)
              else torch.tensor(past, dtype=torch.int32, device="cuda"))
    sin, cos = rope.rope_tables(s_max, d, device="cuda")
    sin_t, cos_t = rope.slice_tables(sin, cos, past_t, 1)
    mask = None
    if masked:
        mask = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
        mask[0, :9] = False
    before = attn_block.layer_tail.launches
    if entry == "attn_block_o":
        args = (h, q, kc, vc, past_t, s_max, o, new_kv, mask)
        got = attn_block.attn_block_o(*args)
        ref = attn_block.attn_block_o_plain(*args)
    elif entry == "layer_tail":
        args = (h, q, kc, vc, past_t, s_max, o, nw, gateup, down, 1e-6,
                new_kv, mask)
        got = attn_block.layer_tail(*args)
        ref = attn_block.layer_tail_plain(*args)
    else:
        args = (h, qkv, iw, sin_t, cos_t, kc, vc, past_t, s_max, o, nw,
                gateup, down, 1e-6, heads, hkv, d, mask)
        got, kr, vr = attn_block.layer_step(*args)
        ref, kr_ref, vr_ref = attn_block.layer_step_plain(*args)
        _close(kr, kr_ref, 1e-2)
        _close(vr, vr_ref, 1e-2)
    assert attn_block.layer_tail.launches == before + 1
    _close(got, ref, 2e-2)


# the exact-mode K6 / K7 libraries and their parents' (-DPARENT=1)
_PARENT_LIBS = {"q4_mlp": "q4_mlp_stream", "layer_tail": "layer_tail_stream",
                "layer_tail_kvq": "layer_tail_stream_kvq"}
_PARENT_COUNTS = ("q4_mlp_stream_launches", "layer_tail_stream_launches",
                  "layer_tail_stream_kvq_launches")


def _on_parents(fn, monkeypatch, m, widest):
    """fn() (a K6 / K7 wrapper call in the exact mode) on the parents' C
    entries, the streaming GEMV, with their split scratch grown first."""
    from exllama_tpu_torch import kernels

    dev = torch.device("cuda", torch.cuda.current_device())
    quant.fused_gemv_scratch(dev, m, widest, tickets=1024)
    real = kernels.launcher
    with monkeypatch.context() as mp:
        mp.setattr(kernels, "launcher",
                   lambda name: real(_PARENT_LIBS.get(name, name)))
        return fn()


@pytest.mark.parametrize("gs", [32, 128])
@pytest.mark.parametrize("m", [1, 2, 8, 18, 24, 32])
def test_q4_mlp_hopper_rows_and_parent(gen, m, gs, monkeypatch):
    """The Hopper K6 at each of its row tiles (8: M = 1, 2, 8; 32: 18, 24,
    32) and both folds (gs 32: a fold a half slab): 2e-2 of the output
    scale against the plain version, and against its own decomposition
    (q4_mlp_split_plain with the plan); two calls bit-equal; its parent on
    the same inputs within the same limit, counted on its own C counter
    only."""
    from exllama_tpu_torch import kernels

    hidden, inter = 1024, 2816
    gateup = _qt(gen, hidden, 2 * inter, gs, False)
    down = _qt(gen, inter, hidden, gs, False)
    h = torch.randn((m, 1, hidden), generator=gen, device="cuda").bfloat16()
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    ref = mlp.q4_mlp_plain(h, nw, gateup, down, 1e-6)
    got = mlp.q4_mlp(h, nw, gateup, down, 1e-6)
    _close(got, ref, 2e-2)
    plan = mlp.q4_mlp_plan(m, hidden, inter, kernels.sm_count(h.device))
    _close(got, mlp.q4_mlp_split_plain(h, nw, gateup, down, 1e-6, plan=plan),
           2e-2)
    assert torch.equal(got, mlp.q4_mlp(h, nw, gateup, down, 1e-6))
    before = kernels.launcher("q4_mlp_stream_launches")()
    par = _on_parents(lambda: mlp.q4_mlp(h, nw, gateup, down, 1e-6),
                      monkeypatch, m, 2 * inter)
    torch.cuda.synchronize()
    assert kernels.launcher("q4_mlp_stream_launches")() == before + 1
    _close(par, ref, 2e-2)


@pytest.mark.parametrize("entry,b,hkv,kind,scales", [
    ("layer_tail", 8, 2, "bf16", "bf16"),
    ("layer_step", 8, 8, "bf16", "bf16"),
    ("layer_step", 1, 8, "bf16", "f32"),
    ("layer_tail", 2, 2, "int8", "f32"),
    ("layer_step", 8, 2, "int4", "bf16"),
])
def test_layer_tail_hopper_cases(gen, entry, b, hkv, kind, scales,
                                 monkeypatch):
    """The Hopper K7 at 8 rows (GQA 4 and 1), over f32 scales and the
    quantized caches, layer_step with its K/V rows (1e-2): 2e-2 of the
    output scale against the plain version; two calls bit-equal; the
    parent on the same inputs within the same limit."""
    hidden, heads, d, inter, s_max, gs = 1024, 8, 128, 1152, 256, 128

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.5).bfloat16()

    def qt(k, n):
        t = _qt(gen, k, n, gs, False)
        return t if scales == "bf16" else dataclasses.replace(
            t, scales=t.scales.float(), zscale=t.zscale.float())

    o, gateup, down = qt(hidden, hidden), qt(hidden, 2 * inter), qt(inter, hidden)
    qkv = qt(hidden, (heads + 2 * hkv) * d)
    h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
    if kind == "bf16":
        kc, vc, ks, vs = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d), None, None
    else:
        kc, vc, ks, vs = _quantized_cache(gen, kind, b, hkv, s_max, d, 230)
    new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
    iw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    past = torch.tensor([200 - 11 * i for i in range(b)], dtype=torch.int32,
                        device="cuda")
    sin_t, cos_t = rope.slice_tables(*rope.rope_tables(s_max, d, device="cuda"),
                                     past, 1)
    kw = dict(k_scale=ks, v_scale=vs)
    if entry == "layer_tail":
        args = (h, q, kc, vc, past, s_max, o, nw, gateup, down, 1e-6, new_kv)
        fn = lambda: attn_block.layer_tail(*args, **kw)  # noqa: E731
        ref = attn_block.layer_tail_plain(*args, **kw)
        got, again = fn(), fn()
    else:
        args = (h, qkv, iw, sin_t, cos_t, kc, vc, past, s_max, o, nw,
                gateup, down, 1e-6, heads, hkv, d)
        fn = lambda: attn_block.layer_step(*args, **kw)  # noqa: E731
        ref, kr_ref, vr_ref = attn_block.layer_step_plain(*args, **kw)
        (got, kr, vr), (again, _, _) = fn(), fn()
        _close(kr, kr_ref, 1e-2)
        _close(vr, vr_ref, 1e-2)
    _close(got, ref, 2e-2)
    assert torch.equal(got, again)
    if scales == "bf16":
        par = _on_parents(fn, monkeypatch, b, 2 * inter)
        _close(par if entry == "layer_tail" else par[0], ref, 2e-2)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_layer_tail_rows_do_not_depend_on_each_other(gen, kind):
    """The Hopper K7 at 8 rows with 2048 keys: row 0's output is bit-equal
    when the other rows' lengths, cache, queries and residuals change (the
    serving engine's batched requests must equal their runs alone; the
    attention ring's blocks then see other items before row 0's)."""
    hidden, heads, hkv, d, inter, s_max, gs, b = 1024, 8, 2, 128, 1152, 2048, 128, 8

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.5).bfloat16()

    o, gateup = _qt(gen, hidden, hidden, gs, False), _qt(gen, hidden, 2 * inter, gs, False)
    down = _qt(gen, inter, hidden, gs, False)
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    outs = []
    for trial in range(2):
        h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
        if kind == "bf16":
            kc, vc, ks, vs = (rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d),
                              None, None)
        else:
            kc, vc, ks, vs = _quantized_cache(gen, kind, b, hkv, s_max, d,
                                              s_max - 8)
        new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
        past = [1900 - 170 * i * (trial + 1) % 1500 for i in range(b)]
        if outs:   # row 0 as before, the other rows new
            h[0], q[0], kc[0], vc[0] = h0, q0, kc0, vc0
            new_kv[0][0], new_kv[1][0] = kn0, vn0
            if ks is not None:
                ks[0], vs[0] = ks0, vs0
        h0, q0, kc0, vc0 = h[0].clone(), q[0].clone(), kc[0].clone(), vc[0].clone()
        kn0, vn0 = new_kv[0][0].clone(), new_kv[1][0].clone()
        if ks is not None:
            ks0, vs0 = ks[0].clone(), vs[0].clone()
        past[0] = 1900
        pt = torch.tensor(past, dtype=torch.int32, device="cuda")
        outs.append(attn_block.layer_tail(h, q, kc, vc, pt, s_max, o, nw,
                                          gateup, down, 1e-6, new_kv,
                                          k_scale=ks, v_scale=vs)[0])
    assert torch.equal(outs[0], outs[1])


def test_no_wrapper_launches_the_k6_or_k7_parents(gen):
    """K6's and K7's parents (the streaming GEMV, -DPARENT=1 builds),
    chip_smoke.py's yardsticks only: the wrappers' exact-mode calls leave
    their C launch counts where they were."""
    from exllama_tpu_torch import kernels

    before = [kernels.launcher(n)() for n in _PARENT_COUNTS]
    hidden, inter, heads, d, s_max = 512, 640, 4, 128, 128
    gateup = _qt(gen, hidden, 2 * inter, 128, False)
    down = _qt(gen, inter, hidden, 128, False)
    o = _qt(gen, heads * d, hidden, 128, False)
    nw = torch.ones(hidden, dtype=torch.bfloat16, device="cuda")
    for b in (1, 8, 32):
        h = torch.randn((b, 1, hidden), generator=gen, device="cuda").bfloat16()
        mlp.q4_mlp(h, nw, gateup, down, 1e-6)
        q = torch.randn((b, 1, heads, d), generator=gen, device="cuda").bfloat16()
        kc = torch.randn((b, heads, s_max, d), generator=gen,
                         device="cuda").bfloat16()
        new_kv = (q[:, :, :heads], q[:, :, :heads])
        attn_block.layer_tail(h, q, kc, kc, 50, s_max, o, nw, gateup, down,
                              1e-6, new_kv)
        kq, vq, ks, vs = _quantized_cache(gen, "int8", b, heads, s_max, d, 60)
        attn_block.attn_block_o(h, q, kq, vq, 50, s_max, o, new_kv,
                                k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert [kernels.launcher(n)() for n in _PARENT_COUNTS] == before


@pytest.mark.parametrize("impl", ["pallas_a8", "pallas_a8x2"])
@pytest.mark.parametrize("m,hidden,inter,gs", [
    (1, 512, 384, 32), (5, 1024, 1152, 128), (18, 256, 640, 64),
])
def test_q4_mlp_a8_matches_plain(gen, m, hidden, inter, gs, impl):
    """K6 with K9's arithmetic: 2e-2, as the exact K6 case (gate|up is
    rounded to bf16 between the two GEMVs on both sides, and a step of
    difference there draws another int8 rounding in the down GEMV)."""
    gateup = _qt(gen, hidden, 2 * inter, gs, False)
    down = _qt(gen, inter, hidden, gs, False)
    h = torch.randn((m, 1, hidden), generator=gen, device="cuda").bfloat16()
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    before = mlp.q4_mlp_a8.launches, mlp.q4_mlp.launches
    got = mlp.q4_mlp(h, nw, gateup, down, 1e-6, impl)
    assert (mlp.q4_mlp_a8.launches, mlp.q4_mlp.launches) == (
        before[0] + 1, before[1])
    _close(got, mlp.q4_mlp_plain(h, nw, gateup, down, 1e-6, impl), 2e-2)


@pytest.mark.parametrize("impl", ["pallas_a8", "pallas_a8x2"])
@pytest.mark.parametrize("entry,b,hkv,past,masked", [
    ("attn_block_o", 1, 8, 77, False),
    ("layer_tail", 3, 2, [0, 7, 133], False),
    ("layer_step", 2, 2, 200, True),
])
def test_layer_tail_a8_matches_plain(gen, entry, b, hkv, past, masked, impl):
    """K7 with K9's arithmetic in every GEMV phase. a8x2: 2e-2, as the
    exact K7 cases. One-pass a8: 5e-2, the JAX suite's own limit for its
    fused layer kernel in a8 (tests/test_attn_block.py:478) -- the kernel's
    attention row differs from the plain one by bf16 steps (K3's reason),
    and a step of difference in a GEMV's input draws other int8 roundings
    (3.3% measured on an H100 at these shapes; the GEMV itself is held to
    5e-3 in test_q4_gemv_a8_matches_plain)."""
    hidden, heads, d, inter, s_max, gs = 1024, 8, 128, 1152, 256, 128
    tol = 5e-2 if impl == "pallas_a8" else 2e-2

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.5).bfloat16()

    o = _qt(gen, hidden, hidden, gs, False)
    qkv = _qt(gen, hidden, (heads + 2 * hkv) * d, gs, False)
    gateup = _qt(gen, hidden, 2 * inter, gs, False)
    down = _qt(gen, inter, hidden, gs, False)
    h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
    kc, vc = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d)
    new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
    iw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    past_t = (past if isinstance(past, int)
              else torch.tensor(past, dtype=torch.int32, device="cuda"))
    sin_t, cos_t = rope.slice_tables(*rope.rope_tables(s_max, d,
                                                       device="cuda"),
                                     past_t, 1)
    mask = None
    if masked:
        mask = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
        mask[0, :9] = False
    before = attn_block.layer_tail_a8.launches, attn_block.layer_tail.launches
    if entry == "attn_block_o":
        args = (h, q, kc, vc, past_t, s_max, o, new_kv, mask, impl)
        got = attn_block.attn_block_o(*args)
        ref = attn_block.attn_block_o_plain(*args)
    elif entry == "layer_tail":
        args = (h, q, kc, vc, past_t, s_max, o, nw, gateup, down, 1e-6,
                new_kv, mask, impl)
        got = attn_block.layer_tail(*args)
        ref = attn_block.layer_tail_plain(*args)
    else:
        args = (h, qkv, iw, sin_t, cos_t, kc, vc, past_t, s_max, o, nw,
                gateup, down, 1e-6, heads, hkv, d, mask, impl)
        got, kr, vr = attn_block.layer_step(*args)
        ref, kr_ref, vr_ref = attn_block.layer_step_plain(*args)
        _close(kr, kr_ref, 1e-2)
        _close(vr, vr_ref, 1e-2)
    assert (attn_block.layer_tail_a8.launches,
            attn_block.layer_tail.launches) == (before[0] + 1, before[1])
    _close(got, ref, tol)


def _planted(gen, b, heads, hkv, s_max, past, n_pad, device="cuda"):
    """Peaked decode attention whose special keys carry real weight (as
    chip_smoke.planted_attention): q ~ 4 N(0, 1); per (row, kv head) group,
    a planted key is a * u, u the unit direction of its summed queries;
    the in-flight K row scores best - 1 on the group's mean head, row 0's
    first n_pad keys are padding that score best + 8 on its least aligned
    head (best: the group's best score over keys n_pad..past)."""
    d, g = 128, heads // hkv

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).bfloat16()

    q, kc, vc = (rnd(b, 1, heads, d, scale=4.0), rnd(b, hkv, s_max, d),
                 rnd(b, hkv, s_max, d))
    vn = rnd(b, 1, hkv, d)
    qg = q.float().reshape(b, hkv, g, d)
    u = qg.sum(2)
    u = u / u.norm(dim=-1, keepdim=True)
    per_unit = (qg * u[:, :, None]).sum(-1) / d ** 0.5
    best = (torch.einsum("bhgd,bhsd->bhgs", qg, kc[:, :, n_pad:past].float())
            / d ** 0.5).amax((2, 3))
    kn = (((best - 1) / per_unit.mean(2))[..., None] * u)[:, None].bfloat16()
    mask = None
    if n_pad:
        mask = torch.ones((b, s_max), dtype=torch.bool, device=device)
        mask[0, :n_pad] = False
        a = (best[0] + 8) / per_unit[0].amin(1)
        kc[0, :, :n_pad] = (a[:, None, None] * u[0][:, None, :]).bfloat16()
    return q, kc, vc, (kn, vn), mask


@pytest.mark.parametrize("b,hkv,n_pad", [(1, 8, 0), (2, 2, 9)])
def test_attn_block_o_attention_at_its_own_scale(gen, b, hkv, n_pad):
    """h = 0, so the output is o-proj(attention) alone, on a peaked softmax
    whose in-flight row and padded keys carry real weight: 2e-2 of the
    output scale (as above), while each fault K7 could make -- the in-flight
    row dropped, the pad bias left out, one key split (K7's second of four
    here: keys 128-255) lost -- moves the plain output by more than 3x
    that."""
    hidden, heads, s_max, past = 1024, 8, 512, 400
    o = _qt(gen, hidden, hidden, 128, False)
    q, kc, vc, new_kv, mask = _planted(gen, b, heads, hkv, s_max, past, n_pad)
    h = torch.zeros((b, 1, hidden), dtype=torch.bfloat16, device="cuda")
    ref = attn_block.attn_block_o_plain(h, q, kc, vc, past, s_max, o, new_kv,
                                        mask).float()
    lost = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
    lost[:, 128:256] = False
    faults = [((-new_kv[0], new_kv[1]), mask),
              (new_kv, lost if mask is None else lost & mask)]
    if mask is not None:
        faults.append((new_kv, None))
    for kv, m in faults:
        moved = attn_block.attn_block_o_plain(h, q, kc, vc, past, s_max, o,
                                              kv, m).float() - ref
        assert moved.abs().max() > 3 * 2e-2 * ref.abs().max()
    before = attn_block.layer_tail.launches
    got = attn_block.attn_block_o(h, q, kc, vc, past, s_max, o, new_kv, mask)
    assert attn_block.layer_tail.launches == before + 1
    _close(got, ref, 2e-2)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_kv_commit_per_row_cursor_matches_plain(gen, kind):
    """Bit-equal: K8 with a [B] cursor in device memory -- one launch, no
    host sync -- against the plain writes at the same cursor tensor; a row
    whose cursor is outside [0, S) is left as it was by both."""
    n_layers, b, hkv, s_max, d = 3, 4, 4, 64, 128
    dc = d // 2 if kind == "int4" else d
    if kind == "bf16":
        caches = [torch.randn((b, hkv, s_max, d), generator=gen,
                              device="cuda").bfloat16()
                  for _ in range(2 * n_layers)]
        scales = []
    else:
        caches = [torch.randint(-128, 128, (b, hkv, s_max, dc), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2 * n_layers)]
        scales = [torch.rand((b, hkv, s_max), generator=gen, device="cuda")
                  for _ in range(2 * n_layers)]
    ref = [t.clone() for t in caches + scales]
    before_all = [t.clone() for t in caches + scales]
    rows = torch.randn((2, n_layers, b, 1, hkv, d), generator=gen,
                       device="cuda").bfloat16()
    past = torch.tensor([5, 63, s_max, -1], dtype=torch.int32, device="cuda")
    before = attention.kv_commit.launches + (
        0 if kind == "bf16" else getattr(attention.kv_commit,
                                         f"launches_{kind}"))
    attention.commit_kv_cache(
        caches[:n_layers], caches[n_layers:], rows[0], rows[1], past,
        scales[:n_layers] or None, scales[n_layers:] or None, impl="pallas")
    after = attention.kv_commit.launches + (
        0 if kind == "bf16" else getattr(attention.kv_commit,
                                         f"launches_{kind}"))
    assert after == before + 1
    attention.commit_kv_cache(
        ref[:n_layers], ref[n_layers:2 * n_layers], rows[0], rows[1], past,
        ref[2 * n_layers:3 * n_layers] or None, ref[3 * n_layers:] or None,
        impl="xla")
    for got, want, old in zip(caches + scales, ref, before_all):
        assert torch.equal(got, want)
        assert torch.equal(got[2:], old[2:])   # rows 2, 3: outside, kept
        assert not torch.equal(got[:2], old[:2])


def test_kv_commit_matches_plain(gen):
    """Exact: a copy of bf16 rows, here against the per-layer plain writes."""
    n_layers, b, hkv, s_max, d, past = 3, 2, 4, 64, 128, 37
    caches = [torch.randn((b, hkv, s_max, d), generator=gen,
                          device="cuda").bfloat16() for _ in range(2 * n_layers)]
    ref = [c.clone() for c in caches]
    nk = torch.randn((n_layers, b, 1, hkv, d), generator=gen,
                     device="cuda").bfloat16()
    nv = torch.randn_like(nk)
    before = attention.kv_commit.launches
    attention.commit_kv_cache(caches[:n_layers], caches[n_layers:], nk, nv,
                              past, impl="pallas")
    assert attention.kv_commit.launches == before + 1
    attention.commit_kv_cache(ref[:n_layers], ref[n_layers:], nk, nv, past,
                              impl="xla")
    for got, want in zip(caches, ref):
        assert torch.equal(got, want)


# ------------------------------------------------ quantized KV caches

def _quantized_cache(gen, kind, b, hkv, s_max, d, filled, spread=True):
    """int8 / int4 caches and their scales, written by the plain
    update_kv_cache from rows whose magnitudes differ by up to x8 with
    ``spread`` (so the per-key scales matter); positions from ``filled`` on
    stay zero."""
    dc = d // 2 if kind == "int4" else d
    kc = torch.zeros((b, hkv, s_max, dc), dtype=torch.int8, device="cuda")
    vc = torch.zeros_like(kc)
    ks = torch.zeros((b, hkv, s_max), dtype=torch.float32, device="cuda")
    vs = torch.zeros_like(ks)

    def rows():
        mag = 2.0 ** torch.randint(-2 if spread else 0, 2 if spread else 1,
                                   (b, filled, hkv, 1), generator=gen,
                                   device="cuda")
        return (torch.randn((b, filled, hkv, d), generator=gen, device="cuda")
                * mag).bfloat16()

    attention.update_kv_cache(kc, vc, rows(), rows(), 0, ks, vs)
    return kc, vc, ks, vs


def _flat_scales(s, filled):
    out = s.clone()
    out[:, :, :filled] = s[:, :, :filled].mean(dim=2, keepdim=True)
    return out


def _swap_int4_halves(c):
    raw = attention.unpack_kv4(c, torch.float32).to(torch.int32)
    half = raw.shape[-1] // 2
    b4 = (raw[..., half:] + 8) | (((raw[..., :half] + 8) ^ 8) << 4)
    return torch.where(b4 >= 128, b4 - 256, b4).to(torch.int8)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("b,t,h,hkv,d,past,deferred,masked", [
    (2, 1, 8, 2, 64, 170, True, False),
    (1, 1, 4, 4, 128, 0, True, False),
    (2, 37, 8, 2, 64, [5, 140], False, False),
    (2, 19, 4, 1, 128, 0, False, True),
    (1, 130, 4, 4, 128, 3, False, False),
    (4, 1, 8, 2, 128, [1, 64, 127, 179], True, False),
    (2, 1, 8, 2, 64, [65, 150], True, True),
    (2, 2, 8, 2, 128, [30, 120], False, False),
    (2, 1, 8, 2, 256, [65, 150], True, True),
    (2, 37, 8, 2, 256, [5, 140], False, False),
])
def test_flash_attn_quantized_matches_plain(gen, kind, b, t, h, hkv, d, past,
                                            deferred, masked):
    """K3 over an int8 / int4 cache: 2e-2, as over bf16 -- kernel and plain
    version read the same bytes and scales, and round p (with the V scale
    folded in) to bf16 against a running and a final max. The plain version
    first shows that per-key K or V scales replaced by their mean, and
    swapped int4 halves, each move the output by more than 3x that."""
    s_max, attend_len, filled = 256, 192, 180
    kc, vc, ks, vs = _quantized_cache(gen, kind, b, hkv, s_max, d, filled)
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16()
    past_t = (past if isinstance(past, int)
              else torch.tensor(past, dtype=torch.int32, device="cuda"))
    new_kv = None
    if deferred:
        new_kv = tuple(torch.randn((b, 1, hkv, d), generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(2))
    mask = None
    if masked:
        mask = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
        mask[0, :6] = False
    args = (q, kc, vc, past_t, attend_len, mask, new_kv)
    ref = attention.attend_plain(*args, ks, vs)
    if past != 0:
        faults = [attention.attend_plain(*args, _flat_scales(ks, filled), vs),
                  attention.attend_plain(*args, ks, _flat_scales(vs, filled))]
        if kind == "int4":
            faults.append(attention.attend_plain(
                q, kc, _swap_int4_halves(vc), *args[3:], ks, vs))
        for out in faults:
            assert (out.float() - ref.float()).abs().max() \
                > 3 * 2e-2 * ref.float().abs().max()
    before = (attention.attend.launches, attention.attend.launches_int8,
              attention.attend.launches_int4)
    got = attention.attend(*args, ks, vs)
    after = (attention.attend.launches, attention.attend.launches_int8,
             attention.attend.launches_int4)
    assert after == (before[0], before[1] + (kind == "int8"),
                     before[2] + (kind == "int4"))
    _close(got, ref, 2e-2)


@pytest.mark.parametrize("n", [64, 128, 256])
@pytest.mark.parametrize("k", [16, 64, 128])
def test_wgmma_transposed_b_product(gen, n, k):
    """hop::Mma's transposed-B product alone (K3's O += P V: B read MN-major
    through hopper.cuh:mnmajor_sw128 from 128-byte swizzled boxes of 64
    columns) on planted small integers, so that the f32 product is exact:
    bit-equal to the plain product; each k-row and column is distinct, so a
    wrong stride between the 8-row atoms or the 64-column boxes moves it."""
    from exllama_tpu_torch import kernels

    a = torch.randint(-3, 4, (64, k), generator=gen, device="cuda").bfloat16()
    b = torch.randint(-3, 4, (k, n), generator=gen, device="cuda").bfloat16()
    b[torch.arange(k), torch.arange(k) % n] = 8.0     # a planted diagonal
    out = torch.full((64, n), float("nan"), device="cuda")
    kernels.check(kernels.launcher("flash_attn_tnsp_check")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), k, n,
        kernels.stream_of(a)), "flash_attn_tnsp_check")
    torch.cuda.synchronize()
    assert torch.equal(out, a.float() @ b.float())


# K3's prefill path on Hopper at the main path's chunks, narrow: T = 1919
# from 0, 64- and 127-row chunks behind a cursor, a left-padded batch, GQA-8
# (g = 4) behind a cursor
PREFILL_CASES = [
    (1, 1919, 2, 2, 0, 2048, False),
    (2, 64, 4, 4, [1000, 1100], 1280, False),
    (1, 127, 2, 2, 300, 512, False),
    (2, 64, 4, 4, 0, 256, True),
    (1, 512, 32, 8, 300, 1024, False),
]


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,t,h,hkv,past,alen,masked", PREFILL_CASES)
def test_flash_prefill_matches_plain(gen, b, t, h, hkv, past, alen, masked,
                                     d, kind):
    """The prefill kernel (csrc/flash_prefill_wg.cuh) against attend_plain
    at K3's 2e-2, after the plain decomposition has shown that a dropped
    causal mask, the V scale also on l and swapped int4 halves each move
    the output by more than 3x that; its launch counts on the prefill
    counter of its cache format, and its parent's C counter stays put."""
    from exllama_tpu_torch import kernels

    s_max = 2048
    if kind == "bf16":
        kc = torch.randn((b, hkv, s_max, d), generator=gen,
                         device="cuda").bfloat16()
        vc = torch.randn_like(kc)
        ks = vs = None
    else:
        kc, vc, ks, vs = _quantized_cache(gen, kind, b, hkv, s_max, d, s_max)
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16()
    past_t = (past if isinstance(past, int)
              else torch.tensor(past, dtype=torch.int32, device="cuda"))
    mask = None
    if masked:
        mask = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
        mask[0, :17] = False
    args = (q, kc, vc, past_t, alen, mask)
    ref = attention.attend_plain(*args, None, ks, vs)
    scale = ref.float().abs().max()
    faults = [attention.attend_plain(q, kc, vc, past_t + t - 1, alen, mask,
                                     None, ks, vs)]
    if kind != "bf16":
        faults.append(attention.attend_prefill_tiles_plain(
            *args, ks, vs, fault="v_scale_on_l"))
    if kind == "int4":
        faults.append(attention.attend_prefill_tiles_plain(
            *args, ks, vs, fault="halves"))
    for out in faults:
        assert (out.float() - ref.float()).abs().max() > 3 * 2e-2 * scale
    lib = "flash_attn_d256" if d == 256 else "flash_attn"
    parent = kernels.launcher(f"{lib}_prefill_fa2_launches")()
    counter = "launches_prefill" + ("" if kind == "bf16" else f"_{kind}")
    before = getattr(attention.attend, counter)
    got = attention.attend(*args, None, ks, vs)
    assert getattr(attention.attend, counter) == before + 1
    _close(got, ref, 2e-2)
    torch.cuda.synchronize()
    assert kernels.launcher(f"{lib}_prefill_fa2_launches")() == parent


def test_no_wrapper_launches_the_k3_prefill_or_k5_parents(gen):
    """K3's prefill parent (FlashAttention-2 tiles on mma.sync, both head-dim
    libraries) and K5's (the stream-K loop), chip_smoke.py's yardsticks
    only: the wrappers' prefill and greedy-head routes leave their C launch
    counts where they were."""
    from exllama_tpu_torch import kernels

    names = ("flash_attn_prefill_fa2_launches",
             "flash_attn_d256_prefill_fa2_launches",
             "head_argmax_stream_launches")
    before = [kernels.launcher(n)() for n in names]
    for d in (64, 128, 256):
        kc = torch.randn((1, 2, 256, d), generator=gen,
                         device="cuda").bfloat16()
        for t in (17, 64, 200):
            q = torch.randn((1, t, 2, d), generator=gen,
                            device="cuda").bfloat16()
            attention.attend(q, kc, kc, 0, 256)
    w = torch.randn((512, 1001), generator=gen, device="cuda").bfloat16()
    nw = torch.ones(512, dtype=torch.bfloat16, device="cuda")
    for m in (1, 8, 32):
        x = torch.randn((1, m, 512), generator=gen, device="cuda").bfloat16()
        dense.head_argmax(x, nw, w, 1e-6)
    torch.cuda.synchronize()
    assert [kernels.launcher(n)() for n in names] == before


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("entry,b,hkv,past,masked,impl", [
    case + (impl,)
    for case in (("attn_block_o", 1, 8, 177, False),
                 ("layer_tail", 3, 2, [0, 7, 133], False),
                 ("layer_step", 2, 2, 200, True))
    for impl in ("auto", "pallas_a8", "pallas_a8x2")
    if (case[0], impl) != ("layer_step", "pallas_a8")
])
def test_layer_tail_quantized_matches_plain(gen, entry, b, hkv, past, masked,
                                            impl, kind):
    """K7's three entry points over an int8 / int4 cache, exact and W4A8
    GEMVs: the limits of the bf16 cache (2e-2; one-pass a8 5e-2). One-pass
    a8 is not held on layer_step here: its q comes from an int8-activation
    GEMV, the keys' magnitudes differ by up to x8, and a bf16 step of
    difference in q then moves a peaked softmax by more than a8's limit (8%
    and 11% measured on an H100, where a8x2, exact-grade through the same
    attention code, stays inside 2e-2)."""
    hidden, heads, d, inter, s_max, gs = 1024, 8, 128, 1152, 256, 128
    tol = 5e-2 if impl == "pallas_a8" else 2e-2

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.5).bfloat16()

    o = _qt(gen, hidden, hidden, gs, False)
    qkv = _qt(gen, hidden, (heads + 2 * hkv) * d, gs, False)
    gateup = _qt(gen, hidden, 2 * inter, gs, False)
    down = _qt(gen, inter, hidden, gs, False)
    h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
    kc, vc, ks, vs = _quantized_cache(gen, kind, b, hkv, s_max, d, 220)
    new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
    iw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    past_t = (past if isinstance(past, int)
              else torch.tensor(past, dtype=torch.int32, device="cuda"))
    sin_t, cos_t = rope.slice_tables(*rope.rope_tables(s_max, d,
                                                       device="cuda"),
                                     past_t, 1)
    mask = None
    if masked:
        mask = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
        mask[0, :9] = False
    fn = attn_block.layer_tail if impl == "auto" \
        else attn_block.layer_tail_a8
    attr = f"launches_{kind}"
    before = getattr(fn, attr), fn.launches
    if entry == "attn_block_o":
        args = (h, q, kc, vc, past_t, s_max, o, new_kv, mask, impl, ks, vs)
        got = attn_block.attn_block_o(*args)
        ref = attn_block.attn_block_o_plain(*args)
    elif entry == "layer_tail":
        args = (h, q, kc, vc, past_t, s_max, o, nw, gateup, down, 1e-6,
                new_kv, mask, impl, ks, vs)
        got = attn_block.layer_tail(*args)
        ref = attn_block.layer_tail_plain(*args)
    else:
        args = (h, qkv, iw, sin_t, cos_t, kc, vc, past_t, s_max, o, nw,
                gateup, down, 1e-6, heads, hkv, d, mask, impl, ks, vs)
        got, kr, vr = attn_block.layer_step(*args)
        ref, kr_ref, vr_ref = attn_block.layer_step_plain(*args)
        _close(kr, kr_ref, 1e-2)
        _close(vr, vr_ref, 1e-2)
    assert (getattr(fn, attr), fn.launches) == (before[0] + 1, before[1])
    _close(got, ref, tol)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("impl", ["auto", "pallas_a8", "pallas_a8x2"])
@pytest.mark.parametrize("b", [1, 2, 8])
def test_layer_tail_rows_modes_caches_bits(gen, b, impl, kind):
    """K7 (layer_tail, each row its own cursor) at B = 1 -- the streaming
    GEMV phases and the last-block merge of the key splits -- and at B = 2
    and 8 (the tensor-core GEMV phases), in each GEMV mode over each cache
    format: the limits above (2e-2; one-pass a8 5e-2), and two calls on the
    same inputs give the same bits (every split is combined in a fixed
    order). One-pass a8 over an int8 / int4 cache is held to 1e-1: its
    error there is a8's own noise through a quantized attention row -- a
    bf16 step of difference in the o-projection's input draws other int8
    roundings -- which puts two correct a8 implementations 5-10% apart
    (CHANGES.md, slice 3); on these inputs at B = 8 the kernel before the
    K split sat at the same 6.3% (scripts/k7_a8_parent_check.py). The
    caches' rows are N(0, 1), as in chip_smoke's K7 cases."""
    hidden, heads, d, inter, s_max, gs, hkv = 1024, 8, 128, 1152, 256, 128, 2
    tol = 2e-2 if impl != "pallas_a8" else 5e-2 if kind == "bf16" else 1e-1

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.5).bfloat16()

    o = _qt(gen, hidden, hidden, gs, False)
    gateup = _qt(gen, hidden, 2 * inter, gs, False)
    down = _qt(gen, inter, hidden, gs, False)
    h, q = rnd(b, 1, hidden), rnd(b, 1, heads, d)
    if kind == "bf16":
        kc, vc, ks, vs = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d), None, None
    else:
        kc, vc, ks, vs = _quantized_cache(gen, kind, b, hkv, s_max, d, 220,
                                          spread=False)
    new_kv = (rnd(b, 1, hkv, d), rnd(b, 1, hkv, d))
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    past = torch.tensor([200 - 23 * i for i in range(b)], dtype=torch.int32,
                        device="cuda")
    args = (h, q, kc, vc, past, s_max, o, nw, gateup, down, 1e-6, new_kv,
            None, impl, ks, vs)
    got = attn_block.layer_tail(*args)
    assert torch.equal(got, attn_block.layer_tail(*args))
    _close(got, attn_block.layer_tail_plain(*args), tol)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("b,hkv,n_pad", [(1, 8, 0), (2, 2, 9)])
def test_attn_block_o_quantized_attention_at_its_own_scale(gen, kind, b, hkv,
                                                           n_pad):
    """h = 0 and a peaked softmax over a quantized cache (planted keys, as
    test_attn_block_o_attention_at_its_own_scale, then quantized): 2e-2,
    while the per-key K or V scales replaced by their mean, swapped int4
    halves, a dropped in-flight row and a lost key split each move the plain
    output by more than 3x that."""
    hidden, heads, s_max, past = 1024, 8, 512, 400
    o = _qt(gen, hidden, hidden, 128, False)
    q, kcb, vcb, new_kv, mask = _planted(gen, b, heads, hkv, s_max, past,
                                         n_pad)
    # rows of unequal size, so that the scales differ from key to key
    mag = 2.0 ** torch.randint(-2, 2, (b, hkv, s_max, 1), generator=gen,
                               device="cuda")
    vcb = (vcb.float() * mag).bfloat16()
    dc = 64 if kind == "int4" else 128
    kc = torch.zeros((b, hkv, s_max, dc), dtype=torch.int8, device="cuda")
    vc = torch.zeros_like(kc)
    ks = torch.zeros((b, hkv, s_max), dtype=torch.float32, device="cuda")
    vs = torch.zeros_like(ks)
    attention.update_kv_cache(kc, vc, kcb.transpose(1, 2), vcb.transpose(1, 2),
                              0, ks, vs)
    h = torch.zeros((b, 1, hidden), dtype=torch.bfloat16, device="cuda")

    def plain(kc=kc, vc=vc, ks=ks, vs=vs, kv=new_kv, m=mask):
        return attn_block.attn_block_o_plain(
            h, q, kc, vc, past, s_max, o, kv, m, "auto", ks, vs).float()

    ref = plain()
    lost = torch.ones((b, s_max), dtype=torch.bool, device="cuda")
    lost[:, 128:256] = False
    faults = [plain(vs=_flat_scales(vs, past)),
              plain(kv=(-new_kv[0], new_kv[1])),
              plain(m=lost if mask is None else lost & mask)]
    if kind == "int4":
        faults.append(plain(vc=_swap_int4_halves(vc)))
    for out in faults:
        assert (out - ref).abs().max() > 3 * 2e-2 * ref.abs().max()
    got = attn_block.attn_block_o(h, q, kc, vc, past, s_max, o, new_kv, mask,
                                  "auto", ks, vs)
    _close(got, ref, 2e-2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_kv_commit_quantized_matches_plain(gen, kind, d):
    """Bit-equal: the kernel quantizes each row as quantize_kv_rows /
    quantize_kv_rows4 do (a true division, round half to even), bytes and
    f32 scales, with an all-zero row and half-way values among the rows."""
    n_layers, b, hkv, s_max, past = 3, 2, 4, 64, 37
    dc = d // 2 if kind == "int4" else d
    caches = [torch.randint(-128, 128, (b, hkv, s_max, dc), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2 * n_layers)]
    scales = [torch.rand((b, hkv, s_max), generator=gen, device="cuda")
              for _ in range(2 * n_layers)]
    ref_c = [c.clone() for c in caches]
    ref_s = [s.clone() for s in scales]
    nk = torch.randn((n_layers, b, 1, hkv, d), generator=gen,
                     device="cuda").bfloat16()
    nv = torch.randn_like(nk)
    nk[0, 0, 0, 0] = 0
    half_way = ((torch.arange(d, device="cuda") % 14 - 7) + 0.5) * 0.5
    nk[0, 0, 0, 1] = half_way
    nk[0, 0, 0, 1, 0] = 63.5 if kind == "int8" else 3.5     # scale 0.5
    before = getattr(attention.kv_commit, f"launches_{kind}")
    attention.commit_kv_cache(
        caches[:n_layers], caches[n_layers:], nk, nv, past,
        scales[:n_layers], scales[n_layers:], impl="pallas")
    assert getattr(attention.kv_commit, f"launches_{kind}") == before + 1
    attention.commit_kv_cache(
        ref_c[:n_layers], ref_c[n_layers:], nk, nv, past,
        ref_s[:n_layers], ref_s[n_layers:], impl="xla")
    for got, want in zip(caches + scales, ref_c + ref_s):
        assert torch.equal(got, want)
    assert not torch.equal(caches[0][:, :, past], caches[0][:, :, past - 1])


# ------------------------------------------------- f32 scales, the xla path

def _f32(qt, gen):
    """qt with f32 scales carrying bits below bf16's (scale_dtype="f32")."""
    def widen(t):
        u = torch.rand(t.shape, generator=gen, device=t.device) - 0.5
        return t.float() * (1.0 + u * 2.0 ** -8)
    return dataclasses.replace(qt, scales=widen(qt.scales),
                               zscale=widen(qt.zscale))


def _one_f32_launch(fn, call):
    """call() launches fn's f32-scale build once: launches_f32 + 1,
    launches unchanged."""
    before = fn.launches, fn.launches_f32
    out = call()
    assert (fn.launches, fn.launches_f32) == (before[0], before[1] + 1)
    return out


@pytest.mark.parametrize("m,k,n,gs,act,norm", [
    (1, 512, 520, 128, False, True), (1, 1024, 264, 256, False, False),
    (5, 512, 200, 64, True, False), (18, 2048, 384, 128, False, True),
])
def test_q4_gemv_f32_scales_match_plain(gen, m, k, n, gs, act, norm):
    """K1's f32-scale build (both routes) at K1's 1e-2, and K9's (a8,
    a8x2) at 5e-3 against the unrounded plain sums."""
    qt = _f32(_qt(gen, k, n, gs, act), gen)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    nw = (torch.rand(k, generator=gen, device="cuda") + 0.5).bfloat16() \
        if norm else None
    got = _one_f32_launch(quant.q4_gemv,
                          lambda: quant.q4_gemv(x, qt, nw, 1e-5))
    _close(got, quant.q4_gemv_plain(x, qt, nw, 1e-5), 1e-2)
    for two_pass in (False, True):
        got = _one_f32_launch(quant.q4_gemv_a8, lambda: quant.q4_gemv_a8(
            x, qt, nw, 1e-5, two_pass=two_pass))
        _close(got, quant.q4_gemv_a8_plain(x, qt, nw, 1e-5, two_pass,
                                           torch.float32), 5e-3)


@pytest.mark.parametrize("m,k,n,gs", [(33, 256, 520, 32), (257, 512, 260, 128),
                                      (1919, 320, 136, 64)])
def test_ring_f32_scales_match_plain(gen, m, k, n, gs):
    """K2 (1e-2), K10 (5e-3, unrounded plain) and K12 (1e-2) in their
    f32-scale builds, N off a multiple of 8 included."""
    qt = _f32(_qt(gen, k, n, gs, False), gen)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    got = _one_f32_launch(quant.q4_dequant_matmul,
                          lambda: quant.q4_dequant_matmul(x, qt))
    _close(got, quant._q4_matmul_plain(x, qt), 1e-2)
    ws = w8_col_scale(qt)
    got = _one_f32_launch(quant.q4_prefill_a8,
                          lambda: quant.q4_prefill_a8(x, qt, ws))
    _close(got, quant.q4_prefill_a8_plain(x, qt, ws, torch.float32), 5e-3)
    xg = torch.randn((m, 2 * k), generator=gen, device="cuda").bfloat16()
    got = _one_f32_launch(quant.q4_matmul_glu,
                          lambda: quant.q4_matmul_glu(xg, qt, k, k))
    _close(got, quant.q4_matmul_glu_plain(xg, qt, k, k), 1e-2)


@pytest.mark.parametrize("m", [1, 18])
def test_q4_mlp_and_layer_tail_f32_scales_match_plain(gen, m):
    """K6 and K7 (layer_step at B = m) in their f32-scale builds, 2e-2 as
    the bf16 builds."""
    hidden, heads, hkv, d, inter, s_max, gs = 1024, 8, 2, 128, 1152, 256, 128
    gateup = _f32(_qt(gen, hidden, 2 * inter, gs, False), gen)
    down = _f32(_qt(gen, inter, hidden, gs, False), gen)
    nw = (torch.rand(hidden, generator=gen, device="cuda") + 0.5).bfloat16()
    h = torch.randn((m, 1, hidden), generator=gen, device="cuda").bfloat16()
    got = _one_f32_launch(mlp.q4_mlp,
                          lambda: mlp.q4_mlp(h, nw, gateup, down, 1e-6))
    _close(got, mlp.q4_mlp_plain(h, nw, gateup, down, 1e-6), 2e-2)

    o = _f32(_qt(gen, hidden, hidden, gs, False), gen)
    qkv = _f32(_qt(gen, hidden, (heads + 2 * hkv) * d, gs, False), gen)

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.5).bfloat16()

    kc, vc = rnd(m, hkv, s_max, d), rnd(m, hkv, s_max, d)
    sin, cos = rope.rope_tables(s_max, d, device="cuda")
    sin_t, cos_t = rope.slice_tables(sin, cos, 100, 1)
    args = (h * 0.5, qkv, nw, sin_t, cos_t, kc, vc, 100, s_max, o, nw,
            gateup, down, 1e-6, heads, hkv, d, None)
    got, kr, vr = _one_f32_launch(attn_block.layer_tail,
                                  lambda: attn_block.layer_step(*args))
    ref, kr_ref, vr_ref = attn_block.layer_step_plain(*args)
    _close(kr, kr_ref, 1e-2)
    _close(got, ref, 2e-2)


def test_xla_runs_no_kernel_on_the_card(gen):
    """matmul_impl="xla" on CUDA tensors is the plain path: the 4-bit and
    lm_head wrappers launch nothing, and the result is the plain version's."""
    qt = _qt(gen, 512, 264, 128, True)
    w = (torch.randn((512, 1000), generator=gen, device="cuda")
         * 0.02).bfloat16()
    counters = (quant.q4_gemv, quant.q4_dequant_matmul, dense.dense_gemv,
                dense.head_argmax)
    before = [f.launches for f in counters]
    for m in (1, 40):
        x = torch.randn((m, 512), generator=gen, device="cuda").bfloat16()
        assert torch.equal(quant.q4_matmul(x, qt, "xla"),
                           quant.q4_gemv_plain(x, qt))
        assert torch.equal(dense.dense_matmul(x, w, impl="xla"),
                           dense.dense_gemv_plain(x, w))
        nw = torch.ones(512, dtype=torch.bfloat16, device="cuda")
        assert torch.equal(dense.head_argmax(x[:, None], nw, w, 1e-6, "xla"),
                           dense.head_argmax_plain(x, nw, w, 1e-6).reshape(
                               m, 1))
    assert [f.launches for f in counters] == before


# ------------------------------------------- the captured decode step

def _graph_model(**tuning):
    import exllama_tpu_torch as port

    cfg = port.ExLlamaConfig()
    cfg.hidden_size, cfg.intermediate_size = 512, 1024
    cfg.num_attention_heads = cfg.num_key_value_heads = 4
    cfg.head_dim, cfg.num_hidden_layers, cfg.vocab_size = 128, 2, 1000
    cfg.max_seq_len, cfg.tuning.attn_len_bucket = 128, 32
    for k, v in tuning.items():
        setattr(cfg.tuning, k, v)
    params = port.make_synthetic_params(cfg, 128, False, seed=3,
                                        device="cuda", fast=True)
    return port.ExLlama(cfg, params=params, device="cuda")


def _eager_twin(model):
    """The same model (parameters, config) with ``capture = False``: every
    step of what runs on it is eager."""
    import copy

    twin = copy.copy(model)
    twin.capture = False
    return twin


def test_decode_graphs_replay_the_eager_step_under_an_adapter(gen, tmp_path):
    """gen_tokens under a LoRA adapter on all seven projections (K1 on qkv,
    o, gate|up and down, K3; no K6 or K7) through the graphs against the
    same steps run eagerly: tokens and caches bit-equal, the captured
    step's launches those of the eager one."""
    import numpy as np

    import exllama_tpu_torch as port
    from exllama_tpu_torch import kernels
    from exllama_tpu_torch.utils.fabricate import fabricate_lora

    model = _graph_model()
    files = fabricate_lora(str(tmp_path), model.config,
                           ("q", "k", "v", "o", "gate", "up", "down"), r=16,
                           scale=0.5)
    lora = port.ExLlamaLora(model, *files)
    ids = (np.arange(27, dtype=np.int32)[None] * 37 + 11) % 1000
    runs = []
    for m in (model, _eager_twin(model)):
        g = port.ExLlamaGenerator(m, port.FakeTokenizer(),
                                  port.ExLlamaCache(m), seed=0)
        g.lora = lora
        g.settings.top_k = 1
        g.gen_begin(ids)
        before = kernels.launch_counts()
        toks = g.gen_tokens(40)                # positions 26..65
        after = kernels.launch_counts()
        runs.append((g, toks, {k: after[k] - before[k] for k in after}))
    (g, got, c_graph), (e, ref, c_eager) = runs
    assert sorted(g._loop.graphs) == [32, 64, 96]
    np.testing.assert_array_equal(got, ref)
    for x, y in zip(g.cache._tensor_lists(), e.cache._tensor_lists()):
        for s, t in zip(x, y):
            assert torch.equal(s, t)
    assert c_graph == c_eager
    step = next(iter(g._loop.graphs.values())).counts
    assert {(fn.__name__, a): n for (fn, a), n in step.items()} == {
        ("q4_gemv", "launches"): 8, ("attend", "launches"): 2,
        ("dense_gemv", "launches"): 1}


@pytest.mark.parametrize("settings,tuning", [
    (dict(top_k=1), {}),
    ({}, {}),                                 # top-k 40, top-p 0.65, penalty
    (dict(top_k=1), dict(fuse_qkv=True, commit_impl="pallas",
                         kv_cache_dtype="int8")),
])
def test_decode_graphs_replay_the_eager_step(gen, settings, tuning):
    """gen_tokens through captured graphs (one per 32-token bucket) against
    the same step run eagerly from one state and one generator seed:
    tokens and caches bit-equal, each step's launches counted once, the
    replays' counts those of the eager run."""
    import numpy as np

    import exllama_tpu_torch as port
    from exllama_tpu_torch import kernels

    model = _graph_model(**tuning)
    ids = (np.arange(27, dtype=np.int32)[None] * 37 + 11) % 1000
    runs = []
    for m in (model, _eager_twin(model)):
        g = port.ExLlamaGenerator(m, port.FakeTokenizer(),
                                  port.ExLlamaCache(m), seed=0)
        for k, v in settings.items():
            setattr(g.settings, k, v)
        g.gen_begin(ids)
        before = kernels.launch_counts()
        toks = g.gen_tokens(40)                # positions 26..65
        after = kernels.launch_counts()
        runs.append((g, toks, {k: after[k] - before[k] for k in after}))
    (g, got, c_graph), (e, ref, c_eager) = runs
    assert sorted(g._loop.graphs) == [32, 64, 96]
    assert e._loop.graphs == {}
    np.testing.assert_array_equal(got, ref)
    for x, y in zip(g.cache._tensor_lists(), e.cache._tensor_lists()):
        for s, t in zip(x, y):
            assert torch.equal(s, t)
    assert c_graph == c_eager and sum(c_graph.values()) > 0
    step = next(iter(g._loop.graphs.values())).counts
    assert {k: 40 * n for k, n in step.items()} == {
        k: n for k, n in c_graph.items() if n}


@pytest.mark.parametrize("tuning", [{}, dict(fuse_qkv=True,
                                              commit_impl="pallas")])
def test_decode_graph_replays_after_gen_begin(gen, tuning):
    """One graphed decode step of the Hopper K7 (its tensor maps encode the
    scratch buffers the captured launch holds) replayed after a second
    gen_begin of the same shapes, which captures nothing: token and caches
    bit-equal to the eager twin's same step."""
    import numpy as np

    import exllama_tpu_torch as port

    model = _graph_model(**tuning)
    ids = (np.arange(27, dtype=np.int32)[None] * 37 + 11) % 1000
    ids2 = (np.arange(27, dtype=np.int32)[None] * 53 + 5) % 1000
    runs = []
    for m in (model, _eager_twin(model)):
        g = port.ExLlamaGenerator(m, port.FakeTokenizer(),
                                  port.ExLlamaCache(m), seed=0)
        g.settings.top_k = 1
        g.gen_begin(ids)
        g.gen_tokens(3)
        graphs = dict(g._loop.graphs)
        g.gen_begin(ids2)
        toks = g.gen_tokens(1)
        assert g._loop.graphs == graphs
        runs.append((g, toks))
    (g, got), (e, ref) = runs
    assert list(g._loop.graphs) == [32]
    np.testing.assert_array_equal(got, ref)
    for x, y in zip(g.cache._tensor_lists(), e.cache._tensor_lists()):
        for s, t in zip(x, y):
            assert torch.equal(s, t)


@pytest.mark.parametrize("t,batch,prefix", [(1, 1, 20), (5, 2, 20),
                                             (12, 2, 20), (64, 1, 0)])
def test_forward_chunk_graphs_replay_the_eager_chunk(gen, t, batch, prefix):
    """ExLlama.forward's chunk graphs (B = 2 with a left-pad mask): after a
    prefix, chunks of T rows up to the cache's end (T = 12 padded to 16
    rows but for the last, which the cache has no room to pad), twice over
    the same positions (the second pass replays every graph the first
    captured), against the same chunks run eagerly (``model.capture =
    False``) from the same state: logits and caches bit-equal, the
    launches equal, every graph holding the kernels' scratch; a chunk
    outside the cache raises before anything runs."""
    import numpy as np

    import exllama_tpu_torch as port
    from exllama_tpu_torch import kernels

    model = _graph_model()
    n = (128 - prefix) // t if t > 1 else 3
    ids = (np.arange(batch * (prefix + n * t), dtype=np.int32)
           .reshape(batch, -1) * 37 + 11) % 1000
    mask = None
    if batch == 2:
        ids[1, :2] = 0
        mask = np.ones((2, 128), bool)
        mask[1, :2] = False
    runs = []
    for capture in (True, False):
        model.capture = capture
        try:
            c = port.ExLlamaCache(model, batch_size=batch)
            if prefix:
                model.forward(ids[:, :prefix], c, preprocess_only=True,
                              input_mask=mask)
            before = kernels.launch_counts()
            outs, held = [], []
            for _ in range(2):
                c.current_seq_len = prefix
                outs += [model.forward(
                    ids[:, prefix + i * t:prefix + (i + 1) * t], c,
                    last_id_only=False, input_mask=mask) for i in range(n)]
                held.append(len(c.graphs))
            after = kernels.launch_counts()
        finally:
            model.capture = True
        runs.append((c, outs, held, {k: after[k] - before[k] for k in after}))
    (g, got, held, c_graph), (e, ref, _, c_eager) = runs
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for x, y in zip(g._tensor_lists(), e._tensor_lists()):
        for s_, t_ in zip(x, y):
            assert torch.equal(s_, t_)
    assert c_graph == c_eager and sum(c_graph.values()) > 0
    assert held[0] == held[1] > 0 and not e.graphs
    # every graph holds the kernels' scratch it writes (a scratch it does
    # not hold is freed when a later step grows it, and its replays then
    # write into whatever takes that memory)
    assert all(entry.keep[0] for entry in g.graphs.values())
    # the [1] device cursor at T rows reaches K2 / K3 and the commit as the
    # int cursor does: the last pass's chunks again at int positions
    from exllama_tpu_torch.models.llama import forward_chunk, graph_rows

    for i in range(n):
        past = prefix + i * t
        rows = graph_rows(t) if past + graph_rows(t) <= 128 else t
        chunk = np.zeros((batch, rows), np.int32)
        chunk[:, :t] = ids[:, past:past + t]
        by_int = forward_chunk(
            model.params, e, torch.as_tensor(chunk, device="cuda"), past,
            None if mask is None else torch.as_tensor(mask, device="cuda"),
            valid_rows=(torch.tensor([t], device="cuda") if rows > 8
                        else None),
            **model._chunk_kwargs(attend_len=model._attend_len(past + rows),
                                  last_token_only=False,
                                  preprocess_only=False))
        assert torch.equal(by_int[:, :t], ref[n + i])
    g.current_seq_len = 128 - t + 1
    with pytest.raises(ValueError, match="outside"):
        model.forward(ids[:, :t], g)


def test_engine_speculative_graphs_replay_the_eager_step(gen):
    """The engine's speculative step (n-gram drafts, lookahead 4; two
    greedy and one sampled request, prompts that repeat) through its
    graphs against the same engine run eagerly: tokens, caches and
    histories bit-equal, the launches equal, graphs per (bucket, K)."""
    import numpy as np

    import exllama_tpu_torch as port
    from exllama_tpu_torch import kernels
    from exllama_tpu_torch.ops.sampling import SamplerSettings
    from exllama_tpu_torch.serve import ContinuousBatchingEngine
    from exllama_tpu_torch.speculative import NgramProposer

    model = _graph_model()
    greedy = SamplerSettings(temperature=1.0, top_k=1, top_p=0.0,
                             token_repetition_penalty_max=1.0)
    prompts = [np.tile((np.arange(p, dtype=np.int32) * 37 + 11) % 1000,
                       30 // p) for p in (3, 5, 7)]
    runs = []
    for m in (model, _eager_twin(model)):
        eng = ContinuousBatchingEngine(m, port.FakeTokenizer(),
                                       max_slots=4, prefill_bucket=16,
                                       attn_bucket=32, seed=5,
                                       spec_proposer=NgramProposer(),
                                       spec_lookahead=4)
        before = kernels.launch_counts()
        reqs = [eng.submit(p, 24, settings=greedy if i < 2
                           else SamplerSettings(), stop_tokens=(-1,))
                for i, p in enumerate(prompts)]
        eng.run()
        after = kernels.launch_counts()
        runs.append((eng, [r.new_tokens for r in reqs],
                     {k: after[k] - before[k] for k in after}))
    (g, got, c_graph), (e, ref, c_eager) = runs
    assert got == ref and all(len(x) >= 24 for x in got)
    assert any(len(k) == 3 for k in g.graphs) and not e.graphs
    for x, y in zip(g.cache._tensor_lists(), e.cache._tensor_lists()):
        for s_, t_ in zip(x, y):
            assert torch.equal(s_, t_)
    assert torch.equal(g._hist, e._hist)
    assert c_graph == c_eager and g.spec_stats["steps"] > 0


# ------------------------------------- the serving engine's decode graphs

@pytest.mark.parametrize("mixed", [False, True])
def test_engine_graphs_replay_the_eager_step(gen, tmp_path, mixed):
    """The continuous-batching engine (4 slots, 5 requests of different
    lengths, one admitted mid-flight) through its captured decode steps
    against the same engine run eagerly from one seed: tokens and caches
    bit-equal, the replays' launch counts those of the eager run. Greedy
    (K1 2, K7 2, K4 1 a step on 2 layers), then mixed: two sampled requests with a
    penalty and one under a rank-8 adapter on q and v (the per-slot stack;
    K7 stays on, K1 on qkv without its norm)."""
    import numpy as np

    import exllama_tpu_torch as port
    from exllama_tpu_torch import kernels
    from exllama_tpu_torch.ops.sampling import SamplerSettings
    from exllama_tpu_torch.serve import ContinuousBatchingEngine
    from exllama_tpu_torch.utils.fabricate import fabricate_lora

    model = _graph_model()
    greedy = SamplerSettings(temperature=1.0, top_k=1, top_p=0.0,
                             token_repetition_penalty_max=1.0)
    lora = None
    if mixed:
        lora = port.ExLlamaLora(model, *fabricate_lora(
            str(tmp_path), model.config, ("q", "v"), r=8, scale=0.5))
    prompts = [(np.arange(n, dtype=np.int32) * 37 + 11 + n) % 1000
               for n in (27, 5, 40, 12, 33)]
    runs = []
    for m in (model, _eager_twin(model)):
        eng = ContinuousBatchingEngine(m, port.FakeTokenizer(),
                                       max_slots=4, prefill_bucket=16,
                                       attn_bucket=32, seed=5)
        lid = eng.register_lora(lora) if mixed else -1
        before = kernels.launch_counts()
        reqs = []
        for i, p in enumerate(prompts[:4]):
            st = greedy if not mixed or i % 2 else SamplerSettings()
            reqs.append(eng.submit(p, 20, settings=st, stop_tokens=(-1,),
                                   lora_id=lid if mixed and i == 1 else -1))
        for _ in range(6):
            eng.step()
        reqs.append(eng.submit(prompts[4], 20, settings=greedy,
                               stop_tokens=(-1,)))
        eng.run()
        after = kernels.launch_counts()
        runs.append((eng, [r.new_tokens for r in reqs],
                     {k: after[k] - before[k] for k in after}))
    (g, got, c_graph), (e, ref, c_eager) = runs
    assert got == ref and all(len(t) == 20 for t in got)
    assert g.graphs and not e.graphs
    for x, y in zip(g.cache._tensor_lists(), e.cache._tensor_lists()):
        for s, t in zip(x, y):
            assert torch.equal(s, t)
    assert torch.equal(g._hist, e._hist)
    assert c_graph == c_eager and sum(c_graph.values()) > 0
    steps = [{(fn.__name__, a): n for (fn, a), n in v.counts.items()}
             for v in g.graphs.values()]
    if not mixed:
        assert {("q4_gemv", "launches"): 2, ("layer_tail", "launches"): 2,
                ("dense_gemv", "launches"): 1} in steps
    assert all(s[("layer_tail", "launches")] == 2 for s in steps)
