"""The decompositions of the greedy head K5 (csrc/head_argmax.cu on K4's
stream-K loop) and of the decode layer kernel K7 (csrc/layer_tail.cu: its
GEMV phases streamed stream-K across the persistent grid at every row
count, its key splits merged by the last block of each (batch row, kv
head) pair), written out in plain tensor
code and held against the JAX package on the same numpy inputs; the JAX side
runs its Pallas kernels in interpret mode (or, at an odd vocab, its plain
head). Tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.ops import attention as jattn
from exllama_tpu.ops import attn_block as jab
from exllama_tpu.ops import dense as jdense
from exllama_tpu.ops import quant as jquant
from exllama_tpu.ops import rope as jrope

from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.ops import attn_block, dense, quant, rope
from exllama_tpu_torch.ops.norms import rms_norm

HIDDEN, HEADS, D, INTER = 1024, 8, 128, 1152


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _check(got, ref, tol=0.03):
    """atol ``tol`` of max(1, |ref|): the JAX suite's tolerance for its
    fused kernels (tests/test_attn_block.py), as tests/test_torch_fused.py
    holds K7 itself."""
    ref = _np(ref)
    atol = tol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=atol)


# ---------------------------------------------------------------- K5

def _head_case(case):
    """(x [M, K], norm_w [K], w [K, V]) for each case. The tie cases use
    exact arithmetic: x of +-1 with norm weights 1 normalizes to +-1 exactly
    in bf16, and small integer weights give integer logits whatever the
    order of the sums, so a planted tie is a true tie on every path."""
    rng = np.random.default_rng(len(case))
    if case.startswith("odd_vocab"):
        m, k, v = (1, 256, 1001) if case == "odd_vocab" else (5, 300, 257)
        x = rng.normal(size=(m, k)).astype(np.float32)
        nw = (rng.random(k) + 0.5).astype(np.float32)
        w = (rng.normal(size=(k, v)) * 0.05).astype(np.float32)
        return x, nw, w
    if case == "all_negative":
        m, k, v = 3, 256, 1001
        x = np.abs(rng.normal(size=(m, k))).astype(np.float32)
        nw = (rng.random(k) + 0.5).astype(np.float32)
        w = -np.abs(rng.normal(size=(k, v)) * 0.05).astype(np.float32)
        return x, nw, w
    k, v = 256, 1024
    x = np.sign(rng.normal(size=(1, k))).astype(np.float32)
    nw = np.ones(k, np.float32)
    w = rng.integers(-3, 4, size=(k, v)).astype(np.float32)
    # two columns reach the maximum 4 * K; the earlier must win
    a, b = {"tie_across_tiles": (255, 256),     # tiles 0 and 1 (256 columns)
            "tie_across_splits": (300, 900)}[case]  # a split tile, a later one
    w[:, a] = w[:, b] = 4 * x[0]
    return x, nw, w


@pytest.mark.parametrize("case", ["odd_vocab", "odd_vocab_rows",
                                  "all_negative", "tie_across_tiles",
                                  "tie_across_splits"])
@pytest.mark.parametrize("grid", [7, 132])
def test_head_argmax_split_plain_matches_jax(case, grid):
    """K5's decomposition (K4's split sums of the normed rows over K4's
    plan, then the blocks' 64-bit keys combined by their max) returns the JAX head's
    tokens wherever the top-2 margin exceeds 1e-2 of the logit scale (bf16
    rounding of the normed row and the f32 sum order decide nearer ties),
    and exactly the earliest index on the planted exact ties."""
    x, nw, w = _head_case(case)
    m, v = x.shape[0], w.shape[1]
    ref = np.asarray(jdense.head_argmax(
        _jnp_bf16(x), _jnp_bf16(nw), _jnp_bf16(w), 1e-6,
        impl="pallas_interpret")).reshape(-1)
    plan = dense.dense_plan(m, x.shape[1], v, grid)   # grid: the SMs
    got = dense.head_argmax_split_plain(_bf16(x), _bf16(nw), _bf16(w), 1e-6,
                                        plan).numpy()
    assert got.shape == (m,) and got.dtype == np.int32
    assert ((got >= 0) & (got < v)).all()
    if case.startswith("tie"):
        want = {"tie_across_tiles": 255, "tie_across_splits": 300}[case]
        assert int(got[0]) == int(ref[0]) == want
        return
    logits = _np(dense.dense_gemv_plain(
        rms_norm(_bf16(x), _bf16(nw), 1e-6), _bf16(w)))
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2 * np.abs(logits).max()
    assert clear.any()
    np.testing.assert_array_equal(got[clear], ref[clear])
    if case == "all_negative":
        assert (logits < 0).all()


def test_head_argmax_keys_tie_minus_zero_with_plus_zero():
    """-0 and +0 are one value to the key image, so the earlier index wins
    whichever sign it carries, as jnp.argmax decides; a negative value
    never beats either."""
    for row in ([-0.0, 0.0, -1.0], [0.0, -0.0, -1.0], [-1.0, -0.0, 0.0],
                [-2.0, -1.0, -1.0, -3.0]):
        logits = torch.tensor([row], dtype=torch.float32)
        keys = dense.argmax_keys(logits)
        got = int(dense.ids_of_keys(keys.amax(dim=1))[0])
        assert got == int(jnp.argmax(jnp.asarray(row, jnp.float32)))


# ---------------------------------------------------------------- K7 plans

def _block_of(u, total, grid):
    """csrc/stream_k.cuh:block_of -- the block whose range holds u."""
    return ((u + 1) * grid + total - 1) // total - 1


@pytest.mark.parametrize("n,k,grid", [
    (4096, 4096, 264), (22016, 4096, 264), (4096, 11008, 264),
    (12288, 4096, 396), (1152, 1024, 5), (2304, 1024, 528), (256, 96, 7),
])
def test_q4_stream_plan_covers_each_unit_once(n, k, grid):
    """The one-row GEMV's stream-K ranges: every (256-column tile, 128-k
    unit) in exactly one block's range, every block that takes units takes
    at least one (else a split tile's ticket would wait for a block with
    nothing to add); a block has at most two ranges that
    share their tile (its first and its last: two scratch slots), and the
    kernel's arithmetic for a shared tile's blocks (block_of, unit_begin)
    names the same blocks in the order of k."""
    tiles, ku = -(-n // quant.STREAM_BN), -(-k // quant.STREAM_UNIT)
    total = tiles * ku
    plan = quant.q4_stream_plan(n, k, grid)
    assert len(plan) == grid
    grid = min(grid, total)       # the blocks that take units: each some
    assert all(plan[:grid]) and not any(plan[grid:])
    seen = np.zeros((tiles, ku), int)
    owners = {}
    for b, ranges in enumerate(plan):
        assert sum(slot is not None for *_, slot in ranges) <= 2
        for t, a, e, slot in ranges:
            seen[t, a:e] += 1
            if slot is not None:
                owners.setdefault(t, []).append((b, slot))
    assert (seen == 1).all()
    for t, blocks in owners.items():
        first = _block_of(t * ku, total, grid)
        last = _block_of((t + 1) * ku - 1, total, grid)
        assert [b for b, _ in blocks] == list(range(first, last + 1))
        for b, slot in blocks:
            assert slot == (0 if b * total // grid >= t * ku else 1)


@pytest.mark.parametrize("grid", [5, 7, 264, 528])
@pytest.mark.parametrize("m", [2, 8, 18, 32])
def test_multi_row_stream_plan_covers_each_unit_once(m, grid):
    """The streaming GEMV at 2..32 rows (K6 and K7 since they left the
    tensor-core GEMV): its row tile holds the m rows padded to a multiple
    of 8 (the mma's n8 tiles); its (tile, unit) ranges are the one-row
    plan's, each unit once over; every slot a range publishes lies inside
    the scratch the wrapper sizes (two m x 256 slots a block); and the
    decomposition on that grid stays within 1e-2 of the output scale of the
    undivided product (K1's limit)."""
    tile = quant.stream_row_tile(m)
    assert tile in (8, 16, 24, 32) and m <= tile and -(-m // 8) * 8 <= tile
    n, k = 1152, 1024
    tiles, ku = -(-n // quant.STREAM_BN), -(-k // quant.STREAM_UNIT)
    plan = quant.q4_stream_plan(n, k, grid)
    seen = np.zeros((tiles, ku), int)
    for b, ranges in enumerate(plan):
        for t, a, e, slot in ranges:
            seen[t, a:e] += 1
            if slot is not None:
                end = ((2 * b + slot) + 1) * m * quant.STREAM_BN
                assert end <= 2 * grid * m * quant.STREAM_BN
    assert (seen == 1).all()
    _, pqt = _qt_pair(k, n, 128, 40 + m)
    rng = np.random.default_rng(m * grid)
    x = _bf16(rng.normal(size=(m, k)))
    got = quant.fused_gemv_split_plain(x, pqt, grid)
    ref = quant.q4_gemv_plain(x, pqt)
    assert (got.float() - ref.float()).abs().max() <= (
        1e-2 * ref.float().abs().max())


@pytest.mark.parametrize("past,nsplit", [(2000, 8), (0, 8), (31, 3),
                                         (129, 16), (255, 1)])
def test_key_splits_cover_each_key_once(past, nsplit):
    """K7's key ranges: [0, past) once over, whole 32-key chunks but the
    last, in order."""
    splits = attn_block.key_splits(past, nsplit)
    assert len(splits) == nsplit
    covered = [s for lo, hi in splits for s in range(lo, hi)]
    assert covered == list(range(past))
    assert all(lo % 32 == 0 for lo, hi in splits if hi > lo)


def _qt_pair(k, n, gs, seed, scale=0.08, act_order=False):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * scale
    t = jgptq.quantize_matrix(w, gs, act_order=act_order, rng=rng)
    args = (t["qweight"], t["qzeros"], t["scales"], t.get("g_idx"))
    return jgptq.load_quant_tensor(*args), gptq.load_quant_tensor(*args)


def _fused_pair(parts, seed, gs=128):
    pairs = [_qt_pair(k, n, gs, seed + i) for i, (k, n) in enumerate(parts)]
    return (jgptq.concat_quant_tensors([p[0] for p in pairs]),
            gptq.concat_quant_tensors([p[1] for p in pairs]))


@pytest.mark.parametrize("impl", ["pallas", "pallas_a8", "pallas_a8x2"])
@pytest.mark.parametrize("m,blocks", [(1, 5), (3, 264), (2, 7), (8, 5),
                                      (18, 264), (32, 528)])
def test_fused_gemv_split_plain_matches_jax(impl, m, blocks):
    """A GEMV phase's stream-K decomposition (norm prologue on) at 1..32
    rows against the JAX GEMV kernel in interpret mode: 1e-2 of the output
    scale in every mode, K1's and K9's own limits (the bf16 output
    rounding, and for the exact mode the JAX kernel's f32 sums of
    bf16-rounded weights)."""
    jqt, pqt = _qt_pair(HIDDEN, INTER, 128, 9)
    rng = np.random.default_rng(m + blocks)
    x = rng.normal(size=(m, HIDDEN)).astype(np.float32)
    nw = (rng.random(HIDDEN) + 0.5).astype(np.float32)
    ref = jquant.q4_matmul(_jnp_bf16(x), jqt, impl=f"{impl}_interpret",
                           norm_w=_jnp_bf16(nw), norm_eps=1e-6)
    got = quant.fused_gemv_split_plain(_bf16(x), pqt, blocks, _bf16(nw), 1e-6,
                                       impl)
    assert got.shape == (m, INTER) and got.dtype == torch.bfloat16
    ref = _np(ref)
    assert np.abs(_np(got) - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("impl", ["pallas", "pallas_a8"])
@pytest.mark.parametrize("gs,act", [(32, False), (64, True), (128, True)])
def test_one_row_stream_plain_matches_jax_at_each_groupsize(impl, gs, act):
    """K1 / K9 at one row take the streaming GEMV (csrc/q4_stream.cuh) at
    groupsize 32 / 64 / 128, the act-order gather included: its
    decomposition on a grid of 7 blocks (tiles split between blocks)
    against the JAX GEMV in interpret mode, 1e-2 of the output scale (K1's
    and K9's limit)."""
    jqt, pqt = _qt_pair(HIDDEN, 640, gs, 17 + gs, act_order=act)
    assert (pqt.x_map is not None) == act
    rng = np.random.default_rng(gs)
    x = rng.normal(size=(1, HIDDEN)).astype(np.float32)
    nw = (rng.random(HIDDEN) + 0.5).astype(np.float32)
    ref = jquant.q4_matmul(_jnp_bf16(x), jqt, impl=f"{impl}_interpret",
                           norm_w=_jnp_bf16(nw), norm_eps=1e-6)
    got = quant.fused_gemv_split_plain(_bf16(x), pqt, 7, _bf16(nw), 1e-6, impl)
    assert got.shape == (1, 640) and got.dtype == torch.bfloat16
    ref = _np(ref)
    assert np.abs(_np(got) - ref).max() <= 1e-2 * np.abs(ref).max()


# ------------------------------------------------- K7 against the JAX kernel

def _caches(kind, b, hkv, s_max, filled, rng):
    """bf16 caches, or int8 / int4 ones filled through the JAX update (the
    port's writes are bit-equal to it: tests/test_torch_kvcache.py)."""
    mag = 2.0 ** rng.integers(-2, 2, size=(b, filled, hkv, 1))
    nk = (rng.normal(size=(b, filled, hkv, D)) * mag).astype(np.float32)
    nv = (rng.normal(size=(b, filled, hkv, D)) * mag).astype(np.float32)
    if kind == "bf16":
        kc = np.zeros((b, hkv, s_max, D), np.float32)
        vc = np.zeros_like(kc)
        kc[:, :, :filled] = nk.transpose(0, 2, 1, 3)
        vc[:, :, :filled] = nv.transpose(0, 2, 1, 3)
        return (_jnp_bf16(kc), _jnp_bf16(vc), None, None), \
            (_bf16(kc), _bf16(vc), None, None)
    width = D if kind == "int8" else D // 2
    z = np.zeros((b, hkv, s_max, width), np.int8)
    s = np.zeros((b, hkv, s_max), np.float32)
    jc = jattn.update_kv_cache(jnp.asarray(z), jnp.asarray(z), _jnp_bf16(nk),
                               _jnp_bf16(nv), jnp.int32(0), jnp.asarray(s),
                               jnp.asarray(s))
    return jc, tuple(torch.from_numpy(np.array(a)) for a in jc)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("entry,b", [("layer_tail", 1), ("layer_step", 1),
                                     ("layer_tail", 2), ("layer_step", 2)])
def test_k7_split_plain_matches_jax(entry, b, kind):
    """K7's decomposition -- GEMV phases split as planned for a 5-block
    grid, 3 key splits merged by each pair's last block -- against the JAX
    layer_tail / layer_step kernels in interpret mode: atol 0.03 of
    max(1, |ref|), the JAX suite's own tolerance for them."""
    hkv, s_max, blocks, nsplit = 2, 128, 5, 3
    past = 100 if b == 1 else [100, 37]
    rng = np.random.default_rng(len(entry) + 10 * b + len(kind))
    jc, pc = _caches(kind, b, hkv, s_max, 110, rng)
    q = (rng.normal(size=(b, 1, HEADS, D)) * 0.5).astype(np.float32)
    kn = rng.normal(size=(b, 1, hkv, D)).astype(np.float32)
    vn = rng.normal(size=(b, 1, hkv, D)).astype(np.float32)
    h = (rng.normal(size=(b, 1, HIDDEN)) * 0.5).astype(np.float32)
    iw = (rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32)
    nw = (rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32)
    jo, po = _qt_pair(HIDDEN, HIDDEN, 128, 2)
    jgu, pgu = _fused_pair([(HIDDEN, INTER), (HIDDEN, INTER)], 31)
    jdn, pdn = _qt_pair(INTER, HIDDEN, 128, 33)
    past_np = np.asarray(past, np.int32)
    pj = jnp.asarray(past_np)
    pt = past if isinstance(past, int) else torch.from_numpy(past_np)
    jkw = dict(k_scale=jc[2], v_scale=jc[3], impl="pallas_interpret")
    tkw = dict(k_scale=pc[2], v_scale=pc[3], blocks=blocks, nsplit=nsplit)
    if entry == "layer_tail":
        ref = jab.layer_tail(_jnp_bf16(h), _jnp_bf16(q), jc[0], jc[1], pj,
                             s_max, jo, _jnp_bf16(nw), jgu, jdn, 1e-6,
                             (_jnp_bf16(kn), _jnp_bf16(vn)), **jkw)
        got = attn_block.layer_tail_split_plain(
            _bf16(h), _bf16(q), pc[0], pc[1], pt, s_max, po, _bf16(nw), pgu,
            pdn, 1e-6, (_bf16(kn), _bf16(vn)), **tkw)
    else:
        jqkv, pqkv = _fused_pair([(HIDDEN, HEADS * D), (HIDDEN, hkv * D),
                                  (HIDDEN, hkv * D)], 21)
        sj, cj = jrope.slice_tables(*jrope.rope_tables(s_max, D), pj, 1)
        st, ct = rope.slice_tables(*rope.rope_tables(s_max, D), pt, 1)
        ref, kj, vj = jab.layer_step(
            _jnp_bf16(h), jqkv, _jnp_bf16(iw), sj, cj, jc[0], jc[1], pj,
            s_max, jo, _jnp_bf16(nw), jgu, jdn, 1e-6, HEADS, hkv, D, **jkw)
        got, kt, vt = attn_block.layer_step_split_plain(
            _bf16(h), pqkv, _bf16(iw), st, ct, pc[0], pc[1], pt, s_max, po,
            _bf16(nw), pgu, pdn, 1e-6, HEADS, hkv, D, **tkw)
        _check(kt, kj)
        _check(vt, vj)
    assert got.shape == (b, 1, HIDDEN) and got.dtype == torch.bfloat16
    _check(got, ref)


@pytest.mark.parametrize("fault", ["drop", "twice"])
def test_k7_merge_faults_move_the_output(fault):
    """The planted merge faults -- each head's heaviest key split left out,
    or counted twice -- move the attention output (o-proj of it, h = 0, a
    peaked softmax: q x4) by more than 3x K7's 2e-2 limit of its scale, so
    a kernel with either fault could not pass chip_smoke or the card tests;
    the clean decomposition stays within 2e-2 of the plain attention."""
    b, hkv, s_max, past = 1, 2, 512, 400
    rng = np.random.default_rng(3)
    q = _bf16(rng.normal(size=(b, 1, HEADS, D)) * 4.0)
    kc = _bf16(rng.normal(size=(b, hkv, s_max, D)))
    vc = _bf16(rng.normal(size=(b, hkv, s_max, D)))
    new_kv = (_bf16(rng.normal(size=(b, 1, hkv, D))),
              _bf16(rng.normal(size=(b, 1, hkv, D))))
    _, po = _qt_pair(HIDDEN, HIDDEN, 128, 2)
    h = torch.zeros((b, 1, HIDDEN), dtype=torch.bfloat16)
    args = (h, q, kc, vc, past, s_max, po, None, None, None, 1e-6, new_kv)
    ref = attn_block.attn_block_o_plain(h, q, kc, vc, past, s_max, po, new_kv)
    scale = ref.float().abs().max()
    clean = attn_block.layer_tail_split_plain(*args, blocks=5, nsplit=4)
    assert (clean.float() - ref.float()).abs().max() <= 2e-2 * scale
    bad = attn_block.layer_tail_split_plain(*args, blocks=5, nsplit=4,
                                            fault=fault)
    assert (bad.float() - ref.float()).abs().max() > 3 * 2e-2 * scale
