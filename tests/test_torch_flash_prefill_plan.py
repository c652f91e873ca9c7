"""K3's prefill path on the CPU (ops/attention.py: prefill_rows,
prefill_plan, attend_prefill_tiles_plain): the plan covers every (batch row,
kv head, query row) once and loads no key tile wholly above a block's
causal diagonal; the tile-by-tile online softmax in f32 is the full softmax
to 1e-5 over bf16, int8 and int4 caches; with p rounded to bf16 as the
kernel rounds it, it agrees with attend_plain and with the JAX package's
flash attention (its prefill kernel, in interpret mode) within K3's 2e-2;
each planted fault moves the output by more than 3x that."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.ops import attention as jattn
from exllama_tpu_torch.ops import attention

TOL = 2e-2          # K3's limit (chip_smoke.TOL["flash_attn"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.float().numpy()


def _inputs(kind, b, t, h, hkv, d, past, attend_len, masked, seed=0):
    """q, the cache (bf16, or int8 / int4 written by update_kv_cache from
    bf16 rows whose per-key scales differ by up to x8) and the left-pad
    mask, from a numpy seed."""
    rng = np.random.default_rng(seed)
    s_max = attend_len + 24
    q = torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32)).bfloat16()
    rows = [torch.from_numpy((rng.normal(size=(b, s_max, hkv, d))
                              * 2.0 ** rng.integers(-2, 2, size=(b, s_max, hkv, 1)))
                             .astype(np.float32)).bfloat16() for _ in range(2)]
    ks = vs = None
    if kind == "bf16":
        kc, vc = (r.transpose(1, 2).contiguous() for r in rows)
    else:
        width = d // 2 if kind == "int4" else d
        kc = torch.zeros((b, hkv, s_max, width), dtype=torch.int8)
        vc = torch.zeros_like(kc)
        ks = torch.zeros((b, hkv, s_max))
        vs = torch.zeros_like(ks)
        attention.update_kv_cache(kc, vc, rows[0], rows[1], 0, ks, vs)
    mask = None
    if masked:
        mask = torch.ones((b, s_max), dtype=torch.bool)
        mask[0, :7] = False             # row 0 left-padded by 7 tokens
    pt = past if isinstance(past, int) else torch.tensor(past, dtype=torch.int32)
    return (q, kc, vc, pt, attend_len, mask, ks, vs), past, mask


# name -> (B, T, H, Hkv, D, past, attend_len, masked)
SHAPES = {
    "t40 g1 d64": (1, 40, 2, 2, 64, 0, 64, False),
    "t70 g4 d128 past37 mask": (2, 70, 8, 2, 128, 37, 160, True),
    "t200 g1 d64 past[0,37]": (2, 200, 2, 2, 64, [0, 37], 300, False),
    "t33 g4 d128 past[5,0] mask": (2, 33, 8, 2, 128, [5, 0], 64, True),
    "t130 g1 d256 past37": (1, 130, 1, 1, 256, 37, 200, False),
}
KINDS = ("bf16", "int8", "int4")


@pytest.mark.parametrize("rows", [17, 63, 64, 65, 127, 128, 129, 1919, 7676])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g,past", [(1, [0]), (4, [37, 0]), (1, [1000, 1100])])
def test_plan_covers_each_row_once_and_no_tile_above_the_diagonal(rows, d, g,
                                                                   past):
    if rows % g:
        rows += g - rows % g
    b, hkv = len(past), 2
    attend_len = max(past) + rows // g
    plan = attention.prefill_plan(rows, g, past, attend_len, d, b, hkv)
    br, bn = attention.prefill_rows(rows), attention.PREFILL_KEY_TILES[d]
    assert br == (64 if rows <= 64 else 128)
    seen = np.zeros((b, hkv, rows), np.int64)
    work = []
    for it in plan:
        r0, r1 = it.rows
        assert r0 == it.qt * br and r1 == min(rows, r0 + br)
        seen[it.b, it.hk, r0:r1] += 1
        kv_end = min(attend_len, past[it.b] + (r1 - 1) // g + 1)
        # the last loaded tile holds a key the block's last row sees; none
        # past attend_len's tile
        assert (it.tiles - 1) * bn < kv_end <= it.tiles * bn
        assert len(it.masked) == br // 64
        for w, masked in enumerate(it.masked):
            rw0 = r0 + 64 * w
            for j in range(it.tiles):
                # a tile left unmasked is visible to every row of the group
                first_lim = min(attend_len, past[it.b] + rw0 // g + 1)
                assert (j in masked) == ((j + 1) * bn > first_lim)
        work.append(it.tiles)
    assert (seen == 1).all()
    # the heaviest query tiles first (per batch row at equal cursors)
    if len(set(past)) == 1:
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_tiles_are_the_full_softmax_in_f32(name, kind):
    """With p kept in f32 the tiled decomposition is the full softmax over
    the same f32 scores to 1e-5 of the output scale (only the f32 sum order
    differs)."""
    b, t, h, hkv, d, past, alen, masked = SHAPES[name]
    args, _, _ = _inputs(kind, b, t, h, hkv, d, past, alen, masked)
    q, kc, vc, pt, alen, mask, ks, vs = args
    got = attention.attend_prefill_tiles_plain(*args, p_dtype=torch.float32,
                                               out_dtype=torch.float32)
    scores, ok, _, v, vsc = attention._masked_scores(
        q, kc, vc, pt, alen, mask, False, ks, vs)
    sd = scores.double()
    p = torch.where(ok, torch.exp(sd - sd.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, 1.0, l)
    if vsc is not None:
        p = p * vsc.double()
    ref = torch.einsum("bhgts,bhsd->bthgd", p, v.double())
    ref = (ref / l.permute(0, 3, 1, 2, 4)).reshape(got.shape)
    scale = ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_tiles_with_bf16_p_match_attend_plain(name, kind):
    """p rounded to bf16 against the running max (the kernel's order) stays
    within 2e-2 of attend_plain (rounded against the final max)."""
    b, t, h, hkv, d, past, alen, masked = SHAPES[name]
    args, _, _ = _inputs(kind, b, t, h, hkv, d, past, alen, masked)
    q, kc, vc, pt, alen, mask, ks, vs = args
    got = _np(attention.attend_prefill_tiles_plain(*args))
    ref = _np(attention.attend_plain(q, kc, vc, pt, alen, mask, None, ks, vs))
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


# the JAX side takes its prefill kernel at T*g >= 256 rows
JAX_SHAPES = {
    "t256 g1 d128 past37": (1, 256, 2, 2, 128, 37, 300, False),
    "t64 g4 d64 past[0,37] mask": (2, 64, 8, 2, 64, [0, 37], 128, True),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(JAX_SHAPES))
def test_tiles_match_the_jax_prefill_kernel(name, kind):
    b, t, h, hkv, d, past, alen, masked = JAX_SHAPES[name]
    assert t * (h // hkv) >= jattn.PREFILL_KERNEL_MIN_ROWS
    args, past, mask = _inputs(kind, b, t, h, hkv, d, past, alen, masked)
    q, kc, vc, pt, alen, mask_t, ks, vs = args
    got = _np(attention.attend_prefill_tiles_plain(*args))
    jnp_ = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    quant = ks is not None
    ref = np.asarray(jattn.attend_flash(
        jnp.asarray(_np(q), jnp.bfloat16),
        jnp_(kc) if quant else jnp.asarray(_np(kc), jnp.bfloat16),
        jnp_(vc) if quant else jnp.asarray(_np(vc), jnp.bfloat16),
        jnp.asarray(np.broadcast_to(np.asarray(past, np.int32), (b,))), alen,
        None if mask is None else jnp.asarray(mask.numpy()),
        k_scale=None if ks is None else jnp_(ks),
        v_scale=None if vs is None else jnp_(vs),
        interpret=True,
    ).astype(jnp.float32))
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


FAULTS = {"bf16": ("causal",), "int8": ("causal", "v_scale_on_l"),
          "int4": ("causal", "v_scale_on_l", "halves")}


@pytest.mark.parametrize("kind", KINDS)
def test_planted_faults_move_the_output(kind):
    """A dropped causal mask, the V scale also on l, swapped int4 halves:
    each moves the tiled output by more than 3x K3's limit (the card's
    cases check the same before holding the kernel to it)."""
    b, t, h, hkv, d, past, alen, masked = SHAPES["t70 g4 d128 past37 mask"]
    args, _, _ = _inputs(kind, b, t, h, hkv, d, past, alen, masked, seed=3)
    ref = _np(attention.attend_prefill_tiles_plain(*args))
    scale = np.abs(ref).max()
    for fault in FAULTS[kind]:
        bad = _np(attention.attend_prefill_tiles_plain(*args, fault=fault))
        assert np.abs(bad - ref).max() > 3 * TOL * scale, fault


def test_decode_shapes_are_refused():
    args, _, _ = _inputs("bf16", 1, 4, 4, 4, 64, 10, 64, False)
    with pytest.raises(ValueError):
        attention.attend_prefill_tiles_plain(*args)
