"""The fused MLP kernel K6 (csrc/q4_mlp.cu) at 2..32 rows, on the streaming
GEMV (csrc/q4_stream.cuh), and the batched KV commit K8 (csrc/kv_commit.cu)
with its cursor in device memory and the rows staged in the cache: their
decompositions and plain routes, written out in plain tensor code and held
against the JAX package on the same numpy inputs (the JAX side runs its
Pallas kernels in interpret mode, or its plain writes where the JAX package
itself takes them). Tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.formats import gptq as jgptq
from exllama_tpu.ops import attention as jattn
from exllama_tpu.ops import mlp as jmlp

from exllama_tpu_torch.formats import gptq
from exllama_tpu_torch.ops import attention, mlp

HIDDEN, D, INTER = 1024, 128, 1152


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _qt_pair(k, n, gs, seed, scale=0.08):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * scale
    t = jgptq.quantize_matrix(w, gs, act_order=False, rng=rng)
    args = (t["qweight"], t["qzeros"], t["scales"], t.get("g_idx"))
    return jgptq.load_quant_tensor(*args), gptq.load_quant_tensor(*args)


def _mlp_weights(gs):
    pairs = [_qt_pair(HIDDEN, INTER, gs, 3 + i) for i in range(2)]
    jgu = jgptq.concat_quant_tensors([p[0] for p in pairs])
    pgu = gptq.concat_quant_tensors([p[1] for p in pairs])
    jdn, pdn = _qt_pair(INTER, HIDDEN, gs, 5)
    return jgu, pgu, jdn, pdn


def _mlp_inputs(m, seed):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(1, m, HIDDEN)) * 0.5).astype(np.float32)
    nw = (rng.normal(size=(HIDDEN,)) * 0.2 + 1.0).astype(np.float32)
    return h, nw


# ------------------------------------------------------------------ K6

@pytest.mark.parametrize("gs", [32, 128])
@pytest.mark.parametrize("m", [2, 18, 32])
def test_k6_split_plain_matches_jax(m, gs):
    """K6's decomposition at 2..32 rows -- the gate|up phase, one grid
    barrier, the down phase forming silu(gate) * up as it stages each unit,
    both phases stream-K over a 7-block grid (tiles split among blocks) --
    against the JAX fused MLP kernel in interpret mode: atol 0.03 of
    max(1, |ref|), the JAX suite's tolerance for it (test_torch_fused.py
    holds K6's plain version to the same)."""
    jgu, pgu, jdn, pdn = _mlp_weights(gs)
    h, nw = _mlp_inputs(m, 11 + m + gs)
    assert mlp.fused_mlp_applicable(pgu, pdn, HIDDEN, m)
    ref = _np(jmlp.q4_mlp(_jnp_bf16(h), _jnp_bf16(nw), jgu, jdn, 1e-6,
                          impl="pallas_interpret"))
    got = mlp.q4_mlp_split_plain(_bf16(h), _bf16(nw), pgu, pdn, 1e-6, 7)
    assert got.shape == (1, m, HIDDEN) and got.dtype == torch.bfloat16
    atol = 0.03 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("fault", ["drop", "swap"])
def test_k6_split_faults_move_the_output(fault):
    """The planted faults of the streaming GEMV -- one unit of a shared
    tile's range left out, or two rows of the mma's B operand (x's rows 0
    and 1) swapped in one unit -- move K6's MLP output (its output less
    the residual h) by more than 3x K6's 2e-2 limit of its scale, so
    a kernel with either fault could not pass chip_smoke or the card tests;
    the clean decomposition stays within 2e-2 of the plain MLP."""
    _, pgu, _, pdn = _mlp_weights(128)
    _, nw = _mlp_inputs(18, 2)
    rng = np.random.default_rng(6)
    h = _bf16(rng.normal(size=(1, 18, HIDDEN)))
    # the MLP alone: the output less the residual
    ref = mlp.q4_mlp_plain(h, _bf16(nw), pgu, pdn, 1e-6) - h
    scale = ref.float().abs().max()
    clean = mlp.q4_mlp_split_plain(h, _bf16(nw), pgu, pdn, 1e-6, 7) - h
    assert (clean.float() - ref.float()).abs().max() <= 2e-2 * scale
    bad = mlp.q4_mlp_split_plain(h, _bf16(nw), pgu, pdn, 1e-6, 7,
                                 fault=fault) - h
    assert (bad.float() - ref.float()).abs().max() > 3 * 2e-2 * scale


# ------------------------------------------------------------------ K8

def _caches(kind, n_layers, b, hkv, s_max, rng):
    width = D // 2 if kind == "int4" else D
    if kind == "bf16":
        kc = rng.normal(size=(n_layers, b, hkv, s_max, D)).astype(np.float32)
        return (kc, rng.normal(size=kc.shape).astype(np.float32), None, None)
    z = rng.integers(-100, 100, size=(n_layers, b, hkv, s_max, width),
                     dtype=np.int8)
    s = rng.random(size=(n_layers, b, hkv, s_max)).astype(np.float32)
    return z, z[::-1].copy(), s, s[::-1].copy()


@pytest.mark.parametrize("cursor", ["shared", "per_row"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_kv_commit_device_cursor_matches_jax(kind, cursor):
    """``commit_kv_cache(impl="pallas")`` with the cursor as a tensor -- a
    [1] cursor shared by the batch, or a [B] one a row, the form K8 reads
    from device memory -- and the rows staged in one [2, L, B, 1, Hkv, D]
    buffer (``ExLlamaCache.rows``): bit-equal to the JAX commit_kv_cache in
    every cache format (its commit kernel in interpret mode for a shared
    cursor, its plain writes for per-row ones, as the JAX package routes
    them); rows outside the cursor untouched."""
    n_layers, b, hkv, s_max = 3, 2, 2, 64
    rng = np.random.default_rng(len(kind) + len(cursor))
    kc, vc, ks, vs = _caches(kind, n_layers, b, hkv, s_max, rng)
    rows = (rng.normal(size=(2, n_layers, b, 1, hkv, D))
            * 2.0 ** rng.integers(-2, 3, size=(2, n_layers, b, 1, hkv, 1))
            ).astype(np.float32)
    past = np.asarray([5, 40] if cursor == "per_row" else [37], np.int32)
    quantized = ks is not None

    def jt(a):
        return (tuple(_jnp_bf16(c) for c in a) if kind == "bf16"
                else tuple(jnp.asarray(c) for c in a))

    jpast = jnp.asarray(past if cursor == "per_row" else past[0], jnp.int32)
    out = jattn.commit_kv_cache(
        jt(kc), jt(vc), _jnp_bf16(rows[0]), _jnp_bf16(rows[1]), jpast,
        tuple(jnp.asarray(c) for c in ks) if quantized else None,
        tuple(jnp.asarray(c) for c in vs) if quantized else None,
        impl="pallas" if cursor == "shared" else "xla", interpret=True)

    def pt(a):
        return [(_bf16(c) if kind == "bf16" else torch.from_numpy(c.copy()))
                for c in a]

    pk, pv = pt(kc), pt(vc)
    pks = [torch.from_numpy(c.copy()) for c in ks] if quantized else None
    pvs = [torch.from_numpy(c.copy()) for c in vs] if quantized else None
    staged = _bf16(rows)
    attention.commit_kv_cache(pk, pv, staged[0], staged[1],
                              torch.from_numpy(past), pks, pvs,
                              impl="pallas")
    got = [pk, pv] + ([pks, pvs] if quantized else [])
    for mine, theirs in zip(got, out):
        for li in range(n_layers):
            np.testing.assert_array_equal(_np(mine[li]), _np(theirs[li]))
    # only the cursor's position of each row changed
    before = pt(kc)
    for li in range(n_layers):
        for bi in range(b):
            p = int(past[bi if cursor == "per_row" else 0])
            keep = [s for s in range(s_max) if s != p]
            assert torch.equal(pk[li][bi][:, keep], before[li][bi][:, keep])


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_plain_commit_skips_rows_outside_the_cache(kind):
    """The plain writes at a [B] tensor cursor -- the route K8 is held
    against on the card -- leave a row whose cursor is outside [0, S) (here
    S and -1) as it was, as K8 leaves it, and write the other rows as an int
    cursor writes them: bit-equal."""
    n_layers, b, hkv, s_max = 2, 3, 2, 16
    rng = np.random.default_rng(40 + len(kind))
    kc, vc, ks, vs = _caches(kind, n_layers, b, hkv, s_max, rng)
    rows = _bf16(rng.normal(size=(2, n_layers, b, 1, hkv, D)))
    quantized = ks is not None

    def pt(*arrays):
        return [[(_bf16(c) if kind == "bf16" and a is not ks and a is not vs
                  else torch.from_numpy(c.copy())) for c in a]
                for a in arrays if a is not None]

    got, before, ref = pt(kc, vc, ks, vs), pt(kc, vc, ks, vs), pt(kc, vc, ks, vs)
    past = torch.tensor([5, s_max, -1], dtype=torch.int32)
    attention.commit_kv_cache(*got[:2], rows[0], rows[1], past,
                              *(got[2:] if quantized else (None, None)),
                              impl="xla")
    # row 0 alone, at the int cursor 5
    ref0 = [[t[:1].clone() for t in ts] for ts in ref]
    attention.commit_kv_cache(*ref0[:2], rows[0, :, :1], rows[1, :, :1], 5,
                              *(ref0[2:] if quantized else (None, None)),
                              impl="xla")
    for mine, want, old in zip(got, ref0, before):
        for li in range(n_layers):
            assert torch.equal(mine[li][:1], want[li])
            assert torch.equal(mine[li][1:], old[li][1:])
            assert not torch.equal(mine[li][:1], old[li][:1])


@pytest.mark.parametrize("past", [64, -1])
def test_int_cursor_outside_the_cache_raises(past):
    """K8 skips a row whose cursor is outside the cache, so an int cursor
    is checked before it is put in device memory: commit_kv_cache under
    impl="pallas" refuses one outside [0, S) on every device."""
    caches = [torch.zeros((1, 2, 64, D), dtype=torch.bfloat16)
              for _ in range(2)]
    rows = torch.zeros((2, 1, 1, 1, 2, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="outside the cache"):
        attention.commit_kv_cache(caches[:1], caches[1:], rows[0], rows[1],
                                  past, impl="pallas")
