"""The lm_head at any vocabulary size -- K4 dense_gemv's work division and
K4 / K5 at an odd vocab -- and a tiny model with an odd ``vocab_size``, held
against the JAX package on the same numpy inputs. The port runs its plain
PyTorch versions on the CPU; the JAX side runs its Pallas kernels in
interpret mode where its dispatch takes them (an odd vocab sends its
dense_matmul to one whole-width block, its head_argmax to the plain path).
Tolerances are max |difference| over max |reference| unless a test says
otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.ops import dense as jdense

import exllama_tpu_torch as port
from exllama_tpu_torch.models.llama import forward_chunk
from exllama_tpu_torch.ops import dense
from exllama_tpu_torch.ops.norms import rms_norm


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jnp_bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


def _rel(got, ref) -> float:
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


# ------------------------------------------------- K4's work division

def _block_of(u, total, grid):
    """csrc/stream_k.cuh:block_of -- the block whose range holds u."""
    return ((u + 1) * grid + total - 1) // total - 1


@pytest.mark.parametrize("k,v,grid", [
    (4096, 32000, 132), (4096, 32001, 132), (300, 257, 132), (64, 600, 3),
    (100, 1001, 7), (4096, 256, 132),
])
def test_dense_stream_plan_covers_each_unit_once(k, v, grid):
    """Every (tile, unit) in exactly one block's range; a block has at most
    two ranges that share their tile (its first and its last: two scratch
    slots); the kernel's arithmetic for a shared tile's blocks and their
    slots (block_of, unit_begin) names the same blocks in the order of k."""
    tiles, g = dense.dense_grid(k, v, grid)
    ku = -(-k // dense.DENSE_ROWS)
    total = tiles * ku
    assert tiles == -(-v // dense.DENSE_BN) and g == min(grid, total)
    plan = dense.dense_stream_plan(k, v, g)
    seen = np.zeros((tiles, ku), int)
    owners = {}
    for b, ranges in enumerate(plan):
        assert ranges, b
        assert sum(slot is not None for *_, slot in ranges) <= 2
        for t, a, e, slot in ranges:
            seen[t, a:e] += 1
            if slot is not None:
                owners.setdefault(t, []).append((b, slot))
    assert (seen == 1).all()
    for t, blocks in owners.items():
        first = _block_of(t * ku, total, g)
        last = _block_of((t + 1) * ku - 1, total, g)
        assert [b for b, _ in blocks] == list(range(first, last + 1))
        for b, slot in blocks:
            assert slot == (0 if b * total // g >= t * ku else 1)


@pytest.mark.parametrize("m,k,v,grid", [
    (1, 4096, 32000, 132), (2, 512, 32001, 132), (5, 300, 257, 20),
    (32, 256, 1001, 7),
])
def test_dense_gemv_split_plain_matches_the_plain_product(m, k, v, grid):
    """K4's decomposition written out in f32 (each block's range summed,
    shared tiles added in the order of k) against the one plain product:
    1e-5, the f32 sum order alone."""
    rng = np.random.default_rng(m + v)
    x = _bf16(rng.normal(size=(m, k)))
    w = _bf16(rng.normal(size=(k, v)) * 0.02)
    _, g = dense.dense_grid(k, v, grid)
    got = dense.dense_gemv_split_plain(x, w, g)
    ref = dense.dense_gemv_plain(x, w)
    assert got.shape == (m, v) and got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-5


# ------------------------------------------------- K4 / K5 at an odd vocab

@pytest.mark.parametrize("m,v", [(1, 257), (3, 1001), (32, 257), (2, 1024)])
def test_dense_matmul_matches_jax_at_any_vocab(m, v):
    """The lm_head product against the JAX package's dense_matmul in
    interpret mode (at an odd V one block of the whole width): 1e-4, f32
    sums of the same bf16 inputs in another order."""
    rng = np.random.default_rng(7 * m + v)
    k = 256
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, v)) * 0.05).astype(np.float32)
    ref = np.asarray(jdense.dense_matmul(
        _jnp_bf16(x), _jnp_bf16(w), out_dtype=jnp.float32,
        impl="pallas_interpret"))
    got = dense.dense_matmul(_bf16(x), _bf16(w))
    assert got.shape == (m, v) and got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-4


@pytest.mark.parametrize("m,v", [(1, 257), (4, 1001)])
def test_head_argmax_matches_jax_at_an_odd_vocab(m, v):
    """The same token wherever the top-2 margin exceeds 1e-2 of the logit
    scale, the last column included: a planted winner in column V - 1 is
    taken by both packages."""
    rng = np.random.default_rng(3 * m + v)
    k = 256
    x = rng.normal(size=(m, 1, k)).astype(np.float32)
    nw = (rng.random(k) + 0.5).astype(np.float32)
    w = (rng.normal(size=(k, v)) * 0.05).astype(np.float32)
    xn = rms_norm(_bf16(x[:, 0]), _bf16(nw), 1e-6).to(torch.float32).numpy()
    w[:, v - 1] = 0.5 * np.sign(xn[0]) / np.abs(xn[0]).sum() * 40
    ref = np.asarray(jdense.head_argmax(
        _jnp_bf16(x), _jnp_bf16(nw), _jnp_bf16(w), 1e-6,
        impl="pallas_interpret"))
    got = dense.head_argmax(_bf16(x), _bf16(nw), _bf16(w), 1e-6).numpy()
    assert got.shape == ref.shape == (m, 1) and got.dtype == np.int32
    assert int(got[0, 0]) == int(ref[0, 0]) == v - 1
    logits = dense.dense_gemv_plain(
        rms_norm(_bf16(x[:, 0]), _bf16(nw), 1e-6), _bf16(w)).numpy()
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2 * np.abs(logits).max()
    assert clear[0]
    np.testing.assert_array_equal(got[clear], ref[clear])


# ---------------------------------------------- a model with an odd vocab

VOCAB = 257


def _tiny(cfg):
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 2
    cfg.head_dim = 64
    cfg.num_hidden_layers = 2
    cfg.vocab_size = VOCAB
    cfg.max_seq_len = 64
    cfg.max_input_len = 64
    cfg.max_attention_size = 64 * 64
    cfg.tuning.attn_len_bucket = 16
    # the first slice's separate-kernel configuration in both packages
    cfg.tuning.fuse_mlp = False
    cfg.tuning.fuse_attn = False
    cfg.tuning.commit_impl = "xla"
    return cfg


def test_odd_vocab_model_matches_jax():
    """vocab_size 257 (a Llama fine-tune's added pad token, in small): the
    prefill logits within 2% of the logit scale and 8 teacher-forced decode
    steps within 3% (tests/test_torch_model.py's limits); at each step the
    greedy head's id (forward_chunk head_mode="argmax") is the argmax of the
    port's logits wherever their top-2 margin is clear (1e-2 of the scale)
    and of the JAX logits wherever theirs exceeds 3x the cross-package
    noise."""
    jc = _tiny(JaxConfig())
    jc.tuning.matmul_impl = "pallas_interpret"
    jc.tuning.attn_impl = "flash_interpret"
    jp = jax_synth(jc, 128, False, 5)
    pc = _tiny(port.ExLlamaConfig())
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    jm, pm = JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")
    assert pm.params.lm_head.shape == (256, VOCAB)
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    ids = (np.arange(13, dtype=np.int32)[None, :] * 37 + 11) % VOCAB
    ref = np.asarray(jm.forward(ids, jcache, last_id_only=False))
    got = pm.forward(ids, pcache, last_id_only=False).numpy()
    assert got.shape == ref.shape == (1, 13, VOCAB)
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()

    kw = dict(attend_len=pc.max_seq_len, last_token_only=True,
              preprocess_only=False, heads=pc.num_attention_heads,
              kv_heads=pc.num_key_value_heads, head_dim=pc.head_dim,
              eps=pc.rms_norm_eps)
    rng = np.random.default_rng(1)
    checked = 0
    for step in range(8):
        tok = rng.integers(0, VOCAB, size=(1, 1)).astype(np.int32)
        pos = pcache.current_seq_len
        top = forward_chunk(pm.params, pcache, torch.from_numpy(tok), pos,
                            None, head_mode="argmax", **kw)
        assert top.shape == (1, 1) and top.dtype == torch.int32
        ref = np.asarray(jm.forward(tok, jcache))[0, -1]
        got = pm.forward(tok, pcache).numpy()[0, -1]
        assert np.abs(got - ref).max() <= 0.03 * np.abs(ref).max(), step
        pick = int(top[0, 0])
        assert 0 <= pick < VOCAB
        noise = np.abs(got - ref).max()
        for logits, margin in ((got, 1e-2 * np.abs(got).max()),
                               (ref, 3 * noise)):
            top2 = np.sort(logits)[-2:]
            if top2[1] - top2[0] > margin:
                assert pick == int(logits.argmax()), step
                checked += 1
    assert checked > 0
    assert pcache.current_seq_len == jcache.current_seq_len == 21
