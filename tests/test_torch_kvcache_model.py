"""The slice as a whole: the tiny model under an int8 / int4 / padded KV
cache, the generator on top of it, and ``model_init`` (the flag vocabulary,
``--turbo`` included), port against the JAX package on the same parameters
and tokens. The port runs its plain PyTorch versions on the CPU, the JAX
side its Pallas kernels in interpret mode. Ops and cache operations are in
tests/test_torch_kvcache.py."""

import argparse
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from exllama_tpu import model_init as jinit
from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models import llama as jllama

import exllama_tpu_torch as port
from exllama_tpu_torch import model_init
from exllama_tpu_torch.models import llama

D = 128


def _tiny(cfg, max_seq_len=128):
    cfg.hidden_size = 256
    cfg.intermediate_size = 384
    cfg.num_attention_heads = 2
    cfg.num_key_value_heads = 1
    cfg.head_dim = D
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 512
    cfg.max_seq_len = max_seq_len
    cfg.max_input_len = 64
    cfg.max_attention_size = 64 * 64
    cfg.tuning.attn_len_bucket = 32
    return cfg


# mode -> (kv_cache_dtype, matmul_impl, other knobs, prefill limit, decode
# limit). max_seq_len 128 lets the JAX commit kernel (commit_impl="pallas")
# run on the int8 cache; for the int4 one its rows are not lane-full at
# head_dim 128 and the JAX package itself takes its plain writes.
MODES = {
    "int8": ("int8", "pallas", {}, 0.03, 0.03),
    "int4": ("int4", "pallas", {}, 0.2, 0.03),
    "int8_fuse_qkv_commit": ("int8", "pallas", dict(
        fuse_qkv=True, commit_impl="pallas"), 0.03, 0.03),
    "int4_fuse_qkv_commit": ("int4", "pallas", dict(
        fuse_qkv=True, commit_impl="pallas"), 0.2, 0.03),
    "int8_a8x2": ("int8", "pallas_a8x2", {}, 0.02, 0.03),
    "turbo": ("int8", "pallas_a8", {}, 0.12, 0.12),
}
N_PROMPT = {m: 9 + i for i, m in enumerate(MODES)}


def _models(mode):
    kv, impl, knobs, _, _ = MODES[mode]
    jc = _tiny(JaxConfig())
    jc.tuning.matmul_impl = impl + "_interpret"
    jc.tuning.attn_impl = "flash_interpret"
    pc = _tiny(port.ExLlamaConfig())
    pc.tuning.matmul_impl = impl
    for cfg in (jc, pc):
        cfg.tuning.kv_cache_dtype = kv
        for k, v in knobs.items():
            setattr(cfg.tuning, k, v)
    jp = jax_synth(jc, 128, False, 7)
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return (jllama.ExLlama(jc, params=jp),
            port.ExLlama(pc, params=pp, device="cpu"))


def _take_state(pcache, jcache):
    """The JAX cache's bytes and scales into the port's tensors; returns
    the fraction of K bytes that differed."""
    differed = []
    for name in ("k", "v", "k_scale", "v_scale"):
        for t, a in zip(getattr(pcache, name), getattr(jcache.state, name)):
            a = torch.from_numpy(np.array(a))
            if name == "k":
                differed.append((t != a).float().mean().item())
            t.copy_(a)
    return max(differed)


@pytest.mark.parametrize("mode", list(MODES))
def test_model_matches_jax_under_a_quantized_cache(mode):
    """Prefill, then three teacher-forced decode steps, both packages in the
    same quantized mode, logits as a share of the logit scale.

    Decode: 3%, the bf16 cache's limit, each step starting from the JAX
    package's cache state (bytes and scales copied over), so that a step is
    held on its own arithmetic: K3 / K7's plain versions over the same
    integers, and the commit of its row. Without that a quantizer amplifies
    what came before it: two rows that differ by one bf16 step round to
    other integers, and an int4 integer is a seventh of the row's maximum.
    Prefill: the chunk is written and attended in the same call, so its
    limit carries that amplification: 3% under int8 (the bf16 cache reads
    1.8% on this model, int8's own noise against bf16 is 2-3% in either
    package; 2.2-2.5% measured), 20% under int4 (int4's own noise against
    bf16 is 18-36% in either package, the packages differ by 12%, and 17%
    of layer 1's bytes differ after 1% of layer 0's did), 2% under int8 +
    a8x2 (0.1% measured). Under ``--turbo``'s one-pass int8 activations
    12% throughout, as tests/test_torch_turbo.py holds that arithmetic with
    a bf16 cache. Same rows give the same bytes: tests/test_torch_kvcache.py
    holds the writes and the commit bit for bit. The quantized cache also
    moves the logits away from the bf16 cache's."""
    kv, _, _, lim_prefill, lim_decode = MODES[mode]
    jm, pm = _models(mode)
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    assert pcache.k[0].dtype == torch.int8 and pcache.k_scale is not None
    assert pcache.k[0].shape[-1] == (D // 2 if kv == "int4" else D)
    assert tuple(pcache.k[0].shape) == jcache.state.k[0].shape
    n = N_PROMPT[mode]
    ids = (np.arange(n, dtype=np.int32)[None, :] * 37 + 11) % 512
    steps = [ids] + [np.array([[t]], np.int32) for t in (3, 400, 77)]
    for i, tok in enumerate(steps):
        ref = np.asarray(jm.forward(tok, jcache, last_id_only=i > 0))
        got = pm.forward(tok, pcache, last_id_only=i > 0).numpy()
        assert got.shape == ref.shape
        lim = lim_decode if i else lim_prefill
        assert np.abs(got - ref).max() <= lim * np.abs(ref).max(), (mode, i)
        # every position written so far carries a scale, none beyond
        assert (pcache.k_scale[0][:, :, :n + i] > 0).all()
        assert (pcache.v_scale[1][:, :, n + i:] == 0).all()
        # the caches agree in most bytes before they are made equal
        assert _take_state(pcache, jcache) < 0.5
    assert pcache.current_seq_len == jcache.current_seq_len == n + 3

    quantized = port.ExLlamaCache(pm)
    pm.config.tuning.kv_cache_dtype = "bf16"
    plain = port.ExLlamaCache(pm)
    assert plain.k_scale is None and plain.k[0].dtype == torch.bfloat16
    for i, tok in enumerate(steps):
        a = pm.forward(tok, quantized, last_id_only=i > 0)
        b = pm.forward(tok, plain, last_id_only=i > 0)
        assert (a - b).abs().max() > 0


def test_a_decode_step_sees_its_own_row_in_bf16_and_commits_it_quantized():
    """Who sees what: a decode step reads its own K/V row in flight, not
    from the cache (whatever the cache holds at the cursor beforehand, the
    logits are the same), leaves the committed prefix alone and commits its
    row quantized."""
    _, pm = _models("int8")
    cache = port.ExLlamaCache(pm)
    ids = (np.arange(7, dtype=np.int32)[None, :] * 37 + 11) % 512
    pm.forward(ids, cache, preprocess_only=True)
    stale = cache.clone()
    for ts in (stale.k, stale.v):
        for t in ts:
            t[:, :, 7] = 99
    for ts in (stale.k_scale, stale.v_scale):
        for t in ts:
            t[:, :, 7] = 5.0
    before = [t.clone() for t in cache.k]
    logits = pm.forward(np.array([[5]], np.int32), cache)
    assert torch.equal(logits, pm.forward(np.array([[5]], np.int32), stale))
    for li, (old, new) in enumerate(zip(before, cache.k)):
        assert torch.equal(old[:, :, :7], new[:, :, :7])
        assert old[:, :, 7].abs().sum() == 0
        assert torch.equal(new, stale.k[li])
        assert (cache.k_scale[li][:, :, 7] > 0).all()
        # an int8 row's largest magnitude is 127 by construction
        assert new[:, :, 7].abs().amax() == 127


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_generator_end_to_end_on_a_quantized_cache(kind):
    """The generator needs nothing new (tests/test_kv_int8.py:170): a
    greedy request runs, and its first token is the model's own argmax."""
    cfg = _tiny(port.ExLlamaConfig())
    cfg.tuning.kv_cache_dtype = kind
    params = port.make_synthetic_params(cfg, 128, False, seed=5, device="cpu",
                                        fast=True)
    model = port.ExLlama(cfg, params=params, device="cpu")
    cache = port.ExLlamaCache(model)
    gen = port.ExLlamaGenerator(model, port.FakeTokenizer(), cache, seed=0)
    gen.settings.top_k = 1
    prompt = "hello world"
    text = gen.generate_simple(prompt, max_new_tokens=8)
    assert isinstance(text, str) and len(text) > 0
    assert gen.sequence.shape == (1, len(prompt) + 8)
    assert cache.current_seq_len == len(prompt) + 8 - 1
    fresh, n = port.ExLlamaCache(model), len(prompt)
    model.forward(gen.sequence[:, :n - 1], fresh, preprocess_only=True)
    logits = model.forward(gen.sequence[:, n - 1:n], fresh)
    assert int(logits[0, -1].argmax()) == int(gen.sequence[0, n])
    # cache reuse keeps the quantized prefix
    reused = gen.gen_begin_reuse(gen.sequence[:, :n + 3])
    assert reused == n + 3


_PAD_CODE = """
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import torch
from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params
from exllama_tpu.models.llama import ExLlama as JaxModel
import exllama_tpu_torch as port

def shape(cfg):
    cfg.hidden_size = 400          # 4 heads x 100
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 2
    cfg.head_dim = 100
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 256
    cfg.max_seq_len = 64
    cfg.tuning.pad_head_dim = True
    return cfg

jc = shape(JaxConfig())
jc.tuning.matmul_impl = "xla"
jc.tuning.attn_impl = "flash_interpret"
jp = make_synthetic_params(jc, 16, False, seed=77)
jm = JaxModel(jc, params=jp)
for kind in ("bf16", "int8"):
    jc.tuning.kv_cache_dtype = kind
    pc = shape(port.ExLlamaConfig())
    pc.tuning.kv_cache_dtype = kind
    pm = port.ExLlama(pc, params=port.params_from_jax(
        jax.tree.map(np.asarray, jp), pc, device="cpu"), device="cpu")
    jcache, pcache = JaxCache(jm), port.ExLlamaCache(pm)
    assert tuple(pcache.k[0].shape) == jcache.state.k[0].shape == (1, 2, 64, 128)
    ids = (np.arange(10, dtype=np.int32)[None] * 3 + 1) % 256
    for i, tok in enumerate([ids, np.array([[9]], np.int32),
                             np.array([[200]], np.int32)]):
        ref = np.asarray(jm.forward(tok, jcache, last_id_only=i > 0))
        got = pm.forward(tok, pcache, last_id_only=i > 0).numpy()
        lim = 0.03 if i else 0.02
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel <= lim, (kind, i, rel)
    # the pad columns of the cache hold zeros
    assert pcache.k[0][..., 100:].float().abs().sum() == 0
    # and without the padding the same model gives the same logits
    pc2 = shape(port.ExLlamaConfig())
    pc2.tuning.pad_head_dim = False
    pc2.tuning.kv_cache_dtype = kind
    pm2 = port.ExLlama(pc2, params=pm.params, device="cpu")
    c2 = port.ExLlamaCache(pm2)
    assert c2.k[0].shape[-1] == 100
    a = pm2.forward(ids, c2, last_id_only=False).numpy()
    b = pm.forward(ids, port.ExLlamaCache(pm), last_id_only=False).numpy()
    assert np.abs(a - b).max() <= 0.02 * np.abs(a).max(), kind
print("PAD_HEAD_DIM_OK")
"""


def test_padded_head_dim_100_matches_jax():
    """``pad_head_dim``: a head_dim-100 model runs over a cache padded to
    128 with q pre-scaled, against the JAX package's flash kernel on its
    padded cache (2% prefill, 3% decode), under bf16 and int8. In a
    subprocess, as the JAX suite runs its own head_dim-100 case
    (tests/test_attention.py:202): XLA's CPU code for the odd widths has
    unsettled later compiles in the same process."""
    r = subprocess.run([sys.executable, "-c", _PAD_CODE], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "PAD_HEAD_DIM_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


# -------------------------------------------------------------- model_init

def _parse(mod, argv):
    parser = argparse.ArgumentParser()
    mod.add_args(parser)
    return parser.parse_args(argv)


FLAG_SETS = [
    [], ["--kv_int8"], ["--kv_int4"], ["--pad_head_dim"], ["--turbo"],
    ["--turbo", "--turbo_prefill"], ["--a8x2"], ["--turbo_prefill"],
    ["--turbo", "--kv_int4"], ["--turbo", "--a8x2"], ["--no_fuse"],
    ["--fuse_layer"], ["--turbo", "--matmul_impl", "pallas"],
    ["--kv_int8", "--kv_int4", "--pad_head_dim", "--fuse_layer"],
    ["--attn_bucket", "0", "-l", "512", "--max_input_len", "1024",
     "-a", "2.0", "-cpe", "2.0"],
    ["-theta", "500000"],
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f) or "-")
def test_make_config_matches_jax(flags, tmp_path):
    """Every flag combination of exllama_tpu/model_init.py:137-160 gives
    the port's config the JAX package's values."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "hidden_size": 256, "intermediate_size": 384,
        "num_attention_heads": 2, "num_hidden_layers": 2, "vocab_size": 512}))
    argv = ["-c", str(path), "-m", "unused.safetensors"] + flags
    ref = jinit.make_config(_parse(jinit, argv))
    got = model_init.make_config(_parse(model_init, argv))
    for knob in ("matmul_impl", "kv_cache_dtype", "pad_head_dim",
                 "attn_len_bucket", "fuse_projections", "fuse_qkv",
                 "fuse_mlp", "fuse_attn", "commit_impl", "prefill_w8",
                 "scale_dtype"):
        assert getattr(got.tuning, knob) == getattr(ref.tuning, knob), knob
    for field in ("max_seq_len", "max_input_len", "max_attention_size",
                  "compress_pos_emb", "alpha_value", "rotary_embedding_base",
                  "model_path", "hidden_size", "head_dim"):
        assert getattr(got, field) == getattr(ref, field), field


def test_model_init_flag_vocabulary_is_the_jax_one():
    """Every flag of the JAX add_args, with its default, and two more:
    --scale_f32, which the JAX package's benchmark adds beside it, and
    --backend, the torch.distributed backend of a --tp/--dp world (the JAX
    package's runtime has no choice to make)."""
    def flags(mod):
        parser = argparse.ArgumentParser()
        mod.add_args(parser)
        return {tuple(a.option_strings): (a.default, a.nargs, a.type)
                for a in parser._actions}

    ours, ref = flags(model_init), flags(jinit)
    assert ours.pop(("--scale_f32",)) == (False, 0, None)
    assert ours.pop(("--backend",)) == ("nccl", None, str)
    assert ours == ref


@pytest.mark.parametrize("argv", [["--tp", "2"], ["--dp", "2"],
                                  ["--tp", "2", "--dp", "2"]])
def test_model_init_refuses_what_the_port_lacks(argv, tmp_path):
    """Tensor and data parallelism, refused here until the port had them,
    now set the config's degrees as the JAX make_config does; what is
    refused is a mesh of more ranks than the world has (a --tp/--dp run
    is a world of tp * dp ranks: torchrun, or parallel.launch)
    (``--matmul_impl xla``, once refused here, is the plain path now:
    tests/test_torch_knobs.py)."""
    path = tmp_path / "config.json"
    path.write_text("{}")
    args = _parse(model_init, ["-c", str(path), "-m", "x"] + argv)
    config = model_init.make_config(args)
    assert (config.tp_size, config.dp_size) == (args.tp, args.dp)
    assert config.tuning.fuse_projections      # fused on each rank
    with pytest.raises(ValueError, match="ranks"):
        model_init.mesh_from_args(args)


def test_model_init_resolves_files_and_devices(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError):
        model_init.get_model_files(_parse(model_init, ["-d", str(tmp_path)]))
    (tmp_path / "model.safetensors").write_bytes(b"")
    args = _parse(model_init, ["-d", str(tmp_path)])
    model_init.get_model_files(args)
    assert args.config == str(tmp_path / "config.json")
    assert args.model == str(tmp_path / "model.safetensors")
    assert args.tokenizer is None
    with pytest.raises(ValueError):
        model_init.get_model_files(_parse(model_init, ["-c", "x"]))
    with pytest.raises(ValueError):             # no tokenizer without -d
        model_init.get_model_files(_parse(model_init, ["-c", "x", "-m", "y"]))
    assert model_init.device_of(_parse(model_init, ["--cpu"])).type == "cpu"
    assert model_init.device_of(_parse(model_init, [])).type == "cuda"


@pytest.mark.parametrize("flags", [[], ["--kv_int8"], ["--kv_int4"],
                                   ["--turbo"]],
                         ids=lambda f: " ".join(f) or "-")
def test_build_on_a_fabricated_checkpoint_matches_jax(flags, tmp_path, capsys):
    """``build`` on a tiny checkpoint written here, through both packages'
    ``model_init``: a model on the CPU, the byte-level tokenizer, no mesh,
    and prefill logits near the JAX package's, whose matmuls resolve to its
    plain path on the CPU: 2%, 3% with an int8 cache and 20% with an int4
    one, as test_model_matches_jax_under_a_quantized_cache. ``--turbo`` asks
    the JAX package for a kernel that it runs only on its accelerator, so
    there the port is held against the JAX package's --kv_int8 model at
    25%: the 17-token prompt takes the one-pass int8 activations in the
    port (15% measured on this two-groups-a-row model; that arithmetic is
    held at op level in tests/test_torch_turbo.py), so this case shows that
    the flag reaches a working model, not parity."""
    from exllama_tpu.utils.fabricate import fabricate

    ckpt = tmp_path / "ckpt"
    fabricate(str(ckpt), "tiny", 128, False, seed=5, verbose=False)
    argv = ["-d", str(ckpt), "-l", "64", "--cpu"]
    turbo = "--turbo" in flags
    jcfg, jm, jtok, _ = jinit.build(_parse(
        jinit, argv + (["--kv_int8"] if turbo else flags)))
    cfg, model, tok, mesh = model_init.build(_parse(model_init, argv + flags))
    capsys.readouterr()
    assert mesh is None and isinstance(tok, port.FakeTokenizer)
    assert model.device.type == "cpu" and isinstance(model, port.ExLlama)
    assert cfg.groupsize == jcfg.groupsize == 128 and not cfg.act_order
    assert cfg.tuning.kv_cache_dtype == jcfg.tuning.kv_cache_dtype
    ids = np.asarray(tok.encode("a tiny checkpoint"))
    assert np.array_equal(ids, np.asarray(jtok.encode("a tiny checkpoint")))
    ref = np.asarray(jm.forward(ids, JaxCache(jm), last_id_only=False))
    got = model.forward(ids, port.ExLlamaCache(model),
                        last_id_only=False).numpy()
    assert cfg.tuning.matmul_impl == ("pallas_a8" if turbo else "auto")
    lim = {"": 0.02, "--kv_int8": 0.03, "--kv_int4": 0.2,
           "--turbo": 0.25}[" ".join(flags)]
    assert np.abs(got - ref).max() <= lim * np.abs(ref).max()


def test_attach_prefill_w8_counts_the_cache_by_its_dtype():
    """The int8-image budget leaves room for the configured cache: 2, 1 or
    half a byte an element (exllama_tpu/models/llama.py:777-783)."""
    cfg = _tiny(port.ExLlamaConfig())
    cfg.tuning.matmul_impl = "pallas_a8t"
    params = port.make_synthetic_params(cfg, 128, False, seed=5, device="cpu",
                                        fast=True)
    packed = sum(llama._quant_bytes(getattr(lp, f)) for lp in params.layers
                 for f in llama._W8_FIELDS if getattr(lp, f) is not None)
    elems = 2 * 2 * cfg.max_seq_len * 1 * D
    down_cost = 384 * 256 + 4 * 256

    def images(kind, budget_bytes):
        cfg.tuning.kv_cache_dtype = kind
        cfg.tuning.prefill_w8_budget_gb = budget_bytes / 2 ** 30
        out = llama._attach_prefill_w8(params, cfg)
        return sum(getattr(lp, f).w8 is not None for lp in out.layers
                   for f in ("down", "gateup", "qkv"))

    # room for exactly one down image next to an int4 cache: none fits next
    # to the (4x larger) bf16 cache, and the int8 cache sits between
    budget = packed + elems // 2 + down_cost
    assert images("int4", budget) == 1
    assert images("int8", budget) == 0
    assert images("int8", budget + elems // 2) == 1
    assert images("bf16", budget + elems // 2) == 0
    assert images("bf16", budget + elems // 2 + elems) == 1
