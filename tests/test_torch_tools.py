"""The port's tools against the JAX package's on the CPU, at the tiny
shapes: perplexity (full-chunk logits and the token-by-token decode path),
the checkpoint fabricator and the safetensors writer (byte for byte), the
shard splitter, and the benchmark's command line."""

import filecmp
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import safetensors.numpy
import torch

from exllama_tpu.cache import ExLlamaCache as JaxCache
from exllama_tpu.config import ExLlamaConfig as JaxConfig
from exllama_tpu.formats.loader import make_synthetic_params as jax_synth
from exllama_tpu.models.llama import ExLlama as JaxModel
from exllama_tpu.perplexity import Perplexity as JaxPerplexity
from exllama_tpu.perplexity import _chunk_logprob as jax_chunk_logprob
from exllama_tpu.tokenizer import FakeTokenizer as JaxFakeTokenizer
from exllama_tpu.utils import fabricate as jfab
from exllama_tpu.utils import shard as jshard

import exllama_tpu_torch as port
from exllama_tpu_torch.formats.loader import SafetensorsFile, save_safetensors
from exllama_tpu_torch.perplexity import Perplexity, chunk_logprob
from exllama_tpu_torch.utils import fabricate, shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = os.path.join(REPO, "datasets", "wikitext2_val_sample.jsonl")
VOCAB = 512


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
    return cfg


@pytest.fixture(scope="module")
def models():
    jc = _tiny(JaxConfig())
    jc.tuning.matmul_impl = "xla"
    jc.tuning.attn_impl = "xla"
    jp = jax_synth(jc, 64, False, 0)
    pc = _tiny(port.ExLlamaConfig())
    pp = port.params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return JaxModel(jc, params=jp), port.ExLlama(pc, params=pp, device="cpu")


@pytest.mark.parametrize("ppl_token", [False, True])
def test_perplexity_matches_jax(models, ppl_token):
    """Perplexity of the same chunks of the bundled dataset through both
    packages, within the reference's bound 0.01 + 0.01 * ppl
    (benchmark.py:272); full-chunk logits, or one token at a time."""
    jm, pm = models
    ref = JaxPerplexity(jm, JaxCache(jm), JaxFakeTokenizer())
    got = Perplexity(pm, port.ExLlamaCache(pm), port.FakeTokenizer())
    truncate, chunks = (12, 2) if ppl_token else (24, 3)
    for p in (ref, got):
        p.load(DATASET, chunk_truncate=truncate)
    assert len(got.dataset_chunks) == len(ref.dataset_chunks) > 3
    for a, b in zip(got.dataset_chunks, ref.dataset_chunks):
        np.testing.assert_array_equal(a, b)
    p_ref = ref.test(chunk_limit=chunks, ppl_token=ppl_token, silent=True)
    p_got = got.test(chunk_limit=chunks, ppl_token=ppl_token, silent=True)
    assert np.isfinite(p_got)
    assert abs(p_got - p_ref) < 0.01 + 0.01 * p_ref


def test_chunk_logprob_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((1, 7, 50)).astype(np.float32) * 4
    targets = rng.integers(0, 50, size=(1, 7)).astype(np.int32)
    ref, n = jax_chunk_logprob(logits, targets)
    got = chunk_logprob(torch.from_numpy(logits), torch.from_numpy(targets))
    assert n == 7 and got.shape == ()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_raw_text_windows_match_jax(tmp_path):
    """Raw text loads as windows of chunk_size tokens every chunk_size -
    overlap, as the JAX package loads it."""
    path = tmp_path / "text.txt"
    lines = [json.loads(x)["text"] for x in open(DATASET, encoding="utf-8")]
    path.write_text("".join(lines[:40]), encoding="utf-8")
    ref = JaxPerplexity(None, cache=object(), tokenizer=JaxFakeTokenizer())
    got = Perplexity(None, cache=object(), tokenizer=port.FakeTokenizer())
    for p in (ref, got):
        p.load(str(path), chunk_size=96, chunk_truncate=80, overlap=16)
    assert len(got.dataset_chunks) == len(ref.dataset_chunks) > 2
    for a, b in zip(got.dataset_chunks, ref.dataset_chunks):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("act_order", [False, True])
def test_fabricate_writes_the_jax_bytes(tmp_path, act_order):
    """One seed, the same files byte for byte (config, shards, index):
    the port writes through its own safetensors writer."""
    a, b = tmp_path / "jax", tmp_path / "port"
    jfab.fabricate(str(a), "tiny", 64, act_order, shard_gb=0.0005, seed=3,
                   verbose=False)
    fabricate.fabricate(str(b), "tiny", 64, act_order, shard_gb=0.0005,
                        seed=3, verbose=False)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) > 3
    for n in names:
        assert filecmp.cmp(a / n, b / n, shallow=False), n


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_safetensors_writer_matches_the_package(tmp_path, metadata):
    rng = np.random.default_rng(4)
    tensors = {
        "b.w": rng.standard_normal((3, 5)).astype(np.float16),
        "a.q": rng.integers(-9, 9, size=(4, 2)).astype(np.int32),
        "c": rng.standard_normal(6).astype(np.float32),
        "e": np.zeros((0, 3), np.int8),
        "d": rng.integers(0, 255, size=7).astype(np.uint8),
    }
    safetensors.numpy.save_file(tensors, str(tmp_path / "a"),
                                metadata=metadata)
    save_safetensors(tensors, str(tmp_path / "b"), metadata=metadata)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    f = SafetensorsFile(str(tmp_path / "b"))
    for k, v in tensors.items():
        np.testing.assert_array_equal(f.get(k), v)


@pytest.mark.parametrize("max_gb", [0.0004, 1.0])
def test_shard_round_trip(tmp_path, max_gb):
    """A fabricated checkpoint's single file split by the port's shard tool:
    the JAX tool's shards and index byte for byte, every tensor read back
    equal, and the port's loader reads the shards as it reads the file."""
    src = tmp_path / "src"
    fabricate.fabricate(str(src), "tiny", 64, False, shard_gb=1.0, seed=1,
                        verbose=False)
    whole = src / "model-00001-of-00001.safetensors"
    out_j, out_p = tmp_path / "j", tmp_path / "p"
    out_j.mkdir()
    out_p.mkdir()
    jshard.shard_file(str(whole), max_gb, str(out_j))
    written = shard.shard_file(str(whole), max_gb, str(out_p))
    assert (len(written) > 1) == (max_gb < 0.001)
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_p))
    for n in os.listdir(out_p):
        assert filecmp.cmp(out_j / n, out_p / n, shallow=False), n
    ref = SafetensorsFile(str(whole))
    seen = set()
    for path in written:
        f = SafetensorsFile(path)
        for k in f.keys():
            np.testing.assert_array_equal(f.get(k), ref.get(k))
            seen.add(k)
    assert seen == set(ref.keys())

    cfg = port.ExLlamaConfig(str(src / "config.json"))
    cfg.max_seq_len = 32
    (out_p / "config.json").write_text((src / "config.json").read_text())
    whole_params = _load(cfg, str(whole))
    shard_params = _load(cfg, str(out_p))
    for a, b in zip(whole_params.layers, shard_params.layers):
        assert torch.equal(a.qkv.qweight, b.qkv.qweight)
        assert torch.equal(a.down.scales, b.down.scales)
    assert torch.equal(whole_params.lm_head, shard_params.lm_head)


def _load(cfg, path):
    cfg.model_path = path
    return port.load_model_params(cfg, device="cpu")


def test_benchmark_command_line_runs_on_the_cpu():
    """python -m exllama_tpu_torch.benchmark --synthetic tiny --cpu -p -ppl
    -v -l 128 exits 0, having printed its rates, a perplexity and the
    plain-vs-kernel cross-check."""
    # one thread: the tiny model's products are too small to share, and the
    # suite's other workers run beside it
    env = {**{k: v for k, v in os.environ.items()
              if k != "CUDA_VISIBLE_DEVICES"},
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "exllama_tpu_torch.benchmark", "--synthetic",
         "tiny", "--cpu", "-p", "-ppl", "-v", "-l", "128"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = r.stdout
    assert "prompt tokens/second" in out and "(greedy worst)" in out
    assert "Perplexity (auto)" in out and "Ppl delta xla<->pallas" in out \
        or "Ppl delta xla<->auto" in out
    assert "Validation passed" in out
