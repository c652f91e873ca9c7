"""The port's examples (``exllama_tpu_torch/examples``): each one that ends
on its own runs as ``python -m exllama_tpu_torch.examples.<name>
--synthetic tiny --cpu -l 128 --max_new 6`` in a subprocess (the chatbot
with two lines on stdin, the LoRA example on an adapter written by
``utils.fabricate.fabricate_lora``); the two that serve until killed are
imported and their request handling is driven in process."""

import http.client
import importlib
import json
import os
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--synthetic", "tiny", "--cpu", "-l", "128", "--max_new", "6"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the shapes are tiny and the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_example(name, extra=(), stdin=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", f"exllama_tpu_torch.examples.{name}", *ARGS,
         *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
        input=stdin)
    assert r.returncode == 0, (name, r.stdout[-800:], r.stderr[-800:])
    assert r.stdout.strip(), (name, "no output")
    return r.stdout


@pytest.mark.parametrize("name", ["example_basic", "example_batch",
                                  "example_cfg", "example_alt_generator",
                                  "example_speculative"])
def test_example_runs(name):
    run_example(name)


def test_chatbot_reads_stdin():
    out = run_example("example_chatbot", stdin="hello there\nquit\n")
    assert "This is a conversation between User" in out
    assert "Chatbort:" in out


def test_lora_example(tmp_path):
    import exllama_tpu_torch as port
    from exllama_tpu_torch import benchmark
    from exllama_tpu_torch.utils.fabricate import fabricate_lora

    cfg = port.ExLlamaConfig()
    for k, v in benchmark.SYNTH_SHAPES["tiny"].items():
        setattr(cfg, k, v)
    fabricate_lora(str(tmp_path), cfg, ("q", "v"), r=4, scale=0.3)
    assert sorted(os.listdir(tmp_path)) == ["adapter_config.json",
                                            "adapter_model.safetensors"]
    run_example("example_lora", ["--lora_dir", str(tmp_path)])


def test_flask_example_serves_presets():
    """example_flask's handler answers each preset route and 404s an
    unknown one (in process: its main serves until killed)."""
    mod = importlib.import_module("exllama_tpu_torch.examples.example_flask")
    from exllama_tpu_torch.examples.common import build_from_args
    from exllama_tpu_torch.generator import ExLlamaGenerator

    args, cfg, model, tok, cache = build_from_args("flask", argv=ARGS)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(
        ExLlamaGenerator(model, tok, cache), max_new_tokens=4))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        for path, code in (("/infer_precise", 200), ("/infer_sphinx", 200),
                           ("/infer_nothing", 404)):
            conn = http.client.HTTPConnection(*httpd.server_address)
            conn.request("POST", path, json.dumps({"prompt": "Hi"}))
            r = conn.getresponse()
            body = r.read()
            conn.close()
            assert r.status == code, path
            if code == 200:
                assert body.decode().startswith("Hi")
    finally:
        httpd.shutdown()


def test_ws_example_imports():
    """example_ws serves until killed: it imports, and its protocol is
    tests/test_torch_ws.py's."""
    mod = importlib.import_module("exllama_tpu_torch.examples.example_ws")
    from exllama_tpu_torch.serve import ws

    assert mod.serve is ws.serve and callable(mod.main)
