"""The port's websocket protocol (``serve.ws``): the cases of
tests/test_ws.py, every action over a real websocket connection against a
tiny model on the CPU (hidden 256, 2 layers, vocab 260, max_seq_len 96)."""

import asyncio
import json
import threading

import pytest
import torch

import exllama_tpu_torch as port
from exllama_tpu_torch.serve.ws import WsProtocol

websockets = pytest.importorskip("websockets")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the shapes are tiny and the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server(_one_torch_thread):
    cfg = port.ExLlamaConfig()
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 2
    cfg.head_dim = 64
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 260
    cfg.max_seq_len = 96
    cfg.tuning.attn_len_bucket = 32
    model = port.ExLlama(cfg, params=port.make_synthetic_params(
        cfg, 128, False, seed=7, device="cpu"), device="cpu")
    proto = WsProtocol(model, port.FakeTokenizer(), port.ExLlamaCache(model))

    loop = asyncio.new_event_loop()
    box = {}
    started = threading.Event()

    async def run():
        box["stop"] = asyncio.get_running_loop().create_future()
        async with websockets.serve(proto.handle, "127.0.0.1", 0,
                                    ping_interval=None) as srv:
            box["port"] = srv.sockets[0].getsockname()[1]
            started.set()
            await box["stop"]

    t = threading.Thread(target=lambda: loop.run_until_complete(run()),
                         daemon=True)
    t.start()
    assert started.wait(30)
    yield box["port"]
    loop.call_soon_threadsafe(box["stop"].set_result, None)
    t.join(timeout=10)


def roundtrip(port_no, requests):
    """Send requests on one connection; collect replies until each
    non-streaming request got one reply and each stream hit eos."""

    async def go():
        out = []
        async with websockets.connect(f"ws://127.0.0.1:{port_no}",
                                      ping_interval=None,
                                      open_timeout=60) as ws:
            for req in requests:
                await ws.send(json.dumps(req))
                while True:
                    r = json.loads(await ws.recv())
                    out.append(r)
                    if r.get("action") not in ("streamInfer", "default"):
                        break
                    if r.get("eos"):
                        break
        return out

    return asyncio.run(go())


def test_echo_and_config(server):
    out = roundtrip(server, [
        {"action": "echo", "request_id": "a"},
        {"action": "getConfig", "request_id": "b"},
    ])
    assert out[0] == {"action": "echo", "request_id": "a"}
    assert out[1]["response"]["max_seq_len"] == 96
    assert out[1]["response"]["layers"] == 2


def test_estimate_and_lefttrim(server):
    out = roundtrip(server, [
        {"action": "estimateToken", "request_id": "c",
         "text": "count these tokens"},
        {"action": "leftTrim", "request_id": "d",
         "text": "abcdefghij", "desiredLen": 4},
    ])
    assert out[0]["response"] == len("count these tokens")
    assert out[1]["response"] == "ghij"      # FakeTokenizer is byte-level


def test_oneshot_infer(server):
    out = roundtrip(server, [
        {"action": "oneShotInfer", "request_id": "e", "text": "one shot",
         "maxNew": 6, "top_k": 1, "temperature": 1.0, "rep_pen": 1.0},
    ])
    r = out[0]
    assert r["request_id"] == "e"
    assert isinstance(r["response"], str)
    assert r["utilContext"].startswith("one shot")


def test_stream_infer_frames(server):
    out = roundtrip(server, [
        {"action": "streamInfer", "request_id": "f", "text": "stream it",
         "maxNew": 6, "top_k": 1, "temperature": 1.0, "rep_pen": 1.0},
    ])
    assert out[-1]["eos"] is True
    assert "".join(r["response"] for r in out) == out[-1]["fullResponse"]
    assert all(r["request_id"] == "f" for r in out)


def test_default_route_streams(server):
    out = roundtrip(server, [
        {"action": "default", "request_id": "g", "text": "via default",
         "maxNew": 4, "top_k": 1, "temperature": 1.0, "rep_pen": 1.0},
    ])
    assert out[-1]["eos"] is True
