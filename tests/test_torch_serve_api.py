"""The port's HTTP serving API (``serve.api``): the cases of
tests/test_serve_api.py, concurrent clients batching on the port's engine,
on the CPU at their shapes (hidden 256, 2 layers, vocab 260, max_seq_len
128)."""

import http.client
import json
import threading

import pytest
import torch

import exllama_tpu_torch as port


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
    cfg.max_seq_len = 128
    cfg.tuning.attn_len_bucket = 32
    model = port.ExLlama(cfg, params=port.make_synthetic_params(
        cfg, 128, False, seed=41, device="cpu"), device="cpu")

    from exllama_tpu_torch.serve import api as serve_api

    api, httpd, thread = serve_api.make_server(
        model, port.FakeTokenizer(), max_slots=4)
    yield httpd
    httpd.shutdown()
    api.shutdown()


def post(server, path, body):
    conn = http.client.HTTPConnection(*server.server_address, timeout=300)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_health(server):
    conn = http.client.HTTPConnection(*server.server_address)
    conn.request("GET", "/health")
    r = conn.getresponse()
    assert r.status == 200
    assert json.loads(r.read())["status"] == "ok"
    conn.close()


def test_completion(server):
    status, data = post(server, "/v1/completions",
                        {"prompt": "hello api", "max_tokens": 6,
                         "temperature": 1.0, "top_k": 1})
    assert status == 200
    out = json.loads(data)
    assert len(out["choices"]) == 1
    assert isinstance(out["choices"][0]["text"], str)


def test_batch_prompt_list(server):
    status, data = post(server, "/v1/completions",
                        {"prompt": ["one", "two", "three"], "max_tokens": 4,
                         "top_k": 1, "temperature": 1.0})
    assert status == 200
    assert len(json.loads(data)["choices"]) == 3


def test_concurrent_clients(server):
    results = {}

    def client(i):
        status, data = post(server, "/v1/completions",
                            {"prompt": f"client {i}", "max_tokens": 4,
                             "top_k": 1, "temperature": 1.0})
        results[i] = (status, json.loads(data))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(results) == 6
    assert all(s == 200 for s, _ in results.values())


def test_streaming(server):
    status, data = post(server, "/v1/completions",
                        {"prompt": "stream", "max_tokens": 5, "top_k": 1,
                         "temperature": 1.0, "stream": True})
    assert status == 200
    text = data.decode()
    assert "data: [DONE]" in text
    payloads = [json.loads(line[len("data: "):])
                for line in text.splitlines()
                if line.startswith("data: ") and "[DONE]" not in line]
    assert payloads and all("choices" in p for p in payloads)


def test_bad_request(server):
    status, data = post(server, "/v1/completions", {"nope": 1})
    assert status == 400
