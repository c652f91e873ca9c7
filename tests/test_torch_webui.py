"""The port's web UI server (``webui.app``, ``webui.session``): the cases
of tests/test_webui.py -- populate, block ops, session ops, the streamed
user input -- over the real HTTP surface against a tiny model on the CPU
(hidden 256, 2 layers, vocab 260, max_seq_len 192), and the package's own
copies of the static files."""

import http.client
import json

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
def server(tmp_path_factory, _one_torch_thread):
    cfg = port.ExLlamaConfig()
    cfg.hidden_size = 256
    cfg.intermediate_size = 512
    cfg.num_attention_heads = 4
    cfg.num_key_value_heads = 4
    cfg.head_dim = 64
    cfg.num_hidden_layers = 2
    cfg.vocab_size = 260
    cfg.max_seq_len = 192
    cfg.tuning.attn_len_bucket = 64
    model = port.ExLlama(cfg, params=port.make_synthetic_params(
        cfg, 128, False, seed=13, device="cpu"), device="cpu")

    from exllama_tpu_torch.webui import app as webui_app
    from exllama_tpu_torch.webui.session import Node

    sdir = str(tmp_path_factory.mktemp("sessions"))
    httpd, thread = webui_app.make_server(model, port.FakeTokenizer(),
                                          s_dir=sdir)
    # short responses and a sane context budget for the byte tokenizer
    webui_app.session.max_response_tokens = 8
    webui_app.session.chunk_size = 32
    webui_app.session.fixed_prompt = Node("A chat.")
    webui_app.session.save()
    yield httpd
    httpd.shutdown()


def req(server, method, path, body=None):
    conn = http.client.HTTPConnection(*server.server_address)
    headers = {"Content-Type": "application/json"} if body else {}
    conn.request(method, path, json.dumps(body) if body else None, headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_index_and_static(server):
    status, data = req(server, "GET", "/")
    assert status == 200 and b"exllama_tpu_torch" in data


def test_populate(server):
    status, data = req(server, "GET", "/api/populate")
    assert status == 200
    state = json.loads(data)
    assert state["participants"] == ["User", "Chatbort"]
    assert "max_seq_len" in state and "model_info" in state


def test_block_and_settings_roundtrip(server):
    status, _ = req(server, "POST", "/api/append_block",
                    {"text": "hello block", "author": "User"})
    assert status == 200
    _, data = req(server, "GET", "/api/populate")
    hist = json.loads(data)["history"]
    assert hist and hist[-1]["text"] == "hello block"
    uuid = hist[-1]["uuid"]

    req(server, "POST", "/api/edit_block", {"uuid": uuid, "text": "edited"})
    _, data = req(server, "GET", "/api/populate")
    assert json.loads(data)["history"][-1]["text"] == "edited"

    req(server, "POST", "/api/delete_block", {"uuid": uuid})
    _, data = req(server, "GET", "/api/populate")
    assert all(n["uuid"] != uuid for n in json.loads(data)["history"])

    status, _ = req(server, "POST", "/api/set_gen_settings", {
        "temperature": 0.7, "top_p": 0.9, "min_p": 0.0, "top_k": 20,
        "typical": 0.0, "gen_endnewline": True, "max_response_tokens": 8,
        "chunk_size": 64, "token_repetition_penalty_max": 1.1,
        "token_repetition_penalty_sustain": 128,
        "token_repetition_penalty_decay": 64,
    })
    assert status == 200
    _, data = req(server, "GET", "/api/populate")
    assert json.loads(data)["temperature"] == 0.7


def test_userinput_streams_ndjson(server):
    status, data = req(server, "POST", "/api/userinput",
                       {"user_input": "hi there"})
    assert status == 200
    lines = [json.loads(s) for s in data.decode().splitlines() if s.strip()]
    cmds = [p["cmd"] for p in lines]
    assert cmds[0] == "begin_stream"
    assert "begin_block" in cmds
    assert any(p["cmd"] == "append" for p in lines)
    _, data = req(server, "GET", "/api/populate")
    hist = json.loads(data)["history"]
    assert hist[-2]["text"] == "hi there"
    assert hist[-1]["author"] == "Chatbort"


def test_session_rename_new_delete(server):
    status, data = req(server, "POST", "/api/rename_session",
                       {"new_name": "my test session"})
    assert json.loads(data)["result"] == "ok"
    _, data = req(server, "GET", "/api/populate")
    assert json.loads(data)["current_session"] == "my test session"

    req(server, "POST", "/api/set_session", {"session_name": "."})
    _, data = req(server, "GET", "/api/populate")
    state = json.loads(data)
    assert state["current_session"].startswith("Untitled")
    assert "my test session" in state["sessions"]

    req(server, "POST", "/api/delete_session", {"session": "my test session"})
    _, data = req(server, "GET", "/api/populate")
    assert "my test session" not in json.loads(data)["sessions"]


def test_static_assets_served(server):
    """The frontend (main.js + style.css) is served and self-consistent:
    index references both, and main.js drives every API route."""
    status, html = req(server, "GET", "/")
    assert status == 200
    assert b"/static/main.js" in html and b"/static/style.css" in html
    status, js = req(server, "GET", "/static/main.js")
    assert status == 200
    status, css = req(server, "GET", "/static/style.css")
    assert status == 200 and b"#sidebar" in css
    for route in (
        b"/api/populate", b"/api/edit_block", b"/api/delete_block",
        b"/api/append_block", b"/api/rename_session", b"/api/delete_session",
        b"/api/set_fixed_prompt", b"/api/set_gen_settings",
        b"/api/set_session", b"/api/set_participants", b"/api/userinput",
    ):
        assert route in js, route
