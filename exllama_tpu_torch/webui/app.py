"""Web chat server (port of exllama_tpu/webui/app.py) on the stdlib
ThreadingHTTPServer, over the port's generator and cache. Routes:

  GET  /                      chat frontend (static/index.html)
  GET  /static/<file>         assets
  GET  /api/populate          full session state JSON
  POST /api/edit_block        {"uuid", "text"}
  POST /api/delete_block      {"uuid"}
  POST /api/rename_session    {"new_name"}
  POST /api/delete_session    {"session"}
  POST /api/set_fixed_prompt  {"fixed_prompt", "keep_fixed_prompt"}
  POST /api/set_gen_settings  {sampler fields}
  POST /api/set_session       {"session_name"} ("." = new)
  POST /api/set_participants  {"participants"}
  POST /api/append_block      {"text"[, "author"]}
  POST /api/userinput         {"user_input"} → streamed NDJSON packets

Generation runs under a global lock. The static files are the package's
own copies (``webui/static``).

Over a mesh (``--tp`` / ``--dp`` under ``torchrun``) rank 0 alone serves;
its session's generator is mirrored to the other ranks
(``parallel.relay``), which follow it (:func:`follow`) until the stop
message. Every POST route then runs under ``generate_lock``, so that no
relay message of one route falls between those of a generation.

    python -m exllama_tpu_torch.webui.app --synthetic tiny --cpu -l 512
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from exllama_tpu_torch.parallel.relay import (
    follow_calls,
    quiet_follower,
    relay_for,
)
from exllama_tpu_torch.webui import session as session_mod
from exllama_tpu_torch.webui.session import (
    get_initial_session,
    load_session,
    new_session,
    prepare_sessions,
)

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")

generate_lock = threading.Lock()
session = None


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    # ------------------------------------------------------------- helpers

    def _json_body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _send(self, body: bytes, ctype="application/json", code=200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_chunked_start(self, ctype="application/json"):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _send_chunk(self, data: bytes):
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

    def _end_chunks(self):
        self.wfile.write(b"0\r\n\r\n")

    # --------------------------------------------------------------- routes

    def do_GET(self):
        global session
        if self.path == "/" or self.path == "/index.html":
            with open(os.path.join(STATIC_DIR, "index.html"), "rb") as f:
                self._send(f.read(), "text/html")
        elif self.path.startswith("/static/"):
            name = os.path.basename(self.path[len("/static/"):])
            path = os.path.join(STATIC_DIR, name)
            if not os.path.isfile(path):
                self._send(b"not found", "text/plain", 404)
                return
            ctype = {
                ".js": "text/javascript",
                ".css": "text/css",
                ".html": "text/html",
            }.get(os.path.splitext(name)[1], "application/octet-stream")
            with open(path, "rb") as f:
                self._send(f.read(), ctype)
        elif self.path == "/api/populate":
            self._send(session.api_populate().encode())
        else:
            self._send(b"not found", "text/plain", 404)

    def do_POST(self):
        try:
            data = self._json_body()
        except (json.JSONDecodeError, ValueError):
            self._send(
                json.dumps({"result": "error", "error": "bad json"}).encode(),
                code=400,
            )
            return
        route = self.path
        # over a mesh every route that may call the generator holds the
        # lock (the user input's takes it itself)
        mirrored = (session_mod.relay is not None
                    and route != "/api/userinput")
        with generate_lock if mirrored else contextlib.nullcontext():
            self._route(route, data)

    def _route(self, route, data):
        global session
        ok = json.dumps({"result": "ok"}).encode() + b"\n"

        try:
            if route == "/api/userinput":
                user_input = data["user_input"]
                with generate_lock:
                    self._send_chunked_start()
                    try:
                        for packet in session.respond_multi(user_input):
                            self._send_chunk(packet.encode())
                    finally:
                        self._end_chunks()
                return

            if route == "/api/edit_block":
                session.api_edit_block(data)
            elif route == "/api/delete_block":
                session.api_delete_block(data)
            elif route == "/api/append_block":
                session.api_append_block(data)
            elif route == "/api/rename_session":
                success = session.api_rename_session(data)
                ok = json.dumps(
                    {"result": "ok" if success else "fail"}
                ).encode() + b"\n"
            elif route == "/api/delete_session":
                session.api_delete_session(data)
            elif route == "/api/set_fixed_prompt":
                session.api_set_fixed_prompt(data)
            elif route == "/api/set_gen_settings":
                session.api_set_gen_settings(data)
            elif route == "/api/set_participants":
                session.api_set_participants(data)
            elif route == "/api/set_session":
                name = data["session_name"]
                session = new_session() if name == "." else load_session(
                    name, append_path=True
                )
            else:
                self._send(b"not found", "text/plain", 404)
                return
        except (KeyError, TypeError, FileNotFoundError) as e:
            self._send(
                json.dumps(
                    {"result": "error", "error": f"{type(e).__name__}: {e}"}
                ).encode(),
                code=400,
            )
            return
        self._send(ok)


def follow(model, tokenizer, relay) -> dict:
    """A follower rank's loop over a mesh: rank 0's session's generator
    calls on this rank's own generator, until the stop message
    (``parallel.relay.follow_calls``)."""
    from exllama_tpu_torch.cache import ExLlamaCache
    from exllama_tpu_torch.generator import ExLlamaGenerator

    return follow_calls(ExLlamaGenerator(model, tokenizer,
                                         ExLlamaCache(model)), relay)


def serve(model, tokenizer, host="0.0.0.0", port=5000,
          s_dir="~/exllama_sessions", verbose=True, relay=None):
    """Start the chat server (blocking). Returns the server object if you
    start it in a thread yourself via ``make_server``. Over a mesh
    (``relay``) rank 0 serves and the other ranks :func:`follow`."""
    global session
    if relay is not None and not relay.leader:
        follow(model, tokenizer, relay)
        return
    try:
        prepare_sessions(model, tokenizer, s_dir, relay)
        session = get_initial_session()
        httpd = ThreadingHTTPServer((host, port), Handler)
        if verbose:
            print(f" -- serving on http://{host}:{port}")
        httpd.serve_forever()
    finally:
        if relay is not None:
            with generate_lock:
                relay.stop()


def make_server(model, tokenizer, host="127.0.0.1", port=0,
                s_dir="~/exllama_sessions", relay=None):
    """Non-blocking variant for tests/embedding: returns (httpd, thread).
    Over a mesh the other ranks :func:`follow` meanwhile; the caller ends
    them with ``relay.stop()`` (under ``generate_lock``) once the server is
    shut down."""
    global session
    prepare_sessions(model, tokenizer, s_dir, relay)
    session = get_initial_session()
    httpd = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def main(argv=None):
    from exllama_tpu_torch import benchmark

    parser = argparse.ArgumentParser(description="exllama_tpu_torch web UI")
    benchmark.add_model_args(parser)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--sessions_dir", type=str,
                        default="~/exllama_sessions")
    args = parser.parse_args(argv)
    with quiet_follower(args):
        model, tokenizer = benchmark.load(args)
        serve(model, tokenizer, args.host, args.port, args.sessions_dir,
              relay=relay_for(model))


if __name__ == "__main__":
    main()
