"""HTTP serving API over the continuous-batching engine (port of
exllama_tpu/serve/api.py).

A minimal OpenAI-style surface on the stdlib ``ThreadingHTTPServer``:

  POST /v1/completions
      {"prompt": str | [str], "max_tokens": int, "temperature": float,
       "top_p": float, "top_k": int, "stream": bool}
    → {"choices": [{"text": ..., "index": ...}]}  (or SSE lines when
      stream=true: "data: {json}\\n\\n", terminated by "data: [DONE]")
  GET /health → {"status": "ok", "active": N, "queued": M}

The engine loop runs on a background thread, the only one that steps the
engine and so the only one that touches a tensor on the card; HTTP threads
submit requests under the lock and wait on host-side request state, so many
clients batch together in one decode step.

Over a mesh (``--tp`` / ``--dp`` under ``torchrun``) every rank holds its
shard and runs the engine in lockstep; rank 0 alone binds the server. Under
its lock, before every ``step()``, it sends the requests its engine took
since the last step on the relay (``parallel.relay``: prompt ids,
``max_new_tokens``, sampler settings, stop tokens and strings, adapter id;
an empty list where none is new; nothing while idle). The other ranks
(:func:`follow`) submit the same requests in the same order and step, so
request ids, slots and the seeded sampling stay the same on every rank.
``shutdown()`` sends the stop message.

    python -m exllama_tpu_torch.serve.api --synthetic tiny --cpu -l 128
    python -m exllama_tpu_torch.serve.api -d MODEL_DIR --port 8000
    torchrun --nproc-per-node 2 -m exllama_tpu_torch.serve.api -d MODEL_DIR \
        --tp 2 --backend nccl

(on the card unless ``--cpu`` is given; ``--synthetic`` draws a model of
one of the benchmark's shapes from seed 0.)
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from exllama_tpu_torch.ops.sampling import SamplerSettings
from exllama_tpu_torch.parallel.relay import STOP, quiet_follower, relay_for
from exllama_tpu_torch.serve.engine import ContinuousBatchingEngine


def _relayed(req) -> dict:
    """What a follower's ``engine.submit`` takes of ``req``: all but the
    callbacks."""
    return dict(prompt=req.prompt_ids, max_new_tokens=req.max_new_tokens,
                settings=req.settings, stop_tokens=req.stop_tokens,
                stop_strings=req.stop_strings, lora_id=req.lora_id)


class ServingAPI:
    """``relay``: rank 0's ``parallel.relay.Relay`` over a mesh (None
    off one)."""

    def __init__(self, model, tokenizer, max_slots: int = 8, relay=None):
        self.engine = ContinuousBatchingEngine(
            model, tokenizer, max_slots=max_slots
        )
        self.tokenizer = tokenizer
        self.relay = relay
        self._new: list = []        # taken since the last relayed step
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop:
            with self._lock:
                worked = False
                if self.engine.has_work():
                    if self.relay is not None:
                        self.relay.send([_relayed(r) for r in self._new])
                        self._new = []
                    self.engine.step()
                    worked = True
            if not worked:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)
        if self.relay is not None:
            with self._lock:
                self.relay.stop()

    def submit(self, prompt, max_tokens, settings, stream_q=None):
        on_token = None
        if stream_q is not None:
            def on_token(req, tok):
                stream_q.put(("tok", tok))
        with self._lock:
            req = self.engine.submit(
                prompt, max_new_tokens=max_tokens, settings=settings,
                on_token=on_token,
            )
            if self.relay is not None:
                self._new.append(req)
        self._wake.set()
        return req

    def wait(self, req, timeout=600):
        deadline = time.monotonic() + timeout
        while req.state != "done":
            if time.monotonic() > deadline:
                raise TimeoutError("generation timed out")
            time.sleep(0.005)
        return req


def make_handler(api: ServingAPI):
    tokenizer = api.tokenizer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send_json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send_json({
                    "status": "ok",
                    "active": api.engine.num_active,
                    "queued": len(api.engine.queue),
                })
            else:
                self._send_json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path != "/v1/completions":
                self._send_json({"error": "not found"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(length))
                prompts = data["prompt"]
            except (json.JSONDecodeError, KeyError, ValueError) as e:
                self._send_json({"error": f"bad request: {e}"}, 400)
                return
            if isinstance(prompts, str):
                prompts = [prompts]
            max_tokens = int(data.get("max_tokens", 128))
            settings = SamplerSettings(
                temperature=float(data.get("temperature", 0.95)),
                top_k=int(data.get("top_k", 40)),
                top_p=float(data.get("top_p", 0.65)),
                min_p=float(data.get("min_p", 0.0)),
                typical=float(data.get("typical", 0.0)),
                token_repetition_penalty_max=float(
                    data.get("repetition_penalty", 1.15)
                ),
            )

            if data.get("stream") and len(prompts) == 1:
                q: queue.Queue = queue.Queue()
                req = api.submit(prompts[0], max_tokens, settings, stream_q=q)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(data: bytes):
                    self.wfile.write(
                        f"{len(data):X}\r\n".encode() + data + b"\r\n"
                    )

                sent = 0
                text_so_far = ""
                while True:
                    q.get()  # token arrived (or finished)
                    full = tokenizer.decode(req.output_ids)
                    delta, text_so_far = full[len(text_so_far):], full
                    if delta:
                        chunk(
                            b"data: "
                            + json.dumps(
                                {"choices": [{"text": delta, "index": 0}]}
                            ).encode()
                            + b"\n\n"
                        )
                        sent += 1
                    if req.state == "done" and q.empty():
                        break
                chunk(b"data: [DONE]\n\n")
                self.wfile.write(b"0\r\n\r\n")
                return

            reqs = [api.submit(p, max_tokens, settings) for p in prompts]
            for r in reqs:
                api.wait(r)
            self._send_json({
                "object": "text_completion",
                "choices": [
                    {"index": i, "text": tokenizer.decode(r.output_ids),
                     "finish_reason": "stop"}
                    for i, r in enumerate(reqs)
                ],
            })

    return Handler


def follow(engine, relay) -> int:
    """A follower rank's loop over a mesh: for each of rank 0's messages,
    submit its requests to ``engine`` in order and ``step()``; return the
    number of steps at the stop message."""
    steps = 0
    while True:
        msg = relay.recv()
        if msg == STOP:
            return steps
        for fields in msg:
            engine.submit(**fields)
        engine.step()
        steps += 1


def serve(model, tokenizer, host="0.0.0.0", port=8000, max_slots=8,
          relay=None):
    """Serve until interrupted. Over a mesh (``relay``) rank 0 serves and
    the other ranks follow its engine until the stop message."""
    if relay is not None and not relay.leader:
        follow(ContinuousBatchingEngine(model, tokenizer,
                                        max_slots=max_slots), relay)
        return
    api = ServingAPI(model, tokenizer, max_slots=max_slots, relay=relay)
    httpd = ThreadingHTTPServer((host, port), make_handler(api))
    print(f" -- serving completions on http://{host}:{port}")
    try:
        httpd.serve_forever()
    finally:
        api.shutdown()


def make_server(model, tokenizer, host="127.0.0.1", port=0, max_slots=8,
                relay=None):
    """Rank 0's server on a thread: (api, httpd, thread). Over a mesh the
    other ranks run :func:`follow` meanwhile; ``api.shutdown()`` stops
    them."""
    api = ServingAPI(model, tokenizer, max_slots=max_slots, relay=relay)
    httpd = ThreadingHTTPServer((host, port), make_handler(api))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return api, httpd, thread


def main(argv=None):
    import argparse

    from exllama_tpu_torch import benchmark

    parser = argparse.ArgumentParser(description="exllama_tpu_torch serving "
                                                 "API")
    benchmark.add_model_args(parser)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_slots", type=int, default=8)
    args = parser.parse_args(argv)
    with quiet_follower(args):
        model, tokenizer = benchmark.load(args)
        serve(model, tokenizer, args.host, args.port, args.max_slots,
              relay_for(model))


if __name__ == "__main__":
    main()
