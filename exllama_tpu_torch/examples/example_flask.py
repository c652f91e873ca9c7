"""A small HTTP inference API with preset sampler profiles (the routes
/infer_precise, /infer_creative and /infer_sphinx of the reference's Flask
example, on the stdlib http.server). Serves until killed. One request
generates at a time (a lock). Over a mesh rank 0 serves through a mirrored
generator (``parallel.relay``) and the other ranks follow it."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from exllama_tpu_torch.examples.common import build_from_args
from exllama_tpu_torch.generator import ExLlamaGenerator
from exllama_tpu_torch.parallel.relay import Mirrored, follow_calls, relay_for

PRESETS = {
    "precise": dict(token_repetition_penalty_max=1.176,
                    temperature=0.7, top_p=0.1, top_k=40, typical=0.0),
    "creative": dict(token_repetition_penalty_max=1.1,
                     temperature=0.72, top_p=0.73, top_k=0, typical=0.0),
    "sphinx": dict(token_repetition_penalty_max=1.15,
                   temperature=1.99, top_p=0.18, top_k=30, typical=0.0),
}


def make_handler(generator, max_new_tokens=200, lock=None):
    """A request handler class that answers POST /infer_<preset> with the
    completion of the JSON body's "prompt" (or the raw body), one at a time
    under ``lock``."""
    cfg = generator.model.config
    lock = lock or threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            preset = self.path.strip("/").replace("infer_", "")
            if preset not in PRESETS:
                self.send_response(404)
                self.end_headers()
                return
            body = self.rfile.read(
                int(self.headers.get("Content-Length", 0))).decode()
            try:
                prompt = json.loads(body)["prompt"]
            except (json.JSONDecodeError, KeyError, TypeError):
                prompt = body  # raw text too
            with lock:
                for k, v in PRESETS[preset].items():
                    setattr(generator.settings, k, v)
                generator.settings.token_repetition_penalty_sustain = \
                    cfg.max_seq_len
                data = generator.generate_simple(
                    prompt, max_new_tokens=max_new_tokens).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    return Handler


def main(argv=None):
    def extra(parser):
        parser.add_argument("--host", default="0.0.0.0")
        parser.add_argument("--port", type=int, default=8004)

    args, cfg, model, tokenizer, cache = build_from_args(
        "inference API", extra_args=extra, argv=argv)
    generator = ExLlamaGenerator(model, tokenizer, cache)
    relay = relay_for(model)
    if relay is not None and not relay.leader:
        follow_calls(generator, relay)
        return
    if relay is not None:
        generator = Mirrored(generator, relay)
    print(f"serving /infer_precise /infer_creative /infer_sphinx on "
          f"{args.port}")
    lock = threading.Lock()
    try:
        ThreadingHTTPServer((args.host, args.port),
                            make_handler(generator, args.max_new or 200, lock)
                            ).serve_forever()
    finally:
        if relay is not None:
            with lock:
                relay.stop()


if __name__ == "__main__":
    main()
