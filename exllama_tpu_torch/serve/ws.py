"""Websocket inference protocol (port of exllama_tpu/serve/ws.py) over the
port's ``ExLlamaAltGenerator``.

The JSON actions of the reference's websocket example (echo,
estimateToken, leftTrim, oneShotInfer, streamInfer and the default route,
request_id tagging, utilContext reporting) plus getConfig and stream
cancellation. Every request carries {"action", "request_id", ...}; every
response echoes both back. ``WsProtocol.handle`` takes any connection that
is an async iterator of messages with an async ``send``; only ``serve``
needs the ``websockets`` package, imported when it is called.

    python -m exllama_tpu_torch.serve.ws --synthetic tiny --cpu -l 128

Over a mesh (``--tp`` / ``--dp`` under ``torchrun``) rank 0 alone serves;
its generator is mirrored (``parallel.relay.Mirrored``: each call that runs
the model goes to the other ranks first, from the event loop's thread, the
one thread that generates), and the other ranks apply the same calls to
their own generators (``parallel.relay.follow_calls``) until the stop
message.

Actions:
  echo            {}                              → ack
  getConfig       {}                              → model/config summary
  estimateToken   {text}                          → token count
  leftTrim        {text, desiredLen}              → last desiredLen tokens
  oneShotInfer    {text, maxNew, sampler fields}  → full response at once,
                                                    with utilContext (the
                                                    possibly-truncated
                                                    prompt actually used)
  streamInfer     {text, maxNew, sampler fields}  → incremental frames
                                                    {response, utilContext},
                                                    final frame eos=true
  stopStream      {}                              → cancel in-flight stream
  (anything else) → treated as streamInfer (reference default route)
"""

from __future__ import annotations

import asyncio
import json

from exllama_tpu_torch.alt_generator import ExLlamaAltGenerator
from exllama_tpu_torch.parallel.relay import (
    Mirrored,
    follow_calls,
    quiet_follower,
    relay_for,
)


class WsProtocol:
    """One generator-backed protocol endpoint; ``handle`` is the
    websockets-compatible connection coroutine."""

    def __init__(self, model, tokenizer, cache, relay=None):
        self.model = model
        self.tokenizer = tokenizer
        self.generator = ExLlamaAltGenerator(model, tokenizer, cache)
        if relay is not None:
            self.generator = Mirrored(self.generator, relay)
        self.stop_requested = False

    # ------------------------------------------------------------- helpers

    def make_settings(self, req):
        s = ExLlamaAltGenerator.Settings()
        s.temperature = float(req.get("temperature", req.get("temp", 0.95)))
        s.top_k = int(req.get("top_k", 40))
        s.top_p = float(req.get("top_p", 0.65))
        s.min_p = float(req.get("min_p", 0.0))
        s.typical = float(req.get("typical", 0.0))
        s.token_repetition_penalty_max = float(
            req.get("rep_penalty", req.get("rep_pen", 1.15))
        )
        return s

    def stop_conditions(self, req):
        stops = [self.tokenizer.eos_token_id]
        sc = req.get("stop_conditions", req.get("stopToken"))
        if isinstance(sc, str):
            stops += [s for s in sc.split(",") if s]
        elif isinstance(sc, list):
            stops += sc
        return stops

    @staticmethod
    def reply(action, request_id, **fields):
        return json.dumps(
            {"action": action, "request_id": request_id, **fields}
        )

    # ------------------------------------------------------------- handler

    async def handle(self, ws):
        gen = self.generator
        cfg = self.model.config
        async for message in ws:
            try:
                req = json.loads(message)
            except json.JSONDecodeError:
                await ws.send(json.dumps({"error": "bad json"}))
                continue
            action = req.get("action", "streamInfer")
            request_id = req.get("request_id", "")
            max_new = int(req.get("max_new_tokens", req.get("maxNew", 200)))

            if action == "echo":
                await ws.send(self.reply(action, request_id))

            elif action == "getConfig":
                await ws.send(self.reply(
                    action, request_id,
                    response={
                        "model": cfg.model_path or "synthetic",
                        "max_seq_len": cfg.max_seq_len,
                        "vocab_size": cfg.vocab_size,
                        "hidden_size": cfg.hidden_size,
                        "layers": cfg.num_hidden_layers,
                    },
                ))

            elif action == "estimateToken":
                n = gen.get_num_tokens(req["text"])
                await ws.send(self.reply(action, request_id, response=n))

            elif action == "leftTrim":
                # keep the LAST desiredLen tokens (reference leftTrimTokens,
                # example_ws.py:147-152)
                ids = gen.cached_tokenize(req["text"])
                want = int(req["desiredLen"])
                trimmed = (
                    self.tokenizer.decode(ids[0, -want:]) if want > 0 else ""
                )
                await ws.send(self.reply(action, request_id,
                                         response=trimmed))

            elif action == "oneShotInfer":
                out = gen.generate(req["text"], self.stop_conditions(req),
                                   max_new, self.make_settings(req))
                await ws.send(self.reply(
                    action, request_id,
                    utilContext=gen.sequence_str, response=out,
                ))

            elif action == "stopStream":
                self.stop_requested = True
                await ws.send(self.reply(action, request_id))

            else:  # streamInfer and the reference's default route
                if "text" not in req:
                    # unknown action without a prompt (e.g. a typo'd
                    # action name): protocol-level error reply instead of
                    # a KeyError that kills the connection
                    await ws.send(self.reply(
                        action, request_id,
                        error=f"unknown action {action!r} (no 'text')",
                    ))
                    continue
                self.stop_requested = False
                gen.begin_stream(req["text"], self.stop_conditions(req),
                                 max_new, self.make_settings(req))
                built = ""
                while True:
                    chunk, eos = gen.stream()
                    built += chunk
                    if chunk:
                        await ws.send(self.reply(
                            action, request_id,
                            utilContext=gen.sequence_str,
                            response=chunk,
                        ))
                    # yield to the event loop so a stopStream on another
                    # connection can land mid-generation
                    await asyncio.sleep(0)
                    if self.stop_requested:
                        eos = True
                    if eos:
                        await ws.send(self.reply(
                            action, request_id,
                            utilContext=gen.sequence_str,
                            response="", eos=True, fullResponse=built,
                        ))
                        break


def serve(model, tokenizer, cache, host="0.0.0.0", port=8765, relay=None):
    """Blocking websocket server (``main``;
    ``python -m exllama_tpu_torch.examples.example_ws``). Over a mesh
    (``relay``) rank 0 serves and the other ranks follow its generator
    until the stop message."""
    if relay is not None and not relay.leader:
        follow_calls(ExLlamaAltGenerator(model, tokenizer, cache), relay)
        return
    proto = WsProtocol(model, tokenizer, cache, relay)

    async def main():
        import websockets

        async with websockets.serve(proto.handle, host, port):
            print(f"websocket server on {host}:{port}")
            await asyncio.Future()

    try:
        asyncio.run(main())
    finally:
        if relay is not None:
            relay.stop()


def main(argv=None):
    import argparse

    from exllama_tpu_torch import benchmark
    from exllama_tpu_torch.cache import ExLlamaCache

    parser = argparse.ArgumentParser(description="exllama_tpu_torch "
                                                 "websocket server")
    benchmark.add_model_args(parser)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8765)
    args = parser.parse_args(argv)
    with quiet_follower(args):
        model, tokenizer = benchmark.load(args)
        serve(model, tokenizer, ExLlamaCache(model), args.host, args.port,
              relay_for(model))


if __name__ == "__main__":
    main()
