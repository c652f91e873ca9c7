"""Websocket inference server: a thin wrapper around
``exllama_tpu_torch.serve.ws`` (the protocol lives there). Needs the
``websockets`` package; serves until killed. Over a mesh rank 0 serves and
the other ranks follow its generator (``serve.ws``).

    python -m exllama_tpu_torch.examples.example_ws --synthetic tiny --cpu
"""

import os

from exllama_tpu_torch.examples.common import build_from_args
from exllama_tpu_torch.parallel.relay import relay_for
from exllama_tpu_torch.serve.ws import serve


def main(argv=None):
    args, cfg, model, tokenizer, cache = build_from_args("websocket server",
                                                         argv=argv)
    serve(model, tokenizer, cache, port=int(os.environ.get("WS_PORT", 8765)),
          relay=relay_for(model))


if __name__ == "__main__":
    main()
