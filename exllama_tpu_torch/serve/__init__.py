"""Serving (port of exllama_tpu/serve/): the continuous-batching engine and
its HTTP and websocket front ends."""

from exllama_tpu_torch.serve.engine import ContinuousBatchingEngine, Request

__all__ = ["ContinuousBatchingEngine", "Request"]
