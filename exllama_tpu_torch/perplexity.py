"""Perplexity evaluation (port of exllama_tpu/perplexity.py).

Load a dataset as jsonl (one chunk per line) or raw text (fixed windows
with overlap) and compute ppl = exp(-mean log p(target)) over the chunks,
from full-chunk logits or, with ``ppl_token``, token by token through the
decode path. The log-softmax and the gather of the targets run on the
model's device in f32, and one scalar a chunk comes back to the host; the
cache is reset per chunk, as in the reference's methodology.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np
import torch

from exllama_tpu_torch.cache import ExLlamaCache


def chunk_logprob(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sum of log p(target) over one chunk, a 0-dim f32 tensor on the
    logits' device. logits [1, T, V] predicting targets [1, T]."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    idx = targets.to(device=logits.device, dtype=torch.long)[..., None]
    return torch.gather(logp, -1, idx).sum()


class Perplexity:
    def __init__(self, model, cache: Optional[ExLlamaCache] = None,
                 tokenizer=None):
        self.model = model
        self.cache = cache or ExLlamaCache(model)
        self.tokenizer = tokenizer
        self.dataset_chunks: list[np.ndarray] = []

    # ---------------------------------------------------------------- data

    def load(
        self,
        dataset_path: str,
        chunk_size: int = 2048,
        chunk_truncate: Optional[int] = None,
        overlap: int = 0,
        minlength: int = 50,
        json_key: str = "text",
    ):
        """jsonl -> one chunk a line (lines shorter than ``minlength``
        characters skipped); raw text -> windows of ``chunk_size`` tokens
        starting every ``chunk_size - overlap``."""
        self.dataset_chunks = []
        if dataset_path.endswith(".jsonl") or dataset_path.endswith(".json"):
            with open(dataset_path, encoding="utf-8") as f:
                for line in f:
                    text = json.loads(line)[json_key]
                    if len(text) < minlength:
                        continue
                    ids = self.tokenizer.encode(text)
                    if chunk_truncate is not None:
                        ids = ids[:, :chunk_truncate]
                    if ids.shape[1] >= 2:
                        self.dataset_chunks.append(np.asarray(ids, np.int32))
        else:
            with open(dataset_path, encoding="utf-8") as f:
                text = f.read()
            ids = self.tokenizer.encode(text)[0]
            step = chunk_size - overlap
            for start in range(0, len(ids) - chunk_size, step):
                chunk = ids[start : start + chunk_size][None, :]
                if chunk_truncate is not None:
                    chunk = chunk[:, :chunk_truncate]
                self.dataset_chunks.append(np.asarray(chunk, np.int32))

    # ---------------------------------------------------------------- eval

    def test(
        self,
        chunk_limit: Optional[int] = None,
        ppl_token: bool = False,
        silent: bool = False,
    ) -> float:
        """Perplexity over the loaded chunks. ``ppl_token`` feeds one token
        at a time (the decode path: the GEMV and fused decode kernels)."""
        logprob_sum = 0.0
        token_count = 0
        chunks = self.dataset_chunks
        if chunk_limit is not None:
            chunks = chunks[:chunk_limit]
        for ids in chunks:
            ids = ids[:, : self.model.config.max_seq_len]
            self.cache.current_seq_len = 0
            targets = torch.as_tensor(ids[:, 1:]).to(self.model.device)
            if ppl_token:
                lp = torch.zeros((), dtype=torch.float32,
                                 device=self.model.device)
                for t in range(ids.shape[1] - 1):
                    logits = self.model.forward(ids[:, t : t + 1], self.cache)
                    lp = lp + chunk_logprob(logits, targets[:, t : t + 1])
            else:
                logits = self.model.forward(ids[:, :-1], self.cache,
                                            last_id_only=False)
                lp = chunk_logprob(logits, targets)
            logprob_sum += float(lp)            # one scalar a chunk
            token_count += ids.shape[1] - 1
            if not silent:
                print(".", end="", flush=True)
        if not silent:
            print()
        return math.exp(-logprob_sum / max(token_count, 1))
