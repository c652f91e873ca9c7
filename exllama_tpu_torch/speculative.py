"""Speculative decoding: draft and verify over the model's API (port of
exllama_tpu/speculative.py).

Decode streams all the weights for one token; verifying k + 1 drafted
tokens in one forward streams them once for all, so each accepted draft is
a token almost for free.

Two proposers:

  * :class:`NgramProposer`: prompt-lookup decoding; the trailing n-gram of
    the sequence is matched against its own history and the tokens that
    followed last time are proposed. No second model.
  * :class:`DraftModelProposer`: a smaller ``ExLlama`` greedily drafts k
    tokens with its own cache, kept in step with the committed sequence by
    rewinding.

Verification accepts by exact match: at every drafted position a token is
sampled from the target's distribution (``ops.sampling.sample_operands``
with the generator's ``torch.Generator``, the settings a device operand as
the JAX ``_sample_grid`` traces them); the draft survives while it equals
that sample. Emitted tokens are always samples of the target, so drafting
changes the throughput, never the output distribution (greedy decoding
accepts while the draft equals the argmax).

The verify forward is ``model.forward(ids [1, k+1], cache,
last_id_only=False)``: on the card a CUDA graph per (k + 1, attend-length
bucket) replayed (models/llama.py), holding K1 on its tensor-core route,
K3's split-KV decode at T = k + 1 query rows over the cache, K6 at M = k +
1 and K4 at k + 1 rows; the draft model's one-token forwards replay its
own graphs the same way. It appends k + 1 cache rows; after a partial
acceptance the cursor rewinds to the committed length, and the stale rows
past it are dead (the causal mask ignores them and the next forward
overwrites them).
"""

from __future__ import annotations

import numpy as np
import torch

from exllama_tpu_torch.cache import ExLlamaCache
from exllama_tpu_torch.ops.sampling import (
    SamplerSettings,
    sample_operands,
    settings_operand,
)


class NgramProposer:
    """Prompt-lookup proposer: the longest trailing n-gram match in the
    history."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_draft: int = 8):
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_draft = max_draft

    def propose(self, seq: np.ndarray, k: int) -> np.ndarray:
        """seq: [T] committed tokens -> up to min(k, max_draft) draft
        tokens: what followed the most recent earlier occurrence of the
        longest trailing n-gram (one sliding-window comparison a length)."""
        k = min(k, self.max_draft)
        seq = np.asarray(seq)
        t = len(seq)
        for n in range(min(self.max_ngram, t - 1), self.min_ngram - 1, -1):
            tail = seq[t - n:]
            wins = np.lib.stride_tricks.sliding_window_view(seq[:-1], n)
            hits = np.nonzero((wins == tail).all(axis=1))[0]
            for start in hits[::-1]:
                follow = seq[start + n:start + n + k]
                if len(follow):
                    return np.asarray(follow, np.int32)
                break
        return np.zeros((0,), np.int32)

    # lifecycle hooks (no state)
    def begin(self, seq: np.ndarray) -> None: ...
    def commit(self, seq: np.ndarray) -> None: ...


class DraftModelProposer:
    """Small-model proposer: greedily drafts k tokens with its own cache."""

    def __init__(self, draft_model, max_draft: int = 8):
        self.model = draft_model
        self.cache = ExLlamaCache(draft_model)
        self.max_draft = max_draft

    def begin(self, seq: np.ndarray) -> None:
        self.cache.current_seq_len = 0
        if len(seq) > 1:
            self.model.forward(seq[None, :-1].astype(np.int32), self.cache,
                               preprocess_only=True)

    def commit(self, seq: np.ndarray) -> None:
        """Advance the draft cache over newly committed tokens (the drafted
        prefix is usually cached already; the rewind covers the rest)."""
        keep = min(self.cache.current_seq_len, len(seq) - 1)
        self.cache.current_seq_len = keep
        if len(seq) - 1 > keep:
            self.model.forward(seq[None, keep:-1].astype(np.int32),
                               self.cache, preprocess_only=True)

    def propose(self, seq: np.ndarray, k: int) -> np.ndarray:
        k = min(k, self.max_draft,
                self.model.config.max_seq_len - len(seq) - 1)
        out = []
        tok = np.asarray([[seq[-1]]], np.int32)
        for _ in range(max(k, 0)):
            logits = self.model.forward(tok, self.cache)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(
                torch.int32).cpu().numpy()[:, None]
            out.append(int(tok[0, 0]))
        # rewind the drafted rows; commit() re-syncs after acceptance
        self.cache.current_seq_len -= len(out)
        return np.asarray(out, np.int32)


class SpeculativeGenerator:
    """Single-stream generator with draft-and-verify decoding; ``stats``
    counts drafted and accepted tokens, verify forwards and tokens."""

    def __init__(self, model, tokenizer, cache, proposer, seed: int = 0):
        self.model = model
        self.tokenizer = tokenizer
        self.cache = cache
        self.proposer = proposer
        self.settings = SamplerSettings()
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        self.lookahead = 8
        self.stats = {"drafted": 0, "accepted": 0, "forwards": 0,
                      "tokens": 0}
        self._ops = settings_operand(self.settings, model.device)

    def _sample_positions(self, logits: torch.Tensor) -> np.ndarray:
        """One token a position from [T, V] target logits (the sampler,
        no repetition penalty), the settings copied into the device
        operand first."""
        settings_operand(self.settings, None, out=self._ops)
        return sample_operands(logits, self.generator, self._ops,
                               typical=self.settings.typical > 0
                               ).cpu().numpy()

    def generate_tokens(self, ids: np.ndarray, max_new_tokens: int,
                        stop_tokens=()) -> np.ndarray:
        """ids: [T] prompt -> the [T + new] sequence."""
        seq = np.asarray(ids, np.int32).reshape(-1)
        cfg = self.model.config
        self.cache.current_seq_len = 0
        if len(seq) > 1:
            self.model.forward(seq[None, :-1], self.cache,
                               preprocess_only=True)
        self.proposer.begin(seq)
        stop = set(int(t) for t in stop_tokens)

        produced = 0
        while produced < max_new_tokens and len(seq) < cfg.max_seq_len - 1:
            budget = min(self.lookahead, max_new_tokens - produced - 1,
                         cfg.max_seq_len - 1 - len(seq))
            draft = self.proposer.propose(seq, max(budget, 0))
            k = len(draft)
            ids_step = np.concatenate([seq[-1:], draft])[None, :]  # [1, k+1]
            logits = self.model.forward(ids_step, self.cache,
                                        last_id_only=False)
            self.stats["forwards"] += 1
            self.stats["drafted"] += k
            samples = self._sample_positions(logits[0])          # [k+1]

            accepted = 0
            new_tokens = []
            for i in range(k):
                if samples[i] != draft[i]:
                    break
                accepted += 1
                new_tokens.append(int(draft[i]))
                if int(draft[i]) in stop:
                    break
            if not (new_tokens and new_tokens[-1] in stop):
                # the bonus token when everything matched, else the
                # target's correction at the first mismatch
                new_tokens.append(int(samples[accepted]))
            self.stats["accepted"] += accepted

            seq = np.concatenate([seq, np.asarray(new_tokens, np.int32)])
            # rewind the k + 1 rows just written to the committed length
            self.cache.current_seq_len = len(seq) - 1
            produced += len(new_tokens)
            self.stats["tokens"] += len(new_tokens)
            self.proposer.commit(seq)
            if new_tokens[-1] in stop:
                break
        return seq

    def generate_simple(self, prompt: str, max_new_tokens: int = 128) -> str:
        ids = np.asarray(self.tokenizer.encode(prompt), np.int32).reshape(-1)
        eos = getattr(self.tokenizer, "eos_token_id", None)
        stop = (eos,) if eos is not None else ()
        seq = self.generate_tokens(ids, max_new_tokens, stop_tokens=stop)
        return self.tokenizer.decode(seq)

    @property
    def acceptance_rate(self) -> float:
        d = self.stats["drafted"]
        return self.stats["accepted"] / d if d else 0.0
