"""Stateful generator (port of exllama_tpu/generator.py): prefill, sampling
loop, cache reuse and rewind.

Host-side bookkeeping mirrors the JAX package; the token history for the
repetition penalty lives in a [B, max_seq_len] device buffer, and each step
is forward -> repetition penalty -> BOS ban -> sampler -> history update.
Randomness is an explicit ``torch.Generator`` on the model's device. Beam
search, CFG and constraints belong to a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from exllama_tpu_torch.ops.sampling import (
    SamplerSettings,
    apply_rep_penalty,
    sample,
)


def _sample_step(
    logits: torch.Tensor,         # [B, 1, V] f32 model output
    seq_buf: torch.Tensor,        # [B, S_max] int32 token history, updated in place
    seq_len: int,                 # number of valid history positions
    generator: torch.Generator,
    settings: SamplerSettings,
    bos_token_id: int,
    logit_bias: Optional[torch.Tensor],   # [V] f32 additive, or None
) -> torch.Tensor:
    """Penalize, filter and sample one token per row; the tokens are written
    to ``seq_buf[:, seq_len]``. Returns int32 tokens [B]."""
    s = settings
    lg = logits[:, -1, :].to(torch.float32)
    lg = apply_rep_penalty(
        lg, seq_buf, seq_len, s.token_repetition_penalty_max,
        s.token_repetition_penalty_sustain, s.token_repetition_penalty_decay,
    )
    lg[:, bos_token_id] -= 10000.0          # ban BOS like the reference
    tokens, _ = sample(lg, generator, s, logit_bias=logit_bias)
    if seq_len < seq_buf.shape[1]:
        seq_buf[:, seq_len] = tokens
    return tokens


class ExLlamaGenerator:
    """API mirror of the JAX package's generator (greedy/sampled decoding)."""

    Settings = SamplerSettings

    def __init__(self, model, tokenizer, cache, seed: int = 0):
        self.model = model
        self.tokenizer = tokenizer
        self.cache = cache
        self.disallowed_tokens: Optional[list[int]] = None
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        self.reset()

    def reset(self):
        self.cache.current_seq_len = 0
        self.sequence: Optional[np.ndarray] = None          # [B, cur]
        self.sequence_actual: Optional[np.ndarray] = None
        self.settings = SamplerSettings()
        self._seq_buf = torch.zeros(
            (self.cache.batch_size, self.cache.max_seq_len),
            dtype=torch.int32, device=self.model.device,
        )
        self._mask = None

    # ------------------------------------------------------- cache plumbing

    def _sync_seq_buf(self):
        """Rewrite the device history buffer from the host sequence."""
        buf = np.zeros(
            (self.cache.batch_size, self.cache.max_seq_len), np.int32
        )
        if self.sequence is not None and self.sequence.shape[1] > 0:
            n = min(self.sequence.shape[1], self.cache.max_seq_len)
            buf[:, :n] = self.sequence[:, :n]
        self._seq_buf = torch.from_numpy(buf).to(self.model.device)

    def _as_mask(self, mask):
        return None if mask is None else torch.as_tensor(
            np.asarray(mask), dtype=torch.bool
        ).to(self.model.device)

    def gen_begin(self, in_tokens, mask=None):
        """Reset and prefill all but the last token."""
        in_tokens = np.asarray(in_tokens, dtype=np.int32)
        self.sequence = in_tokens.copy()
        self.sequence_actual = in_tokens.copy()
        self.cache.current_seq_len = 0
        self._mask = self._as_mask(mask)
        self._sync_seq_buf()
        if in_tokens.shape[1] > 1:
            self.model.forward(
                in_tokens[:, :-1], self.cache, preprocess_only=True,
                input_mask=self._mask,
            )

    def gen_begin_reuse(self, in_tokens, mask=None) -> int:
        """Longest-common-prefix KV reuse; returns the reused length."""
        in_tokens = np.asarray(in_tokens, dtype=np.int32)
        if self.sequence is None or self.cache.current_seq_len == 0:
            self.gen_begin(in_tokens, mask=mask)
            return 0

        reuse = 0
        limit = min(self.sequence.shape[1], in_tokens.shape[1])
        while reuse < limit and self.sequence[0, reuse] == in_tokens[0, reuse]:
            reuse += 1
        if reuse < 2:
            self.gen_begin(in_tokens, mask=mask)
            return 0

        self.cache.current_seq_len = reuse - 1
        self.sequence = self.sequence[:, :reuse]
        self.sequence_actual = self.sequence.copy()
        self._mask = self._as_mask(mask)
        self._sync_seq_buf()
        if reuse < in_tokens.shape[1]:
            self.gen_feed_tokens(in_tokens[:, reuse:], mask=mask)
        return reuse

    def gen_feed_tokens(self, in_tokens, mask=None):
        """Append + prefill, leaving the final token unforwarded."""
        if self.sequence is None:
            self.gen_begin(in_tokens, mask=mask)
            return
        in_tokens = np.asarray(in_tokens, dtype=np.int32)
        start = self.sequence.shape[1] - 1
        self.sequence = np.concatenate([self.sequence, in_tokens], axis=1)
        if mask is not None:
            self._mask = self._as_mask(mask)
        if start < self.sequence.shape[1] - 1:
            self.model.forward(
                self.sequence[:, start:-1], self.cache, preprocess_only=True,
                input_mask=self._mask,
            )
        self.sequence_actual = self.sequence
        self._sync_seq_buf()

    def gen_accept_token(self, token):
        token = np.asarray(token, dtype=np.int32).reshape(-1, 1)
        if self.sequence is None:
            self.sequence = token.copy()
        else:
            self.sequence = np.concatenate([self.sequence, token], axis=1)
        self.sequence_actual = self.sequence

    def gen_rewind(self, num_tokens: int):
        if num_tokens == 0:
            return
        self.sequence = self.sequence[:, :-num_tokens]
        self.cache.current_seq_len -= num_tokens
        self.sequence_actual = self.sequence
        self._sync_seq_buf()

    def disallow_tokens(self, tokens):
        self.disallowed_tokens = tokens

    # ------------------------------------------------------------- sampling

    def _logit_bias(self) -> Optional[torch.Tensor]:
        if not self.disallowed_tokens:
            return None
        bias = torch.zeros(self.model.config.vocab_size, dtype=torch.float32)
        bias[torch.as_tensor(self.disallowed_tokens)] = -torch.inf
        return bias.to(self.model.device)

    def gen_single_token(self, mask=None) -> np.ndarray:
        """Forward the last token -> penalty -> sample -> accept. Returns np
        [B, 1] tokens."""
        if self.sequence is None:
            token = np.array([[self.tokenizer.bos_token_id]], np.int32)
            self.gen_accept_token(token)
            return token
        logits = self.model.forward(
            self.sequence[:, -1:], self.cache,
            input_mask=self._mask if mask is None else self._as_mask(mask),
        )
        tokens = _sample_step(
            logits, self._seq_buf, self.sequence.shape[1], self.generator,
            self.settings, self.tokenizer.bos_token_id, self._logit_bias(),
        )
        token = tokens.cpu().numpy().reshape(-1, 1)
        self.gen_accept_token(token)
        return token

    def gen_tokens(self, n: int) -> np.ndarray:
        """n steps of forward -> penalty -> sample, fetching the tokens to
        the host once at the end. Returns np [B, n]; sequence and cache
        advance by n."""
        assert self.sequence is not None and self.sequence.shape[1] > 0
        past = self.cache.current_seq_len
        assert past + n <= self.model.config.max_seq_len, (past, n)
        tok = torch.from_numpy(self.sequence[:, -1:].copy()).to(
            self.model.device)
        seq_len = self.sequence.shape[1]
        bias = self._logit_bias()
        out = []
        for i in range(n):
            logits = self.model.forward(tok, self.cache, input_mask=self._mask)
            tokens = _sample_step(
                logits, self._seq_buf, seq_len + i, self.generator,
                self.settings, self.tokenizer.bos_token_id, bias,
            )
            out.append(tokens)
            tok = tokens[:, None]
        toks = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)  # [B, n]
        self.sequence = np.concatenate([self.sequence, toks], axis=1)
        self.sequence_actual = self.sequence
        return toks

    def generate_simple(self, prompt, max_new_tokens: int = 128,
                        loop_chunk: int = 16):
        """Encode -> prefill -> sample loop with per-row EOS tracking ->
        decode. Samples ``loop_chunk`` tokens per host sync (gen_tokens);
        EOS is checked between chunks and overshoot past the all-rows-EOS
        point is rewound, so the result matches a per-token loop."""
        ids, mask = self.tokenizer.encode(
            prompt, return_mask=True,
            max_seq_len=self.model.config.max_seq_len,
        )
        # pad the mask out to max_seq_len for the attention input_mask
        full_mask = np.zeros(
            (ids.shape[0], self.model.config.max_seq_len), bool
        )
        full_mask[:, : ids.shape[1]] = mask
        self.gen_begin(ids, mask=full_mask if not mask.all() else None)

        max_new_tokens = min(
            max_new_tokens, self.model.config.max_seq_len - ids.shape[1]
        )
        eos = np.zeros((ids.shape[0],), bool)
        eos_id = self.tokenizer.eos_token_id
        done = 0
        while done < max_new_tokens:
            k = min(max(loop_chunk, 1), max_new_tokens - done)
            toks = self.gen_tokens(k)             # [B, k]
            done += k
            # earliest chunk position after which every row has seen EOS
            seen = eos[:, None] | np.cumsum(toks == eos_id, axis=1).astype(bool)
            allpos = np.nonzero(seen.all(axis=0))[0]
            if allpos.size:
                self.gen_rewind(k - (int(allpos[0]) + 1))
                break
            eos = seen[:, -1]
        return self.tokenizer.decode(
            self.sequence[0] if self.sequence.shape[0] == 1 else self.sequence
        )
