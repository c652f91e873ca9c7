"""Streaming single-sequence generator with stop conditions (port of
exllama_tpu/alt_generator.py).

A begin_stream / stream / generate API whose distinguishing feature is
*held text*: a partial match of a stop string is withheld from the stream,
so a stop string never leaks to the consumer, even across token boundaries
(``utils.streaming.split_on_stop_strings``). It keeps an LRU cache of
tokenized strings (``MAX_CACHED_STRINGS``) and cuts the prompt to
``max_seq_len - max_new_tokens`` tokens.

Each token is one ``ExLlama.forward`` of the last token (with the
settings' LoRA adapter, if any), then the generator's sampling step
(``generator._sample_step``: repetition penalty, BOS ban, the disallowed
tokens' bias, the sampler) drawing from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from exllama_tpu_torch.generator import _sample_step
from exllama_tpu_torch.ops.sampling import SamplerSettings
from exllama_tpu_torch.utils.streaming import split_on_stop_strings

MAX_CACHED_STRINGS = 100


class ExLlamaAltGenerator:

    @dataclasses.dataclass
    class Settings:
        temperature: float = 0.95
        top_k: int = 40
        top_p: float = 0.65
        min_p: float = 0.0
        typical: float = 0.0
        token_repetition_penalty_max: float = 1.15
        token_repetition_penalty_sustain: int = -1
        token_repetition_penalty_decay: int = 0
        disallowed_tokens: Optional[list[int]] = None
        lora = None             # a lora.ExLlamaLora, set as an attribute

    def __init__(self, model, tokenizer, cache, seed: int = 0):
        self.model = model
        self.tokenizer = tokenizer
        self.cache = cache
        self.settings = ExLlamaAltGenerator.Settings()
        self.tokenizer_cache: dict[str, np.ndarray] = {}
        self.sequence_ids: Optional[np.ndarray] = None
        self.sequence_str: str = ""
        self.stop_strings: list[str] = []
        self.stop_tokens: list[int] = []
        self.held_text: str = ""
        self.max_stop_tokens: int = 2
        self.remaining_tokens: int = 0
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        # (settings, disallowed-token bias, SamplerSettings) of the stream:
        # built once by begin_stream, anew where other settings are passed
        self._sampling = (None, None, None)
        # the token history of the repetition penalty; one column more than
        # the cache, as the generator's
        self._seq_buf = torch.zeros((1, self.cache.max_seq_len + 1),
                                    dtype=torch.int32, device=model.device)

    # -------------------------------------------------------- tokenization

    def cached_tokenize(self, text: str, encode_special_characters=False):
        if text in self.tokenizer_cache:
            return self.tokenizer_cache[text]
        while len(self.tokenizer_cache) >= MAX_CACHED_STRINGS:
            del self.tokenizer_cache[next(iter(self.tokenizer_cache))]
        enc = self.tokenizer.encode(
            text, encode_special_characters=encode_special_characters
        )
        self.tokenizer_cache[text] = enc
        return enc

    def get_num_tokens(self, text: str, encode_special_characters=False):
        return self.cached_tokenize(
            text, encode_special_characters=encode_special_characters
        ).shape[-1]

    # ------------------------------------------------------------- control

    def begin_stream(
        self,
        prompt: str,
        stop_conditions: list,
        max_new_tokens: int,
        gen_settings: Optional["ExLlamaAltGenerator.Settings"] = None,
        encode_special_characters=False,
    ):
        if not isinstance(prompt, str):
            raise TypeError("the alt generator takes one prompt string")
        gen_settings = gen_settings or self.settings

        max_input_tokens = self.model.config.max_seq_len - max_new_tokens
        self.remaining_tokens = max_new_tokens

        input_ids = self.cached_tokenize(prompt, encode_special_characters)
        applied = input_ids[:, -max_input_tokens:]
        self.sequence_str = (
            self.tokenizer.decode(applied[0])
            if applied.shape[1] < input_ids.shape[1]
            else prompt
        )

        self.stop_strings, self.stop_tokens = [], []
        for t in stop_conditions:
            if isinstance(t, int):
                self.stop_tokens.append(t)
            elif isinstance(t, str):
                self.stop_strings.append(t)
            else:
                raise ValueError("Unsupported type in stop_conditions")

        self.held_text = ""
        self.max_stop_tokens = 2
        for ss in self.stop_strings:
            self.max_stop_tokens = max(
                self.max_stop_tokens, self.get_num_tokens(ss) + 2
            )

        self.settings = gen_settings
        self._sampling = self._sampling_inputs(gen_settings)
        self.gen_begin_reuse(applied, gen_settings)

    def _flush_held(self) -> tuple[str, bool]:
        """End of stream: everything held is now safe to emit (the stop
        string it might have grown into can no longer complete)."""
        released, self.held_text = self.held_text, ""
        self.sequence_str += released
        return released, True

    def _decode_delta(self, window: int) -> str:
        """Text the newest token added, by re-decoding a bounded window:
        decoding a window (not the lone token) lets the tokenizer resolve
        merges and whitespace that depend on the preceding ids."""
        before = self.tokenizer.decode(self.sequence_ids[0, -(window + 1):-1])
        after = self.tokenizer.decode(self.sequence_ids[0, -(window + 1):])
        return after[len(before):]

    def stream(self) -> tuple[str, bool]:
        """Next chunk of text and the end-of-stream flag: the longest
        unambiguous prefix, holding back only the tail that could still
        grow into a stop string."""
        if self.remaining_tokens == 0:
            return self._flush_held()
        self.remaining_tokens -= 1

        token = int(self.gen_single_token(self.settings)[0, 0])
        if token in self.stop_tokens:
            return self._flush_held()

        delta = self._decode_delta(self.max_stop_tokens)
        safe, held, matched = split_on_stop_strings(
            self.held_text + delta, self.stop_strings
        )
        self.held_text = "" if matched else held
        self.sequence_str += safe
        return safe, matched

    def generate(
        self,
        prompt: str,
        stop_conditions: list,
        max_new_tokens: int,
        gen_settings: Optional["ExLlamaAltGenerator.Settings"] = None,
        encode_special_characters=False,
    ) -> str:
        self.begin_stream(prompt, stop_conditions, max_new_tokens,
                          gen_settings, encode_special_characters)
        response = ""
        while True:
            chunk, eos = self.stream()
            response += chunk
            if eos:
                return response

    # ----------------------------------------------------- cache plumbing

    def _sync_seq_buf(self):
        buf = np.zeros(tuple(self._seq_buf.shape), np.int32)
        if self.sequence_ids is not None and self.sequence_ids.shape[1] > 0:
            n = min(self.sequence_ids.shape[1], self.cache.max_seq_len)
            buf[:, :n] = self.sequence_ids[:, :n]
        self._seq_buf.copy_(torch.from_numpy(buf))

    def gen_begin(self, in_tokens, gen_settings):
        self.sequence_ids = np.asarray(in_tokens, np.int32).copy()
        self.cache.current_seq_len = 0
        self._sync_seq_buf()
        if self.sequence_ids.shape[1] > 1:
            self.model.forward(self.sequence_ids[:, :-1], self.cache,
                               preprocess_only=True, lora=gen_settings.lora)

    def gen_begin_reuse(self, in_tokens, gen_settings):
        in_tokens = np.asarray(in_tokens, np.int32)
        if self.sequence_ids is None or self.cache.current_seq_len == 0:
            self.gen_begin(in_tokens, gen_settings)
            return
        reuse = 0
        limit = min(self.sequence_ids.shape[1], in_tokens.shape[1])
        while (reuse < limit
               and self.sequence_ids[0, reuse] == in_tokens[0, reuse]):
            reuse += 1
        if reuse < 2:
            self.gen_begin(in_tokens, gen_settings)
            return
        self.cache.current_seq_len = reuse - 1
        self.sequence_ids = in_tokens[:, :reuse].copy()
        self._sync_seq_buf()
        if reuse < in_tokens.shape[1]:
            self.gen_feed_tokens(in_tokens[:, reuse:], gen_settings)

    def gen_feed_tokens(self, in_tokens, gen_settings):
        if self.sequence_ids is None:
            self.gen_begin(in_tokens, gen_settings)
            return
        start = self.cache.current_seq_len
        self.sequence_ids = np.concatenate(
            [self.sequence_ids, np.asarray(in_tokens, np.int32)], axis=1
        )
        self.model.forward(self.sequence_ids[:, start:-1], self.cache,
                           preprocess_only=True, lora=gen_settings.lora)
        self._sync_seq_buf()

    # ------------------------------------------------------------ sampling

    def _sampling_inputs(self, s):
        """(s, the [V] bias of its disallowed tokens or None, its
        SamplerSettings)."""
        bias = None
        if s.disallowed_tokens:
            b = np.zeros((self.model.config.vocab_size,), np.float32)
            b[np.asarray(s.disallowed_tokens)] = -np.inf
            bias = torch.from_numpy(b).to(self.model.device)
        # the sampler's and the penalty's fields, which share their names
        sampler = SamplerSettings(**{
            f.name: getattr(s, f.name)
            for f in dataclasses.fields(SamplerSettings) if hasattr(s, f.name)})
        return s, bias, sampler

    def gen_single_token(self, gen_settings) -> np.ndarray:
        """Forward the last token, sample, append. Returns np [1, 1]."""
        s = gen_settings
        logits = self.model.forward(self.sequence_ids[:, -1:], self.cache,
                                    lora=s.lora)
        if self._sampling[0] is not s:
            self._sampling = self._sampling_inputs(s)
        _, bias, sampler = self._sampling
        tokens = _sample_step(logits, self._seq_buf,
                              self.sequence_ids.shape[1], self.generator,
                              sampler, self.tokenizer.bos_token_id, bias)
        token = tokens.cpu().numpy().astype(np.int32).reshape(1, 1)
        self.sequence_ids = np.concatenate([self.sequence_ids, token], axis=1)
        return token
