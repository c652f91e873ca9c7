"""Stateful generator (port of exllama_tpu/generator.py): prefill, the
decode loop, sampling, constraints, classifier-free guidance, beam search,
cache reuse, rewind and pruning.

Host-side bookkeeping mirrors the JAX package. The token history for the
repetition penalty lives in a device buffer (``_seq_buf``, [B, max_seq_len
+ 1]: one column more than the cache holds, so that the token of a step at
the last cache position has a place), and each step is forward ->
repetition penalty -> BOS ban -> sampler -> history update. Randomness is
an explicit ``torch.Generator`` on the model's device.

``gen_tokens`` runs its n steps through :class:`DecodeLoop`, the
counterpart of the JAX ``_decode_loop_n``: on the card one captured CUDA
graph per attend-length bucket, replayed step after step with no host read
between steps; on the CPU the same step function, eagerly. A capture that
fails raises: there is no fallback to an eager loop on the card. The graphs
are dropped on ``reset()``, on ``gen_begin`` and when the settings, the
disallowed tokens or the adapter change. Beam search runs the beams as the
batch of a second cache (``ExLlamaCache.take_rows`` / ``keep_rows``),
eagerly. ``generator.lora`` (a ``lora.ExLlamaLora``, or None) reaches
every forward: prefill, feed, single tokens, the decode loop, CFG and the
beams.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from exllama_tpu_torch import kernels
from exllama_tpu_torch.cache import ExLlamaCache
from exllama_tpu_torch.models.llama import forward_chunk
from exllama_tpu_torch.ops.sampling import (
    SamplerSettings,
    apply_rep_penalty,
    filter_probs,
    sample,
)


def _put_column(buf: torch.Tensor, pos, values: torch.Tensor):
    """values [B] into buf[:, pos] in place. ``pos`` is an int (a column
    outside the buffer is skipped) or a [1] int tensor read on the device
    (a column outside is left as it was, with no host read)."""
    if isinstance(pos, int):
        if pos < buf.shape[1]:
            buf[:, pos] = values
        return
    col = pos.to(torch.long).reshape(1, 1).expand(buf.shape[0], 1)
    inside = col < buf.shape[1]
    col = torch.where(inside, col, 0)
    new = values.to(buf.dtype)[:, None]
    buf.scatter_(1, col, torch.where(inside, new, buf.gather(1, col)))


def _sample_step(
    logits: torch.Tensor,         # [B, 1, V] f32 model output
    seq_buf: torch.Tensor,        # [B, S] int32 token history, updated in place
    seq_len,                      # valid history positions: int or [1] tensor
    generator: torch.Generator,
    settings: SamplerSettings,
    bos_token_id: int,
    logit_bias: Optional[torch.Tensor],   # [V] f32 additive, or None
) -> torch.Tensor:
    """Penalize, filter and sample one token per row; the tokens are written
    to ``seq_buf[:, seq_len]``. Returns int32 tokens [B]. No host read, so
    a graph can capture it."""
    s = settings
    lg = logits[:, -1, :].to(torch.float32)
    lg = apply_rep_penalty(
        lg, seq_buf, seq_len, s.token_repetition_penalty_max,
        s.token_repetition_penalty_sustain, s.token_repetition_penalty_decay,
    )
    lg[:, bos_token_id] -= 10000.0          # ban BOS like the reference
    tokens, _ = sample(lg, generator, s, logit_bias=logit_bias)
    _put_column(seq_buf, seq_len, tokens)
    return tokens


class DecodeLoop:
    """n decode steps on static buffers, the counterpart of the JAX
    ``_decode_loop_n`` (exllama_tpu/generator.py:70-125) and of the root
    ``bench.py``'s jitted greedy loop.

    One step: ``forward_chunk`` at T = 1 on the cache's device cursor ->
    with a sampler, repetition penalty -> BOS ban -> logit bias -> sample
    (``head_mode="logits"``), or the greedy head's ids (``"argmax"``) -> the
    token written into the history at the device position -> fed back ->
    cursor and position + 1, all on the device. The static buffers: the
    token [B, 1], the cache's ``cursor``, the history position [1], the
    history (the caller's [B, >= S_max + 1] int32), the input mask and the
    [V] logit bias (copied in on every run where given); a LoRA adapter's
    tensors are read where they lie (a graph holds them).

    On the card each step runs one ``torch.cuda.CUDAGraph`` per key: the
    attend-length bucket (``ExLlama._attend_len(past + 1)``, or the fixed
    ``attend_len``), under one epoch of the rest -- batch, head mode, the
    sampler settings, the mask's shape, whether a bias is set, the forward
    knobs, the parameters and the adapter. A new epoch drops every graph.
    The first step of a new bucket runs eagerly on the capture stream -- it
    builds the kernels' libraries and sizes their scratch -- and is then
    captured; all graphs share one memory pool (they keep nothing
    allocated there between replays, so they may replay in any order).
    Capture records the launch counts of the step; each replay adds them to
    the counters (``kernels.add_launches``). A capture that fails raises. With
    ``capture=False``, on the CPU, or on a mesh of more than one rank the
    same step runs eagerly: a gloo collective cannot be captured in a CUDA
    graph, and the capture of an NCCL one is not checked yet (the kernels
    still run on the card).
    """

    def __init__(self, model, cache: ExLlamaCache, hist: torch.Tensor, *,
                 head_mode: str = "logits",
                 generator: Optional[torch.Generator] = None,
                 attend_len: Optional[int] = None, **knobs):
        if head_mode not in ("logits", "argmax"):
            raise ValueError(f"head_mode {head_mode!r}")
        if (hist.shape[0] != cache.batch_size
                or hist.shape[1] <= cache.max_seq_len):
            raise ValueError("DecodeLoop: history must be [B, > max_seq_len]")
        self.model, self.cache, self.hist = model, cache, hist
        self.head_mode, self.generator = head_mode, generator
        self.attend_len, self.knobs = attend_len, knobs
        self.capture = True
        dev = cache.cursor.device
        self.tok = torch.zeros((cache.batch_size, 1), dtype=torch.int32,
                               device=dev)
        self.pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.mask: Optional[torch.Tensor] = None
        self.bias: Optional[torch.Tensor] = None
        self.lora: Optional[list] = None
        self.graphs: dict = {}
        self._epoch = None
        self._stream = self._pool = None

    def reset(self):
        """Drop every graph (and with them their pool)."""
        self.graphs = {}
        self._epoch = None
        self._pool = None

    def _forward_kwargs(self) -> dict:
        cfg = self.model.config
        t = cfg.tuning
        kw = dict(mlp_fuse=t.fuse_mlp, attn_fuse=t.fuse_attn,
                  qkv_fuse=t.fuse_qkv, commit_impl=t.commit_impl,
                  matmul_impl=t.matmul_impl, attn_impl=t.attn_impl)
        kw.update(self.knobs)
        return kw

    def _step(self, attend_len: int, sampler, kw: dict):
        """One decode step on the static buffers."""
        cfg = self.model.config
        out = forward_chunk(
            self.model.params, self.cache, self.tok, self.cache.cursor,
            self.mask, attend_len=attend_len, last_token_only=True,
            preprocess_only=False, heads=cfg.num_attention_heads,
            kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
            eps=cfg.rms_norm_eps, head_mode=self.head_mode, lora=self.lora,
            **kw)
        if sampler is None:
            tokens = out.reshape(-1)                  # the greedy head's ids
            _put_column(self.hist, self.pos, tokens)
        else:
            settings, bos = sampler
            tokens = _sample_step(out, self.hist, self.pos, self.generator,
                                  settings, bos, self.bias)
        self.tok.copy_(tokens.reshape(-1, 1))
        self.cache.cursor.add_(1)
        self.pos.add_(1)

    @staticmethod
    def _static(buf, value):
        """Copy ``value`` into the static ``buf`` (a new one where the shape
        or type differs); None stays None."""
        if value is None:
            return None
        if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
            buf = torch.empty_like(value)
        return buf.copy_(value)

    def run(self, n: int, tok, past: int, hist_len: int, sampler=None,
            mask: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None,
            lora: Optional[list] = None) -> torch.Tensor:
        """n steps from token ``tok`` [B, 1] at cache position ``past``,
        the history holding ``hist_len`` tokens; ``sampler`` = (settings,
        BOS id), or None for the greedy head; ``lora`` an adapter's
        ``ExLlamaLora.stacked`` or None. Returns the n tokens [B, n] as a
        view of the history, on the device (no host read). The caller sets
        ``cache.current_seq_len``."""
        s_max = self.cache.max_seq_len
        if not (0 <= past and past + n <= s_max
                and hist_len + n <= self.hist.shape[1]):
            raise ValueError(f"DecodeLoop: {n} steps from position {past} "
                             f"do not fit the cache ({s_max})")
        if (sampler is None) != (self.head_mode == "argmax") or (
                sampler is not None and self.generator is None):
            raise ValueError("DecodeLoop: head_mode 'logits' takes a sampler "
                             "and a generator, 'argmax' neither")
        self.tok.copy_(torch.as_tensor(tok, dtype=torch.int32).reshape(-1, 1))
        self.cache.cursor.fill_(past)
        self.pos.fill_(hist_len)
        self.mask = self._static(self.mask, mask)
        self.bias = self._static(self.bias, bias)
        self.lora = lora
        kw = self._forward_kwargs()
        dev = self.cache.k[0].device
        mesh = getattr(self.model, "mesh", None)
        graphs = (self.capture and dev.type == "cuda"
                  and (mesh is None or mesh.tp * mesh.dp == 1))
        epoch = (self.cache.batch_size, self.head_mode,
                 None if sampler is None else
                 (dataclasses.astuple(sampler[0]), sampler[1]),
                 None if mask is None else tuple(mask.shape),
                 bias is not None, tuple(sorted(kw.items())),
                 id(self.model.params), None if lora is None else id(lora))
        if epoch != self._epoch:
            self.reset()
            self._epoch = epoch
        for i in range(n):
            attend_len = (self.attend_len
                          or self.model._attend_len(past + i + 1))
            if not graphs:
                self._step(attend_len, sampler, kw)
                continue
            entry = self.graphs.get(attend_len)
            if entry is None:
                self.graphs[attend_len] = self._capture(attend_len, sampler, kw)
            else:
                entry[0].replay()
                kernels.add_launches(entry[1])
        return self.hist[:, hist_len:hist_len + n]

    def _capture(self, attend_len: int, sampler, kw: dict):
        """Run this step eagerly on the capture stream, then capture it.
        Returns (graph, its launch counts, what it must keep alive)."""
        dev = self.cache.k[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, counts = capture_step(
            lambda: self._step(attend_len, sampler, kw), dev, self._stream,
            self._pool, None if sampler is None else self.generator)
        keep = (kernels.scratch_in_use(dev), self.model.params, self.mask,
                self.bias, self.lora)
        return graph, counts, keep


def capture_step(step, dev, stream, pool, generator=None):
    """Run ``step()`` eagerly on ``stream`` (it builds the kernels'
    libraries and sizes their scratch), then capture it into a new
    ``torch.cuda.CUDAGraph`` in ``pool``, with ``generator``'s state
    registered where the step draws from it. Returns (graph, the launch
    counts of one step): the capture records them and takes them back off
    the counters, since a capture launches nothing."""
    cur = torch.cuda.current_stream(dev)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        step()
    cur.wait_stream(stream)
    # the eager step done before the capture starts: without this sync
    # a sampled step's replays drew other tokens than the eager step
    # (tests/test_torch_kernels.py, a sampled case after a greedy one)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = kernels.launch_counts()
    # capture_begin / _end rather than the torch.cuda.graph context,
    # which also empties the allocator's cache at every capture: the
    # next prefill would cudaMalloc its buffers again
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            step()
        finally:
            graph.capture_end()
    after = kernels.launch_counts()
    counts = {k: after[k] - before[k] for k in after
              if after[k] != before[k]}
    kernels.add_launches(counts, -1)      # capture launched nothing
    return graph, counts


class ExLlamaGenerator:
    """API mirror of the JAX package's generator."""

    Settings = SamplerSettings

    def __init__(self, model, tokenizer, cache, seed: int = 0):
        self.model = model
        self.tokenizer = tokenizer
        self.cache = cache
        self.lora = None
        self.disallowed_tokens: Optional[list[int]] = None
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        self.in_beam_search = False
        self.beams = None
        self.reset()

    def reset(self):
        self.cache.current_seq_len = 0
        self.sequence: Optional[np.ndarray] = None          # [B, cur]
        self.sequence_actual: Optional[np.ndarray] = None
        self.settings = SamplerSettings()
        self._seq_buf = torch.zeros(
            (self.cache.batch_size, self.cache.max_seq_len + 1),
            dtype=torch.int32, device=self.model.device,
        )
        self._loop = DecodeLoop(self.model, self.cache, self._seq_buf,
                                generator=self.generator)
        self._mask = None
        self._beam_cache: Optional[ExLlamaCache] = None
        self._beam_seqs: Optional[np.ndarray] = None
        self._beam_lps: Optional[np.ndarray] = None
        self._beam_prefix = 0

    # ------------------------------------------------------- cache plumbing

    def _sync_seq_buf(self):
        """Rewrite the device history buffer from the host sequence, in
        place (the decode graphs hold its address)."""
        buf = np.zeros(tuple(self._seq_buf.shape), np.int32)
        if self.sequence is not None and self.sequence.shape[1] > 0:
            n = min(self.sequence.shape[1], self.cache.max_seq_len)
            buf[:, :n] = self.sequence[:, :n]
        self._seq_buf.copy_(torch.from_numpy(buf))

    def _as_mask(self, mask):
        return None if mask is None else torch.as_tensor(
            np.asarray(mask), dtype=torch.bool
        ).to(self.model.device)

    def gen_begin(self, in_tokens, mask=None):
        """Reset and prefill all but the last token."""
        self.end_beam_search()
        self._loop.reset()
        in_tokens = np.asarray(in_tokens, dtype=np.int32)
        self.sequence = in_tokens.copy()
        self.sequence_actual = in_tokens.copy()
        self.cache.current_seq_len = 0
        self._mask = self._as_mask(mask)
        self._sync_seq_buf()
        if in_tokens.shape[1] > 1:
            self.model.forward(
                in_tokens[:, :-1], self.cache, preprocess_only=True,
                input_mask=self._mask, lora=self.lora,
            )

    def gen_begin_empty(self):
        self.end_beam_search()
        self.sequence = None
        self.sequence_actual = None
        self.cache.current_seq_len = 0

    def gen_begin_reuse(self, in_tokens, mask=None) -> int:
        """Longest-common-prefix KV reuse; returns the reused length."""
        self.end_beam_search()
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
        self.end_beam_search()
        in_tokens = np.asarray(in_tokens, dtype=np.int32)
        start = self.sequence.shape[1] - 1
        self.sequence = np.concatenate([self.sequence, in_tokens], axis=1)
        if mask is not None:
            self._mask = self._as_mask(mask)
        if start < self.sequence.shape[1] - 1:
            self.model.forward(
                self.sequence[:, start:-1], self.cache, preprocess_only=True,
                input_mask=self._mask, lora=self.lora,
            )
        self.sequence_actual = self.sequence
        self._sync_seq_buf()

    def gen_accept_token(self, token):
        self.end_beam_search()
        token = np.asarray(token, dtype=np.int32).reshape(-1, 1)
        if self.sequence is None:
            self.sequence = token.copy()
        else:
            self.sequence = np.concatenate([self.sequence, token], axis=1)
        self.sequence_actual = self.sequence

    def gen_rewind(self, num_tokens: int):
        if num_tokens == 0:
            return
        self.end_beam_search()
        self.sequence = self.sequence[:, :-num_tokens]
        self.cache.current_seq_len -= num_tokens
        self.sequence_actual = self.sequence
        self._sync_seq_buf()

    def gen_prune_right(self, tokens: int, mask=None):
        self.end_beam_search()
        if tokens > self.sequence.shape[1] - 1:
            return
        self.gen_begin(self.sequence[:, tokens:], mask=mask)
        self.sequence_actual = self.sequence

    def gen_prune_left(self, num_tokens: int, mask=None):
        num_tokens = min(num_tokens, self.sequence_actual.shape[1] - 1)
        self.end_beam_search()
        self.sequence = self.sequence[:, num_tokens:]
        self.gen_begin(self.sequence, mask=mask)

    def gen_prune_to(self, min_tokens_to_keep: int, token_id: int, mask=None):
        """Drop leading history up to occurrences of ``token_id`` until under
        budget."""
        self.end_beam_search()
        if self.gen_num_tokens() <= min_tokens_to_keep:
            return
        while self.gen_num_tokens() > min_tokens_to_keep:
            pruned = False
            for i in range(self.sequence.shape[1] - 1):
                if self.sequence[0, i] == token_id:
                    self.sequence = self.sequence[:, i + 1:]
                    pruned = True
                    break
            if not pruned:
                break
        self.gen_begin(self.sequence, mask=mask)

    def gen_num_tokens(self) -> int:
        return self.sequence_actual.shape[1]

    def disallow_tokens(self, tokens):
        self.disallowed_tokens = tokens
        self._loop.reset()

    # ------------------------------------------------------------- sampling

    def _logit_bias(self, constraints=None) -> Optional[torch.Tensor]:
        """[V] f32 additive bias: -inf on the disallowed tokens; with
        ``constraints``, -10000 on every token and +10000 back on the
        allowed ones (exllama_tpu/generator.py:401-410). None where there
        is neither (the JAX package adds zeros)."""
        if not self.disallowed_tokens and constraints is None:
            return None
        bias = np.zeros((self.model.config.vocab_size,), np.float32)
        if self.disallowed_tokens:
            bias[np.asarray(self.disallowed_tokens)] = -np.inf
        if constraints is not None:
            bias -= 10000.0
            bias[np.asarray(constraints)] += 10000.0
        return torch.from_numpy(bias).to(self.model.device)

    def gen_single_token(self, constraints=None, mask=None) -> np.ndarray:
        """Forward the last token -> penalty -> sample -> accept. Returns np
        [B, 1] tokens. With ``constraints`` (allowed token ids) the bias
        forces the token into that set and min_p rises by 0.01; with an
        empty sequence the token is ``constraints[0]`` (or BOS)."""
        self.end_beam_search()
        if self.sequence is None:
            first = (self.tokenizer.bos_token_id if constraints is None
                     else int(constraints[0]))
            token = np.array([[first]], np.int32)
            self.gen_accept_token(token)
            return token
        logits = self.model.forward(
            self.sequence[:, -1:], self.cache,
            input_mask=self._mask if mask is None else self._as_mask(mask),
            lora=self.lora,
        )
        s = self.settings
        if constraints is not None:
            s = dataclasses.replace(s, min_p=s.min_p + 0.01)
        tokens = _sample_step(
            logits, self._seq_buf, self.sequence.shape[1], self.generator,
            s, self.tokenizer.bos_token_id, self._logit_bias(constraints),
        )
        token = tokens.cpu().numpy().reshape(-1, 1)
        self.gen_accept_token(token)
        return token

    def gen_tokens(self, n: int) -> np.ndarray:
        """n steps of forward -> penalty -> sample through :class:`DecodeLoop`
        (graphs on the card), fetching the tokens to the host once at the
        end. Returns np [B, n]; sequence and cache advance by n.

        Deviation from the JAX package: every step passes the left-pad
        ``input_mask`` of a masked batch (``gen_begin(..., mask=)``), so the
        n steps equal n ``gen_single_token()`` calls, as the JAX docstring
        says of its ``gen_tokens``; the JAX ``_decode_loop_n`` runs without
        the mask, so after a masked ``gen_begin`` its padded rows attend to
        their padding."""
        self.end_beam_search()
        assert self.sequence is not None and self.sequence.shape[1] > 0
        past = self.cache.current_seq_len
        assert past + n <= self.model.config.max_seq_len, (past, n)
        out = self._loop.run(
            n, torch.from_numpy(self.sequence[:, -1:].copy()), past,
            self.sequence.shape[1],
            sampler=(self.settings, self.tokenizer.bos_token_id),
            mask=self._mask, bias=self._logit_bias(),
            lora=None if self.lora is None else self.lora.stacked,
        )
        toks = out.cpu().numpy().astype(np.int32)                # [B, n]
        self.cache.current_seq_len = past + n
        self.sequence = np.concatenate([self.sequence, toks], axis=1)
        self.sequence_actual = self.sequence
        return toks

    def generate_simple(self, prompt, max_new_tokens: int = 128,
                        loop_chunk: int = 16):
        """Encode -> prefill -> sample loop with per-row EOS tracking ->
        decode. Samples ``loop_chunk`` tokens per host sync (gen_tokens);
        EOS is checked between chunks and overshoot past the all-rows-EOS
        point is rewound, so the result matches a per-token loop."""
        self.end_beam_search()
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

    # --------------------------------------------- classifier-free guidance

    def sample_current(self, logits_row, num=1):
        """Sample from an externally mixed logits row [V] with the current
        settings (the reference's ``sample_current``, used by CFG). Returns
        (np [1, 1] token, np probability)."""
        s = self.settings
        row = torch.as_tensor(logits_row, dtype=torch.float32).to(
            self.model.device)
        sp = filter_probs(row[None], s.temperature, s.top_k, s.top_p,
                          s.min_p, s.typical)[0]
        choice = torch.multinomial(sp[None], 1, generator=self.generator)[0, 0]
        return (choice.cpu().numpy().reshape(1, 1).astype(np.int32),
                sp[choice].cpu().numpy())

    def generate_cfg(self, prompts: list, alpha: float,
                     max_new_tokens: int) -> str:
        """Classifier-free guidance decoding (exllama_tpu/generator.py:
        574-613): a batch of (conditional, unconditional) prompts; per step
        the two rows' log-softmaxes mix as (1 - alpha) * cond + alpha *
        uncond, and the sampled token is broadcast to both rows."""
        assert len(prompts) == 2, "CFG needs (positive, negative) prompts"
        ids, mask = self.tokenizer.encode(
            prompts, return_mask=True,
            max_seq_len=self.model.config.max_seq_len,
        )
        full_mask = np.zeros((2, self.model.config.max_seq_len), bool)
        full_mask[:, : ids.shape[1]] = mask
        self.gen_begin(ids, mask=full_mask)

        s = self.settings
        for _ in range(max_new_tokens):
            logits = self.model.forward(
                self.sequence[:, -1:], self.cache, input_mask=self._mask,
                lora=self.lora,
            )
            lg = apply_rep_penalty(
                logits[:, -1, :].to(torch.float32), self._seq_buf,
                self.sequence.shape[1], s.token_repetition_penalty_max,
                s.token_repetition_penalty_sustain,
                s.token_repetition_penalty_decay,
            )
            lp = torch.log_softmax(lg, dim=-1)
            mixed = (1.0 - alpha) * lp[0] + alpha * lp[1]
            token, _ = self.sample_current(mixed)
            if int(token[0, 0]) == self.tokenizer.eos_token_id:
                break
            self.gen_accept_token(np.repeat(token, 2, axis=0))
            self._sync_seq_buf()
        return self.tokenizer.decode(self.sequence[0])

    # ----------------------------------------------------------- beam search
    #
    # The JAX package's redesign of the reference's beam search
    # (exllama_tpu/generator.py:615-858): the beams are the batch of a
    # second cache, one batched forward a lookahead step evaluates every
    # beam, and reordering the beams is a gather of that cache's rows.
    # Initial beams are a draw without replacement from the filtered
    # distribution (Gumbel top-k); each expansion is the top-(beams) over
    # the union of the beams' filtered candidates by cumulative log-prob;
    # each beam_search() call commits the first token of the best beam,
    # prunes the beams that do not share it and slides the window.

    def begin_beam_search(self):
        self.beams = None
        if self.settings.beams == 1 and self.settings.beam_length == 1:
            return
        mesh = getattr(self.model, "mesh", None)
        if mesh is not None and mesh.tp > 1:
            # exllama_tpu/generator.py:635-641
            raise NotImplementedError(
                "beam search over a tensor-parallel mesh is not supported "
                "(per-beam cache gathers assume local KV)")
        self.in_beam_search = True

    def _beam_bias(self) -> torch.Tensor:
        """[V] additive bias for beam scoring: the BOS ban and the
        disallowed tokens, cached per disallowed set (one upload a change,
        not one a lookahead step)."""
        key = tuple(self.disallowed_tokens or ())
        cached = getattr(self, "_beam_bias_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        bias = np.zeros((self.model.config.vocab_size,), np.float32)
        bias[self.tokenizer.bos_token_id] -= 10000.0
        if self.disallowed_tokens:
            bias[np.asarray(self.disallowed_tokens)] = -np.inf
        dev = torch.from_numpy(bias).to(self.model.device)
        self._beam_bias_cache = (key, dev)
        return dev

    def _beam_hist(self, n_rows):
        """Per-beam token history (committed + lookahead) for the repetition
        penalty: [n, S_max] int32 on the device, and its length."""
        hist = np.zeros((n_rows, self.cache.max_seq_len), np.int32)
        base = self.sequence[0]
        for i in range(n_rows):
            row = base
            if self._beam_seqs is not None:
                row = np.concatenate([base, self._beam_seqs[i]])
            m = min(len(row), self.cache.max_seq_len)
            hist[i, :m] = row[:m]
        hist_len = min(
            len(base)
            + (0 if self._beam_seqs is None else self._beam_seqs.shape[1]),
            self.cache.max_seq_len,
        )
        return torch.from_numpy(hist).to(self.model.device), hist_len

    def _beam_filter(self, logits, hist, hist_len):
        """Bias, penalty over each beam's own history, sampler filter:
        normalized probs [n, V] (exllama_tpu/generator.py:148-150,
        209-211)."""
        s = self.settings
        lg = logits[:, -1, :].to(torch.float32) + self._beam_bias()[None, :]
        lg = apply_rep_penalty(
            lg, hist, hist_len, s.token_repetition_penalty_max,
            s.token_repetition_penalty_sustain,
            s.token_repetition_penalty_decay)
        return filter_probs(lg, s.temperature, s.top_k, s.top_p, s.min_p,
                            s.typical)

    def _beam_init_filter(self, logits, n_out: int):
        """Initial expansion: the filtered distribution, then ``n_out``
        tokens without replacement by Gumbel top-k from the generator's
        uniform draws. Returns (tokens, log-probs, valid), on the host."""
        hist, hist_len = self._beam_hist(1)
        probs = self._beam_filter(logits, hist, hist_len)[0]
        u = torch.rand(probs.shape, generator=self.generator,
                       device=probs.device)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        scores = torch.where(probs > 0, torch.log(probs + 1e-30) + g,
                             -torch.inf)
        toks = torch.topk(scores, n_out).indices
        p = probs[toks]
        packed = torch.stack([toks.to(torch.float32),
                              torch.log(p + 1e-30), (p > 0).float()])
        toks, lps, valid = packed.cpu().numpy()
        return toks.astype(np.int32), lps, valid > 0

    def _beam_step(self, n_out: int):
        """One lookahead step: a batched forward of every beam over the beam
        cache at its int cursor, the penalty over each beam's history, the
        filter, a joint top-k over [n * V] by cumulative log-prob, and the
        beam cache's rows gathered by parent. The host fetches 3 * n_out
        numbers (parents, tokens, scores), not [n, V] probabilities."""
        cfg, t = self.model.config, self.model.config.tuning
        n = self._beam_seqs.shape[0]
        past = self._beam_cache.current_seq_len
        hist, hist_len = self._beam_hist(n)
        toks = torch.from_numpy(self._beam_seqs[:, -1:].copy()).to(
            self.model.device)
        logits = forward_chunk(
            self.model.params, self._beam_cache, toks, past, None,
            attend_len=self.model._attend_len(past + 1),
            last_token_only=True, preprocess_only=False,
            heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.head_dim, eps=cfg.rms_norm_eps,
            mlp_fuse=t.fuse_mlp, attn_fuse=t.fuse_attn, qkv_fuse=t.fuse_qkv,
            commit_impl=t.commit_impl, matmul_impl=t.matmul_impl,
            attn_impl=t.attn_impl,
            lora=None if self.lora is None else self.lora.stacked,
        )
        self._beam_cache.current_seq_len = past + 1
        probs = self._beam_filter(logits, hist, hist_len)
        v = probs.shape[1]
        lps = torch.from_numpy(self._beam_lps.astype(np.float32)).to(
            probs.device)
        cand = torch.where(probs > 0, lps[:, None] + torch.log(probs + 1e-30),
                           -torch.inf)
        scores, top = torch.topk(cand.reshape(-1), n_out)
        parents = top // v
        self._beam_cache.take_rows(parents)
        packed = torch.stack([parents.to(torch.float32),
                              (top % v).to(torch.float32), scores])
        parents, tokens, scores = packed.cpu().numpy()
        return parents.astype(np.int64), tokens.astype(np.int32), scores

    def beam_search(self):
        s = self.settings
        if s.beams == 1 and s.beam_length == 1:
            return self.gen_single_token()
        if self.sequence is None:
            return self.gen_single_token()
        assert self.in_beam_search

        n_beams = s.beams
        max_lookahead = min(
            self.model.config.max_seq_len - s.beam_length, s.beam_length
        )

        while self.beams is None or self._beam_seqs.shape[1] < max_lookahead:
            if self.beams is None:
                # re-expansion: the main cache may be stale if previous
                # commits consumed a full lookahead window
                self._sync_main_cache_from_beams()

                # initial expansion off the main cache
                logits = self.model.forward(
                    self.sequence[:, -1:], self.cache, input_mask=self._mask,
                    lora=self.lora,
                )
                self._beam_prefix = self.sequence.shape[1]
                self._beam_seqs = None
                toks, lps, valid = self._beam_init_filter(logits, n_beams)
                k = max(1, int(valid.sum()))
                self._beam_seqs = toks[:k, None]
                self._beam_lps = lps[:k]

                # beam cache: the main cache's prefix broadcast to k rows
                if (self._beam_cache is None
                        or self._beam_cache.batch_size != k):
                    self._beam_cache = ExLlamaCache(
                        self.model, batch_size=k,
                        max_seq_len=self.cache.max_seq_len)
                pref = self.cache.current_seq_len
                self.cache.copy_states(
                    self._beam_cache, 0, pref, 0, pref,
                    from_row=0, from_rows=1, to_row=0, to_rows=k,
                )
                self._beam_cache.current_seq_len = pref
                self.beams = True           # sentinel: beams active
            else:
                parents, tokens, scores = self._beam_step(n_beams)
                k = min(n_beams, max(1, int(np.isfinite(scores).sum())))
                if k < n_beams:
                    parents, tokens, scores = (
                        parents[:k], tokens[:k], scores[:k])
                    self._beam_cache.keep_rows(k)
                self._beam_seqs = np.concatenate(
                    [self._beam_seqs[parents], tokens[:, None]], axis=1
                )
                self._beam_lps = scores

        # lookahead full: commit the first token of the best beam
        best = int(np.argmax(self._beam_lps))
        best_token = int(self._beam_seqs[best, 0])
        self.sequence = np.concatenate(
            [self.sequence, np.array([[best_token]], np.int32)], axis=1
        )
        self.sequence_actual = self.sequence
        self._sync_seq_buf()

        # prune the beams that do not start with the winner; slide
        keep = np.nonzero(self._beam_seqs[:, 0] == best_token)[0]
        keep = np.concatenate([[best], keep[keep != best]]).astype(np.int64)
        self._beam_cache.take_rows(torch.from_numpy(keep))
        self._beam_seqs = self._beam_seqs[keep][:, 1:]
        self._beam_lps = self._beam_lps[keep]
        self._beam_prefix += 1
        if self._beam_seqs.shape[1] == 0:
            self._beam_seqs = None
            self.beams = None               # forces re-expansion next call

        return np.array([[best_token]], np.int32)

    def _sync_main_cache_from_beams(self):
        """Copy the committed positions' K/V from beam row 0 back into the
        main cache (every kept row holds the same K/V there: they share the
        committed prefix)."""
        if self.sequence is None:
            return
        target_len = self.sequence.shape[1] - 1
        valid = self.cache.current_seq_len
        if self._beam_cache is not None and target_len > valid:
            self._beam_cache.copy_states(
                self.cache, valid, target_len - valid, valid,
                target_len - valid, from_row=0, from_rows=1, to_row=0,
                to_rows=1,
            )
            self.cache.current_seq_len = target_len

    def end_beam_search(self):
        if not self.in_beam_search:
            return
        self.sequence = self.sequence_actual.copy()
        self._sync_main_cache_from_beams()
        self.cache.current_seq_len = self.sequence.shape[1] - 1
        self.beams = None
        self._beam_seqs = None
        self._beam_cache = None
        self.in_beam_search = False

    def replace_last_token(self, token, seq=False):
        self.sequence_actual[:, -1] = int(np.asarray(token).reshape(-1)[0])
        if seq:
            self.sequence[:, -1] = int(np.asarray(token).reshape(-1)[0])

    def sequence_ends_with(self, tokens) -> bool:
        tokens = np.asarray(tokens).reshape(-1)
        n = len(tokens)
        if self.sequence_actual.shape[1] < n + 1:
            return False
        return bool(np.array_equal(self.sequence_actual[0, -n:], tokens))
