"""Continuous batching engine (port of exllama_tpu/serve/engine.py): a
slotted KV cache with per-slot cursors, chunked admission interleaved with
decode, per-slot sampler settings and LoRA adapters, stop strings.

  * the KV cache is a fixed pool of ``max_slots`` rows (one
    ``ExLlamaCache`` of that batch size); each slot has its own cursor, so
    sequences of different lengths decode together in one batched step;
  * one decode step advances every slot: ``forward_chunk`` at T = 1 on an
    int32 [B] device cursor (rope rows, the kernels' causal masks and the
    K/V commit all read it on the device), then each slot's repetition
    penalty over its own history window (skipped while every slot is at
    penalty 1.0), the BOS ban, the per-row sampler (argmax while every
    occupied slot is at top-k 1), the history append at each slot's length
    and cursor + active -- then ONE packed device-to-host read a step
    (tokens, cursors, lengths). The device operands stay on the device
    between steps and are refreshed from the host only when the slot map
    changes;
  * on the card that step is one ``torch.cuda.CUDAGraph`` per attend-length
    bucket, captured by ``generator.capture_step`` (the recipe of
    ``generator.DecodeLoop``) under an epoch of the static choices: penalty
    on or off, greedy-all, the candidate cap, the adapter on or off with
    the stacked adapter's identity and rank, the forward knobs and the
    parameters. The pending tokens, cursors, lengths, active flags, sampler
    vectors, bias, history and stacked adapter are static buffers that the
    host copies into when the slot map changes; each replay adds its
    captured launch counts to the counters. Admission chunks and the
    speculative step run eagerly. ``capture = False`` (and the CPU) runs
    the same step eagerly;
  * admission prefill is chunked: each ``step()`` runs at most one
    ``prefill_bucket``-token chunk of one request into a B = 1 scratch
    cache (``ExLlama.forward(preprocess_only=True)`` under the request's
    adapter), and the finished prompt is copied into its slot with
    ``ExLlamaCache.copy_states`` (int8 / int4 scales included);
  * per-request LoRA: adapters registered once (``register_lora``) are
    stacked per slot as [slots, in, rmax] / [slots, rmax, out] (zero rows
    for slots without one; smaller ranks zero-padded), the per-row form
    ``ops.quant.lora_delta`` takes, so the gates' adapter conditions pick
    the routes as for a single adapter;
  * stop strings with the held-text detokenizer window
    (``utils.streaming.split_on_stop_strings``, case-insensitive); a slot is
    freed at a stop token, a stop string, ``max_new_tokens`` or the end of
    the cache;
  * speculative mode (``spec_proposer=NgramProposer()``): each step drafts
    up to ``spec_lookahead`` tokens per slot on the host, verifies them in
    one K+1-token forward at the [B] cursor, samples the target at every
    position, accepts the matching prefix on the device, writes the
    history under a mask and reads one packed result. It runs eagerly (its
    graph is a later item of ROADMAP.md queue 2).

Threads and streams: the engine's forwards, admissions, captures and
replays all run on the one thread that calls ``step()``, in the order it
issues them, on that thread's current stream (a capture records on a side
stream that waits for the current one and is waited for). So the kernels'
per-device scratches (K3's partials and tickets, the GEMVs' partials and
tickets, K5's keys) are never used by two launches at once, and a graph
holds the scratches it captured. Of the front ends only ``serve.api`` goes
through the engine: its HTTP threads submit under a lock and read the
host-side request state, and its engine thread alone touches the card. The
web UI (``ExLlamaGenerator`` on its HTTP threads, one generation at a time
under its ``generate_lock``) and the websocket server
(``ExLlamaAltGenerator`` on its event-loop thread) each use the card from
one generating thread at a time. The scratches are per device, not per
front end: two front ends in one process would share them.

Over a mesh (the model's, ``ExLlama(config, mesh=)``; engine.py:412-457)
the engine is SPMD: every rank runs ``step()`` in lockstep on the same
submissions (each caller submits the same requests on every rank) and
keeps the same host state. A rank's slot cache holds its data-parallel
replica's slots (``parallel.multihost.local_batch_slice``) and its tp
heads; ``forward_chunk`` computes the replica's rows and gathers the
logits over dp, so every rank samples every slot, from the same seeded
generator, alike. Admission chunks run on every replica into the B = 1
scratch (heads split, rows whole) and a finished prompt is copied into the
slot's row by the replica that owns it. The decode step runs eagerly
there (``generator.DecodeLoop`` says why). A relay of HTTP submissions
from one rank to the others is the front ends' part, not done yet.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from exllama_tpu_torch import kernels
from exllama_tpu_torch.cache import ExLlamaCache
from exllama_tpu_torch.generator import capture_step
from exllama_tpu_torch.lora import _PROJ_NAMES, LayerLora
from exllama_tpu_torch.models.llama import forward_chunk
from exllama_tpu_torch.ops.sampling import (
    SamplerSettings,
    filter_sample_rows,
    rep_mask_windowed,
)
from exllama_tpu_torch.parallel.multihost import local_batch_slice
from exllama_tpu_torch.utils.streaming import split_on_stop_strings

QUEUED, PREFILL, RUNNING, DONE = "queued", "prefill", "running", "done"
_req_counter = itertools.count()
# the rows of the engine's [6, slots] sampler-settings buffer
_SETTINGS = (("temperature", 1.0), ("top_k", 1), ("top_p", 0.0),
             ("min_p", 0.0), ("typical", 0.0),
             ("token_repetition_penalty_max", 1.0))


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_ids: np.ndarray                  # [P]
    max_new_tokens: int
    settings: SamplerSettings
    stop_tokens: tuple
    stop_strings: tuple = ()
    lora_id: int = -1                       # register_lora() handle, -1=none
    new_tokens: list = dataclasses.field(default_factory=list)
    state: str = QUEUED
    slot: int = -1
    on_token: Optional[Callable] = None     # streaming callback(req, tok)
    on_text: Optional[Callable] = None      # streaming callback(req, text)
    text: str = ""                          # released (post-holding) text
    _decoded: str = ""                      # decode of the detok window
    _detok_base: int = 0                    # window start in new_tokens
    _held: str = ""                         # held-back possible stop prefix

    @property
    def output_ids(self) -> np.ndarray:
        return np.asarray(self.new_tokens, np.int32)


@dataclasses.dataclass
class _Adapter:
    """An adapter's per-layer ``LayerLora`` list in the form
    ``ExLlama.forward(lora=)`` reads (``.stacked``)."""

    stacked: list


@dataclasses.dataclass
class _Admission:
    """In-flight chunked prefill of one request into the scratch cache."""

    req: Request
    slot: int
    pref: np.ndarray        # prompt_ids[:-1]
    done: int = 0           # tokens prefilled so far


def _split_held(combined: str, stops: tuple) -> tuple[str, str, int]:
    """(release, hold, match): match >= 0 iff a full stop string occurred
    (at the released prefix's end); case-insensitive, the serving
    convention."""
    safe, held, matched = split_on_stop_strings(combined, stops,
                                                fold_case=True)
    return safe, held, (len(safe) if matched else -1)


def _put_rows(hist: torch.Tensor, start: torch.Tensor, values: torch.Tensor,
              counts: Optional[torch.Tensor] = None):
    """values [B, n] into hist [B, W] at columns start[b] .. start[b] + n - 1
    in place, on the device; with ``counts`` [B] only the first counts[b]
    of them (the rest keep their values). Columns past W - 1 are clamped
    onto it, where only a row that writes nothing real (an inactive slot)
    can land."""
    n = values.shape[1]
    cols = torch.arange(n, device=hist.device)[None, :]
    idx = torch.clamp(start.to(torch.int64)[:, None] + cols,
                      max=hist.shape[1] - 1)
    upd = values.to(hist.dtype)
    if counts is not None:
        upd = torch.where(cols < counts[:, None], upd, hist.gather(1, idx))
    hist.scatter_(1, idx, upd)


class ContinuousBatchingEngine:
    # Incremental-detok window: re-decode only the last <= 64 output tokens
    # a step, rebasing to the last 16 when the window fills.
    _DETOK_WINDOW = 64
    _DETOK_KEEP = 16

    def __init__(self, model, tokenizer=None, max_slots: int = 8,
                 seed: int = 0, prefill_bucket: int = 64,
                 attn_bucket: int = 256, mesh=None,
                 spec_proposer=None, spec_lookahead: int = 4,
                 sampler_candidate_cap: int = 0):
        self.mesh = getattr(model, "mesh", None)
        if mesh is not None and mesh is not self.mesh:
            raise ValueError("the engine's mesh must be the model's: build "
                             "the model with ExLlama(config, mesh=mesh)")
        if self.mesh is not None and max_slots % self.mesh.dp:
            raise ValueError(f"max_slots ({max_slots}) must divide over dp "
                             f"({self.mesh.dp})")
        self.model = model
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.prefill_bucket = prefill_bucket
        self.attn_bucket = attn_bucket
        # a host-side per-slot proposer with a propose(seq, k) method and no
        # cross-call state (speculative.NgramProposer)
        self.spec_proposer = spec_proposer
        self.spec_lookahead = spec_lookahead
        self.spec_stats = {"drafted": 0, "accepted": 0, "steps": 0}
        # 0 = full-vocab sampling; C > 0 filters the top-C logits a row
        self.sampler_candidate_cap = sampler_candidate_cap
        cfg = model.config
        dev = model.device
        # on a mesh: the slot cache's rows split over dp (this replica's
        # slots) and its heads over tp; the B = 1 scratch splits heads only
        self.cache = ExLlamaCache(model, batch_size=max_slots)
        self.scratch = ExLlamaCache(model, batch_size=1)
        self._rows = local_batch_slice(max_slots, self.mesh)
        self._ranks = 1 if self.mesh is None else self.mesh.tp * self.mesh.dp
        self.generator = torch.Generator(device=dev).manual_seed(seed)

        s_max = cfg.max_seq_len
        self.pos = np.zeros(max_slots, np.int32)
        self.pending = np.zeros(max_slots, np.int32)
        self.seq_lens = np.zeros(max_slots, np.int32)
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.free = deque(range(max_slots))
        self.queue: deque[Request] = deque()
        self.admitting: deque[_Admission] = deque()
        # engine-wide rep-penalty window (static, as the JAX engine's)
        self.rep_sustain = 256
        self.rep_decay = 128

        # the decode step's static buffers (a graph reads them where they
        # lie): pending tokens, cursors, history lengths, active flags, the
        # history (one column more than the cache: a step at the last cache
        # position has a place for its token), sampler settings, bias
        i32 = dict(dtype=torch.int32, device=dev)
        self._tok = torch.zeros((max_slots, 1), **i32)
        self._cursor = torch.zeros((max_slots,), **i32)
        self._lens = torch.zeros((max_slots,), **i32)
        self._active = torch.zeros((max_slots,), **i32)
        self._hist = torch.zeros((max_slots, s_max + 1), **i32)
        self._settings = torch.zeros((len(_SETTINGS), max_slots),
                                     dtype=torch.float32, device=dev)
        # ban BOS like the generator
        self._bias = torch.zeros((max_slots, cfg.vocab_size),
                                 dtype=torch.float32, device=dev)
        bos = getattr(tokenizer, "bos_token_id", 1) if tokenizer else 1
        self._bias[:, bos] = -10000.0
        self._packed = torch.zeros((3, max_slots), **i32)  # tokens, pos, lens
        self._sched_dirty = True
        self._use_rep = False
        self._greedy_all = True

        # per-request LoRA: registered adapters, each slot's adapter id, the
        # per-slot stack (static buffers, rebuilt when an adapter registers)
        self._loras: list = []
        self._slot_lora = np.full(max_slots, -1, np.int32)
        self._lora_stack: Optional[list] = None
        self._lora_rank = 0
        self._lora_on = False

        # the decode step's graphs: {(epoch, attend_len): (graph, counts,
        # what it keeps alive)}; one stream and one pool for all of them
        self.capture = True
        self.graphs: dict = {}
        self._stream = self._pool = None

    # --------------------------------------------------------------- LoRA

    def register_lora(self, lora) -> int:
        """Register an adapter (``ExLlamaLora`` or its ``.stacked`` list)
        for per-request use; returns the id to pass as ``lora_id``."""
        self._loras.append(list(getattr(lora, "stacked", lora)))
        self._lora_stack = None          # the stack's shapes may change
        self._sched_dirty = True
        return len(self._loras) - 1

    @staticmethod
    def _rank_of(stacked) -> int:
        for ll in stacked:
            for p in _PROJ_NAMES:
                ab = getattr(ll, p)
                if ab is not None:
                    return ab[0].shape[1]
        return 0

    def _fill_lora_stack(self):
        """Copy each slot's adapter into the per-slot stack ([slots, in,
        rmax] / [slots, rmax, out] per adapted projection, zero rows for
        slots without one), allocating the stack when an adapter was
        registered since; ``_lora_on`` says whether any slot has one."""
        self._lora_on = bool(self._loras) and bool(np.any(self._slot_lora >= 0))
        if not self._lora_on:
            return
        n_layers = self.model.config.num_hidden_layers
        dev = self.model.device
        if self._lora_stack is None:
            self._lora_rank = max(self._rank_of(s) for s in self._loras)
            r = self._lora_rank
            layers = []
            for li in range(n_layers):
                fields = {}
                for p in _PROJ_NAMES:
                    adapted = [s[li] for s in self._loras
                               if getattr(s[li], p) is not None]
                    if not adapted:
                        fields[p] = None
                        continue
                    a0, b0 = getattr(adapted[0], p)
                    fields[p] = (
                        torch.zeros((self.max_slots, a0.shape[0], r),
                                    dtype=torch.bfloat16, device=dev),
                        torch.zeros((self.max_slots, r, b0.shape[1]),
                                    dtype=torch.bfloat16, device=dev))
                layers.append(LayerLora(**fields))
            self._lora_stack = layers
        for li, ll in enumerate(self._lora_stack):
            for p in _PROJ_NAMES:
                ab = getattr(ll, p)
                if ab is None:
                    continue
                a_b, b_b = ab
                a_b.zero_()
                b_b.zero_()
                for slot in range(self.max_slots):
                    lid = int(self._slot_lora[slot])
                    src = None if lid < 0 else getattr(self._loras[lid][li], p)
                    if src is None:
                        continue
                    a, b = src
                    a_b[slot, :, : a.shape[1]].copy_(a)
                    b_b[slot, : b.shape[0], :].copy_(b)

    # ------------------------------------------------------------ admission

    def submit(self, prompt, max_new_tokens: int = 128,
               settings: Optional[SamplerSettings] = None,
               stop_tokens: tuple = (), stop_strings: tuple = (),
               lora_id: int = -1, on_token=None, on_text=None) -> Request:
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("a text prompt needs the engine's tokenizer")
            ids = np.asarray(self.tokenizer.encode(prompt))[0]
        else:
            ids = np.asarray(prompt, np.int32).reshape(-1)
        limit = self.model.config.max_seq_len - max_new_tokens - 1
        ids = ids[-limit:] if limit > 0 else ids[:1]
        st = settings or SamplerSettings()
        if self.tokenizer is not None and not stop_tokens:
            stop_tokens = (self.tokenizer.eos_token_id,)
        req = Request(
            req_id=next(_req_counter),
            prompt_ids=ids.astype(np.int32),
            max_new_tokens=max_new_tokens,
            settings=st,
            stop_tokens=tuple(stop_tokens),
            stop_strings=tuple(stop_strings),
            lora_id=lora_id,
            on_token=on_token,
            on_text=on_text,
        )
        self.queue.append(req)
        return req

    def _begin_admission(self, req: Request):
        """Reserve a slot; the prompt's KV prefills chunk by chunk across
        steps."""
        slot = self.free.popleft()
        req.slot = slot
        req.state = PREFILL
        self.admitting.append(_Admission(req=req, slot=slot,
                                         pref=req.prompt_ids[:-1]))
        if len(req.prompt_ids) == 1:
            self._finish_admission(self.admitting.pop())

    def _prefill_chunk(self, adm: _Admission):
        """One ``prefill_bucket``-token chunk (zero-padded; cut at the
        cache's end) into the scratch cache, under the request's adapter
        (the prompt's KV must reflect it)."""
        if adm.done == 0:
            self.scratch.current_seq_len = 0
        c = min(self.prefill_bucket, self.scratch.max_seq_len - adm.done)
        chunk = adm.pref[adm.done : adm.done + c]
        padded = np.zeros((1, c), np.int32)
        padded[0, : len(chunk)] = chunk
        lora = None
        if adm.req.lora_id >= 0:
            lora = _Adapter(self._loras[adm.req.lora_id])
        self.model.forward(padded, self.scratch, preprocess_only=True,
                           lora=lora)
        adm.done += c

    def _finish_admission(self, adm: _Admission):
        req, slot = adm.req, adm.slot
        if adm.done > 0 and self._rows.start <= slot < self._rows.stop:
            # into this replica's rows only (engine.py:448-455)
            n = min(adm.done, self.scratch.max_seq_len)
            self.scratch.copy_states(self.cache, 0, n, 0, n, 0, 1,
                                     slot - self._rows.start, 1)
        ids = req.prompt_ids
        plen = len(ids)
        self.pos[slot] = plen - 1
        self.pending[slot] = ids[-1]
        self.seq_lens[slot] = plen
        row = np.zeros((self._hist.shape[1],), np.int32)
        row[:plen] = ids
        self._hist[slot].copy_(torch.from_numpy(row))
        self.slot_req[slot] = req
        req.state = RUNNING
        self._slot_lora[slot] = req.lora_id
        self._sched_dirty = True

    def _admit(self):
        while self.free and self.queue:
            self._begin_admission(self.queue.popleft())
        # at most ONE prefill chunk a step: running requests stall at most
        # one chunk a decode token
        if self.admitting:
            adm = self.admitting[0]
            self._prefill_chunk(adm)
            if adm.done >= len(adm.pref):
                self._finish_admission(self.admitting.popleft())

    # ----------------------------------------------------------------- step

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def has_work(self) -> bool:
        return (
            bool(self.queue) or bool(self.admitting) or self.num_active > 0
        )

    def _stream_text(self, req: Request, finished: bool) -> bool:
        """Incremental detokenize + stop-string holding. Returns True if a
        stop string completed (the request must finish)."""
        if self.tokenizer is None:
            return False
        ids = req.output_ids
        tail = ids[req._detok_base:]
        decoded = self.tokenizer.decode(tail)
        new_text = decoded[len(req._decoded):]
        req._decoded = decoded
        if len(tail) > self._DETOK_WINDOW:
            req._detok_base = len(ids) - self._DETOK_KEEP
            req._decoded = self.tokenizer.decode(ids[req._detok_base:])
        combined = req._held + new_text
        if not req.stop_strings:
            release, req._held, match = combined, "", -1
        else:
            release, req._held, match = _split_held(combined,
                                                    req.stop_strings)
        if finished and match < 0:
            release, req._held = combined, ""
        if release:
            req.text += release
            if req.on_text is not None:
                req.on_text(req, release)
        return match >= 0

    def _sampler_vec(self, attr, default):
        return np.asarray([getattr(r.settings, attr) if r else default
                           for r in self.slot_req], np.float32)

    def _upload(self, active: np.ndarray):
        """The slot map changed: copy the host mirrors, the sampler vectors
        and the slots' adapters into the static buffers (one host-to-device
        copy of the integers, one of the settings)."""
        ints = torch.from_numpy(np.stack([
            self.pending, self.pos, self.seq_lens, active.astype(np.int32)]))
        sets = np.stack([self._sampler_vec(a, d) for a, d in _SETTINGS])
        ints = ints.to(self._tok.device)
        self._tok.copy_(ints[0, :, None])
        self._cursor.copy_(ints[1])
        self._lens.copy_(ints[2])
        self._active.copy_(ints[3])
        self._settings.copy_(torch.from_numpy(sets))
        # penalty 1.0 on every slot is an exact no-op; top-k 1 on every
        # slot (empty ones default to 1) makes sampling argmax
        self._use_rep = bool(np.any(sets[5] != 1.0))
        self._greedy_all = bool(np.all(sets[1] == 1))
        self._fill_lora_stack()
        self._sched_dirty = False

    def _forward_kwargs(self) -> dict:
        cfg = self.model.config
        t = cfg.tuning
        return dict(heads=cfg.num_attention_heads,
                    kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
                    eps=cfg.rms_norm_eps, mlp_fuse=t.fuse_mlp,
                    attn_fuse=t.fuse_attn, qkv_fuse=t.fuse_qkv,
                    commit_impl=t.commit_impl, matmul_impl=t.matmul_impl,
                    attn_impl=t.attn_impl)

    def _sample(self, lg: torch.Tensor, k1: int = 0) -> torch.Tensor:
        """Penalty, bias and the per-row sampler on the step's f32 logits:
        [B, V] -> [B], or [B, k1, V] -> [B, k1] (every position of a slot
        under the slot's settings and its committed history's penalty)."""
        b = self.max_slots
        vocab = lg.shape[-1]
        if self._use_rep:
            vmask = rep_mask_windowed(self._hist, self._lens,
                                      self._settings[5], vocab,
                                      self.rep_sustain, self.rep_decay)
            if k1:
                vmask = vmask[:, None, :]
            lg = torch.where(lg > 0, lg / vmask, lg * vmask)
        lg = lg + (self._bias[:, None, :] if k1 else self._bias)
        best = torch.argmax(lg, dim=-1).to(torch.int32)
        if self._greedy_all:
            return best
        rows = lg.reshape(-1, vocab)
        sets = self._settings[:5]
        if k1:
            sets = sets.repeat_interleave(k1, dim=1)
        drawn = filter_sample_rows(rows, self.generator, *sets,
                                   candidate_cap=self.sampler_candidate_cap)
        # a row at top-k 1 keeps the argmax (the filter's one candidate up
        # to ties in its f32 softmax)
        greedy = sets[1] == 1
        return torch.where(greedy, best.reshape(-1), drawn).reshape(best.shape)

    def _decode_step(self, attend_len: int, kw: dict):
        """One batched decode step on the static buffers, no host read."""
        logits = forward_chunk(
            self.model.params, self.cache, self._tok, self._cursor, None,
            attend_len=attend_len, last_token_only=True,
            preprocess_only=False,
            lora=self._lora_stack if self._lora_on else None, **kw)
        tokens = self._sample(logits[:, -1, :].to(torch.float32))
        _put_rows(self._hist, self._lens, tokens[:, None])
        self._tok.copy_(tokens[:, None])
        self._cursor.add_(self._active)
        self._lens.add_(self._active)
        self._packed[0].copy_(tokens)
        self._packed[1].copy_(self._cursor)
        self._packed[2].copy_(self._lens)

    def _run_decode(self, attend_len: int):
        """The decode step: replayed from its graph, captured at the first
        step of a new (epoch, bucket), or eager (CPU, ``capture=False``)."""
        kw = self._forward_kwargs()
        dev = self._tok.device
        if not (self.capture and dev.type == "cuda") or self._ranks > 1:
            self._decode_step(attend_len, kw)
            return
        epoch = (self._use_rep, self._greedy_all, self.sampler_candidate_cap,
                 self._lora_on, id(self._lora_stack) if self._lora_on else None,
                 self._lora_rank if self._lora_on else 0,
                 tuple(sorted(kw.items())), id(self.model.params))
        entry = self.graphs.get((epoch, attend_len))
        if entry is not None:
            entry[0].replay()
            kernels.add_launches(entry[1])
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        graph, counts = capture_step(
            lambda: self._decode_step(attend_len, kw), dev, self._stream,
            self._pool, None if self._greedy_all else self.generator)
        self.graphs[(epoch, attend_len)] = (
            graph, counts, (kernels.scratch_in_use(dev), self.model.params,
                            self._lora_stack if self._lora_on else None))

    def _retire(self, slot: int, req: Request, tok: int) -> bool:
        """Account one emitted token of ``req``; True if it finishes."""
        cfg = self.model.config
        req.new_tokens.append(tok)
        self.pending[slot] = tok
        finished = (
            tok in req.stop_tokens
            or len(req.new_tokens) >= req.max_new_tokens
            or int(self.pos[slot]) >= cfg.max_seq_len - 1
        )
        if req.on_token is not None:
            req.on_token(req, tok)
        if req.stop_strings or req.on_text is not None:
            if self._stream_text(req, finished):
                finished = True
        return finished

    def _free(self, slot: int, req: Request):
        req.state = DONE
        self.slot_req[slot] = None
        self.free.append(slot)
        # an inactive row still runs in every step and writes at its cursor:
        # park it at 0, so that a speculative step's K+1 rows (allowed by the
        # active slots' room alone) stay inside the rope tables and the cache
        self.pos[slot] = 0
        self.seq_lens[slot] = 0
        self._sched_dirty = True

    def step(self) -> list[tuple[Request, int, bool]]:
        """Admit pending requests (<= 1 prefill chunk), run one batched
        decode step, retire finished ones. Returns [(request, token,
        finished), ...]. With ``spec_proposer`` set, a step verifies up to
        ``spec_lookahead`` drafted tokens per slot in the same batched
        forward and may return several tokens per request."""
        self._admit()
        if self.num_active == 0:
            return []
        cfg = self.model.config
        active = np.array([r is not None for r in self.slot_req])
        max_pos = int(self.pos[active].max()) + 1
        if (self.spec_proposer is not None
                # the K+1 history / cache writes need headroom: plain steps
                # near the end of the window
                and max_pos + self.spec_lookahead + 1 <= cfg.max_seq_len - 1):
            return self._step_spec(active, max_pos)
        attend_len = min(cfg.max_seq_len,
                         -(-max_pos // self.attn_bucket) * self.attn_bucket)
        if self._sched_dirty:
            self._upload(active)
        self._run_decode(attend_len)
        packed = self._packed.cpu().numpy()     # the ONE device->host read
        tokens = packed[0]
        self.pos = packed[1].copy()
        self.seq_lens = packed[2].copy()

        results = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(tokens[slot])
            finished = self._retire(slot, req, tok)
            if finished:
                self._free(slot, req)
            results.append((req, tok, finished))
        return results

    def _step_spec(self, active, max_pos) -> list[tuple[Request, int, bool]]:
        """Speculative step: host-side drafts per slot, one batched K+1
        verify forward at the [B] cursor, target samples at every position,
        the accepted prefix (+ the correction) committed on the device, one
        packed read."""
        cfg = self.model.config
        kd = self.spec_lookahead
        k1 = kd + 1
        b = self.max_slots
        ints = np.zeros((b, k1 + kd + 1), np.int32)   # tokens, draft, k_valid
        ints[:, 0] = self.pending
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            seq = np.concatenate(
                [req.prompt_ids, np.asarray(req.new_tokens, np.int32)])
            d = self.spec_proposer.propose(seq, kd)
            ints[slot, 1 : 1 + len(d)] = d
            ints[slot, k1 : k1 + len(d)] = d
            ints[slot, -1] = len(d)
        attend_len = min(cfg.max_seq_len,
                         -(-(max_pos + k1) // self.attn_bucket)
                         * self.attn_bucket)
        # the spec step advances the host mirrors itself, so the static
        # buffers are refreshed from them every spec step
        self._upload(active)
        self._sched_dirty = True
        dev_ints = torch.from_numpy(ints).to(self._tok.device)
        tokens, draft = dev_ints[:, :k1], dev_ints[:, k1 : k1 + kd]
        k_valid = dev_ints[:, -1]
        logits = forward_chunk(
            self.model.params, self.cache, tokens, self._cursor, None,
            attend_len=attend_len, last_token_only=False,
            preprocess_only=False,
            lora=self._lora_stack if self._lora_on else None,
            **self._forward_kwargs())
        samples = self._sample(logits.to(torch.float32), k1)    # [B, K+1]

        # prefix acceptance: position i survives while the target's sample
        # equals the draft; m = the surviving prefix's length
        i_k = torch.arange(kd, device=samples.device)[None, :]
        match = (samples[:, :kd] == draft) & (i_k < k_valid[:, None])
        m = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        corr = samples.gather(1, m[:, None].to(torch.int64))
        i_all = torch.arange(k1, device=samples.device)[None, :]
        draft_pad = torch.nn.functional.pad(draft, (0, 1))
        out_tokens = torch.where(i_all < m[:, None], draft_pad, corr)
        counts = (m + 1).to(torch.int32) * self._active
        # masked history append: K+1 candidate rows, only counts of them
        # real; cache rows past counts lie beyond the committed length and
        # the next step's writes at the advanced cursor overwrite them
        _put_rows(self._hist, self._lens, out_tokens, counts)
        self._cursor.add_(counts)
        self._lens.add_(counts)
        packed = torch.cat([out_tokens.to(torch.int32), counts[:, None],
                            self._cursor[:, None], self._lens[:, None]],
                           dim=1).cpu().numpy()         # the ONE host read
        out_tokens = packed[:, :k1]
        counts = packed[:, k1]
        self.pos = packed[:, k1 + 1].copy()
        self.seq_lens = packed[:, k1 + 2].copy()
        self.spec_stats["steps"] += 1

        results = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            c = int(counts[slot])
            self.spec_stats["drafted"] += int(ints[slot, -1])
            self.spec_stats["accepted"] += c - 1
            finished = False
            for j in range(c):
                tok = int(out_tokens[slot, j])
                finished = self._retire(slot, req, tok)
                results.append((req, tok, finished))
                if finished:
                    break
            if finished:
                self._free(slot, req)
        return results

    def run(self) -> list[Request]:
        """Drain the queue and the active slots; returns finished
        requests."""
        done = []
        while self.has_work():
            for req, _tok, finished in self.step():
                if finished:
                    done.append(req)
        return done

    def generate(self, prompts: list, max_new_tokens: int = 128,
                 settings: Optional[SamplerSettings] = None) -> list:
        """Submit all, drain, decode."""
        reqs = [self.submit(p, max_new_tokens, settings) for p in prompts]
        self.run()
        return [
            self.tokenizer.decode(r.output_ids) if self.tokenizer
            else r.output_ids
            for r in reqs
        ]
