"""Sampling: the reference's sampler set on f32 logits (port of
exllama_tpu/ops/sampling.py).

  * temperature -> softmax
  * top-k (0 = disabled)
  * top-p with embedded min-p: walking the descending-prob list, token i
    (i > 0) survives iff inclusive-cumsum(i) <= top_p and prob(i) >= min_p;
    the top token always survives
  * locally-typical sampling on the renormalized surviving set
  * repetition penalty with sustain window + linear decay tail

Randomness comes from an explicit ``torch.Generator``; its draws differ from
JAX's PRNG for the same seed, so tests compare the deterministic parts.
Everything here runs on the device without a host read, so a CUDA graph can
capture it, and ``torch.multinomial`` draws from the generator registered
with the graph, the same numbers as eagerly. The captured steps take the
sampler's values as a device operand (:func:`settings_operand`, sampled by
:func:`sample_operands`): temperature, top-k, top-p, min-p, typical and the
penalty, as the JAX ``_sample_step`` traces them, so a new value is a copy
into the operand and recaptures nothing; the penalty's sustain and decay
stay Python numbers (static in the JAX package too).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class SamplerSettings:
    temperature: float = 0.95
    top_k: int = 40
    top_p: float = 0.65
    min_p: float = 0.0
    typical: float = 0.0
    token_repetition_penalty_max: float = 1.15
    token_repetition_penalty_sustain: int = 256
    token_repetition_penalty_decay: int = 128
    beams: int = 1
    beam_length: int = 1


def rep_penalty_mask(
    sequence: torch.Tensor,  # [B, S] int token history (positions < seq_len valid)
    seq_len,                 # int, or an int tensor [1] / [B, 1] on sequence's device
    vocab_size: int,
    penalty_max,             # float, or a [B] tensor: one a row
    sustain: int,
    decay: int,
) -> torch.Tensor:
    """Per-token penalty factor [B, V]: the newest ``sustain`` tokens get
    ``penalty_max``, older ones decay linearly to 1.0 over ``decay``
    positions (the token at age == sustain still gets the full penalty);
    sustain == -1 penalizes the whole context. The most recent occurrence of
    a token decides its factor (equivalently the max). A tensor ``seq_len``
    is read on the device only (no host sync), so a captured step can take
    its position from device memory; the arithmetic is the int one's. A
    [B] ``penalty_max`` (with a [B, 1] ``seq_len``) gives each row its own
    penalty and length; a row at 1.0 gets 1.0 everywhere."""
    b, s_max = sequence.shape
    dev = sequence.device
    pen = penalty_max
    if torch.is_tensor(pen):
        pen = pen.to(device=dev, dtype=torch.float32)[:, None]
    pos = torch.arange(s_max, device=dev)[None, :]
    age = (seq_len - 1 - pos).to(torch.float32)
    full = torch.zeros_like(age) + pen
    if sustain == -1:
        v = full
        in_window = pos >= 0
    else:
        dv = (1.0 - pen) / decay if decay else 0.0
        v = torch.where(age <= sustain, full, pen + dv * (age - sustain))
        in_window = age < sustain + decay
    valid = (pos < seq_len) & in_window & (v > 1.0)
    v = torch.where(valid, v, 1.0).expand(b, s_max)
    ids = torch.where(pos < seq_len, sequence.to(torch.long), vocab_size)
    mask = torch.ones((b, vocab_size + 1), dtype=torch.float32, device=dev)
    mask.scatter_reduce_(1, ids, v.contiguous(), reduce="amax")
    return mask[:, :vocab_size]


def apply_rep_penalty(logits, sequence, seq_len, penalty_max, sustain, decay):
    """logits/v where positive, logits*v where negative."""
    v = rep_penalty_mask(
        sequence, seq_len, logits.shape[-1], penalty_max, sustain, decay
    )
    return torch.where(logits > 0.0, logits / v, logits * v)


def filter_rows(logits, temperature, top_k, top_p, min_p, typical):
    """The reference filtering pipeline (exllama_tpu/ops/sampling.py:
    _filter_row, under ``jax.vmap`` for [B] settings) on every row of
    [B, W] f32 logits at once: normalized probabilities [B, W] in vocab
    order, exact zeros on the filtered-out tokens. Each setting is a number
    for all rows or a [B] tensor, one a row; ``top_k`` 0 and ``top_p`` /
    ``typical`` 0.0 disable their stages. A stage whose setting is a number
    that disables it is left out; a [B] setting picks each row's result with
    ``torch.where``, so nothing reads the host."""
    f32 = torch.float32
    w = logits.shape[-1]
    dev = logits.device

    def col(x, dtype):
        if torch.is_tensor(x):
            return x.to(device=dev, dtype=dtype)[:, None]
        return torch.full((1, 1), x, dtype=dtype, device=dev)

    def on(x):
        return torch.is_tensor(x) or x > 0

    probs = torch.softmax(logits.to(f32) / col(temperature, f32) + 1e-8,
                          dim=-1)
    # descending; ties keep the lower index first, like jax.lax.top_k
    sp, si = torch.sort(probs, dim=-1, descending=True, stable=True)
    ranks = torch.arange(w, device=dev)[None, :]

    if on(top_k):
        k = col(top_k, torch.int64)
        sp = torch.where((k <= 0) | (ranks < k), sp, 0.0)
    sp = sp / sp.sum(dim=-1, keepdim=True)

    if on(top_p):
        p = col(top_p, f32)
        cum = torch.cumsum(sp, dim=-1)
        keep = (ranks == 0) | ((cum <= p) & (sp >= col(min_p, f32)))
        cut = torch.where(keep, sp, 0.0)
        sp = torch.where(p > 0.0, cut / cut.sum(dim=-1, keepdim=True), sp)

    if on(typical):
        t = col(typical, f32)
        logp = torch.log(sp + 1e-10)
        neg_entropy = torch.where(sp > 0, sp * logp, 0.0).sum(dim=-1,
                                                              keepdim=True)
        dev_ = torch.where(sp > 0, torch.abs(neg_entropy - logp), torch.inf)
        order = torch.argsort(dev_, dim=-1, stable=True)   # ascending deviation
        sp_t = sp.gather(1, order)
        keep_t = (ranks == 0) | (torch.cumsum(sp_t, dim=-1) <= t)
        sp_t = torch.where(keep_t, sp_t, 0.0)
        typ = torch.zeros_like(sp).scatter_(1, order, sp_t)
        sp = torch.where(t > 0.0, typ / typ.sum(dim=-1, keepdim=True), sp)

    return torch.zeros_like(sp).scatter_(1, si, sp)


# the generator's name for it: [B, V] logits under one setting of each
filter_probs = filter_rows


def sample(
    logits: torch.Tensor,           # [B, V] f32
    generator: torch.Generator,
    settings: SamplerSettings,
    disallowed: Optional[torch.Tensor] = None,  # [V] bool, True = banned
    logit_bias: Optional[torch.Tensor] = None,  # [B, V] or [V] additive
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one token per row. Returns (tokens [B] int32, probs [B])."""
    lg = logits.to(torch.float32)
    if disallowed is not None:
        lg = torch.where(disallowed[None, :], -torch.inf, lg)
    if logit_bias is not None:
        lg = lg + logit_bias
    sp = filter_probs(lg, settings.temperature, settings.top_k,
                      settings.top_p, settings.min_p, settings.typical)
    tokens = torch.multinomial(sp, 1, generator=generator)[:, 0]
    return tokens.to(torch.int32), sp.gather(1, tokens[:, None])[:, 0]


# the settings a captured step reads from its device operand, in its order
OPERAND_FIELDS = ("temperature", "top_k", "top_p", "min_p", "typical",
                  "token_repetition_penalty_max")


def settings_operand(settings: SamplerSettings, device,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The values of ``settings`` named by OPERAND_FIELDS as an f32 [6]
    tensor on ``device``, copied into ``out`` (in place) where it is
    given."""
    vals = torch.tensor([float(getattr(settings, f)) for f in OPERAND_FIELDS],
                        dtype=torch.float32)
    if out is None:
        return vals.to(device)
    return out.copy_(vals)


def filter_operands(logits: torch.Tensor, ops: torch.Tensor,
                    typical: bool = True) -> torch.Tensor:
    """:func:`filter_rows` of [B, V] f32 logits under the settings of the
    device operand ``ops`` (:func:`settings_operand`), the same for every
    row: normalized probabilities [B, V]. ``typical=False`` leaves the
    typical stage out (the JAX ``lax.cond(typical > 0)``); the caller
    knows the setting to be 0."""
    return filter_rows(logits, ops[0:1], ops[1:2], ops[2:3], ops[3:4],
                       ops[4:5] if typical else 0.0)


def sample_operands(
    logits: torch.Tensor,             # [B, V] f32, penalties applied
    generator: torch.Generator,
    ops: torch.Tensor,                # [6] f32: settings_operand
    logit_bias: Optional[torch.Tensor] = None,  # [B, V] or [V] additive
    typical: bool = True,
) -> torch.Tensor:
    """:func:`sample` with the settings read from the device operand
    ``ops`` (the JAX ``_sample_step`` / ``_sample_grid`` with traced
    settings): every stage of :func:`filter_rows` runs and a disabled one
    leaves the distribution as it was, but for typical sampling, which
    ``typical=False`` leaves out (as the JAX step's ``lax.cond`` does). A row at top-k 1 returns the argmax
    of the biased logits, bit for bit (the filter's one candidate can
    differ from it only by a tie in the f32 softmax); the draw is made
    either way, so the generator advances alike. Returns int32 [B]."""
    lg = logits.to(torch.float32)
    if logit_bias is not None:
        lg = lg + logit_bias
    sp = filter_operands(lg, ops, typical)
    drawn = torch.multinomial(sp, 1, generator=generator)[:, 0]
    best = torch.argmax(lg, dim=-1)
    return torch.where(ops[1] == 1, best, drawn).to(torch.int32)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax per row (the temperature -> 0 limit / top_k = 1)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ------------------------------------------------ per-row (serving) samplers
#
# The continuous-batching engine (serve/engine.py) keeps one sampler setting
# a slot: ``temperature``, ``top_k``, ``top_p``, ``min_p``, ``typical`` and
# ``penalty_max`` are [B] tensors on the device, which :func:`filter_rows`
# and :func:`rep_penalty_mask` take row by row, so nothing reads the host
# and a graph can capture the whole step.


def filter_sample_rows(lg, generator, temperature, top_k, top_p, min_p,
                       typical, candidate_cap: int = 0) -> torch.Tensor:
    """One token a row of [B, V] f32 logits (penalties and bias applied),
    each row under its own settings: :func:`filter_rows`, then one
    ``torch.multinomial`` over the rows from ``generator``
    (exllama_tpu/ops/sampling.py:filter_sample_rows). With
    ``candidate_cap`` C < V, ``torch.topk`` first keeps each row's C
    highest logits and the same filter runs C wide (top-p and typical then
    renormalize over the top-C mass: opt-in). Returns int32 [B]."""
    v = lg.shape[-1]
    idx = None
    if candidate_cap and candidate_cap < v:
        lg, idx = torch.topk(lg, candidate_cap, dim=-1)
    sp = filter_rows(lg, temperature, top_k, top_p, min_p, typical)
    choice = torch.multinomial(sp, 1, generator=generator)
    if idx is not None:
        choice = idx.gather(1, choice)
    return choice[:, 0].to(torch.int32)


def rep_window(s_max: int, sustain: int, decay: int) -> int:
    """The history positions that can carry a penalty: with a finite
    sustain only the last sustain + decay, rounded up to 128."""
    if sustain < 0:
        return s_max
    return min(s_max, -(-(sustain + decay) // 128) * 128)


def rep_mask_windowed(hist, lens, penalty_max, vocab: int, sustain: int,
                      decay: int) -> torch.Tensor:
    """[B, V] repetition-penalty factors of each row over its own history
    (exllama_tpu/serve/engine.py:_rep_mask_windowed): ``hist`` [B, S] int
    tokens with ``lens`` [B] valid positions, ``penalty_max`` [B], all on
    the device. Only each row's last W = :func:`rep_window` positions can
    matter, so :func:`rep_penalty_mask` runs over that window: ages are
    window-relative and equal to its ages over the whole row."""
    s_max = hist.shape[1]
    w = rep_window(s_max, sustain, decay)
    lens = lens.to(device=hist.device, dtype=torch.int64)
    start = torch.clamp(lens - w, min=0, max=s_max - w)
    pos = torch.arange(w, device=hist.device)[None, :]
    win = hist.gather(1, start[:, None] + pos)
    return rep_penalty_mask(win, torch.clamp(lens, max=w)[:, None], vocab,
                            penalty_max, sustain, decay)
