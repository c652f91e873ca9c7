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
capture it (``generator.DecodeLoop``): the sampler settings are Python
numbers, fixed in the capture, and ``torch.multinomial`` draws from the
generator registered with the graph, the same numbers as eagerly.
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
    seq_len,                 # int, or a [1] int tensor on sequence's device
    vocab_size: int,
    penalty_max: float,
    sustain: int,
    decay: int,
) -> torch.Tensor:
    """Per-token penalty factor [B, V]: the newest ``sustain`` tokens get
    ``penalty_max``, older ones decay linearly to 1.0 over ``decay``
    positions (the token at age == sustain still gets the full penalty);
    sustain == -1 penalizes the whole context. The most recent occurrence of
    a token decides its factor (equivalently the max). A tensor ``seq_len``
    is read on the device only (no host sync), so a captured step can take
    its position from device memory; the arithmetic is the int one's."""
    b, s_max = sequence.shape
    dev = sequence.device
    pos = torch.arange(s_max, device=dev)[None, :]
    age = (seq_len - 1 - pos).to(torch.float32)
    if sustain == -1:
        v = torch.full_like(age, penalty_max)
        in_window = pos >= 0
    else:
        dv = (1.0 - penalty_max) / decay if decay else 0.0
        v = torch.where(
            age <= sustain,
            torch.full_like(age, penalty_max),
            penalty_max + dv * (age - sustain),
        )
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


def _filter_row(logits, temperature, top_k, top_p, min_p, typical):
    """The reference filtering pipeline on one row [V] -> normalized probs
    in vocab order, exact zeros on filtered-out tokens."""
    v = logits.shape[-1]
    logits = logits / temperature + 1e-8
    probs = torch.softmax(logits, dim=-1)
    # descending; ties keep the lower index first, like jax.lax.top_k
    sp, si = torch.sort(probs, descending=True, stable=True)
    ranks = torch.arange(v, device=logits.device)

    if top_k > 0:
        sp = torch.where(ranks < top_k, sp, 0.0)
    sp = sp / sp.sum()

    if top_p > 0.0:
        cum = torch.cumsum(sp, dim=0)
        keep = (ranks == 0) | ((cum <= top_p) & (sp >= min_p))
        sp = torch.where(keep, sp, 0.0)
        sp = sp / sp.sum()

    if typical > 0.0:
        logp = torch.log(sp + 1e-10)
        neg_entropy = torch.where(sp > 0, sp * logp, 0.0).sum()
        dev = torch.abs(neg_entropy - logp)
        dev = torch.where(sp > 0, dev, torch.inf)
        order = torch.argsort(dev, stable=True)      # ascending deviation
        sp_t = sp[order]
        cum = torch.cumsum(sp_t, dim=0)
        keep_t = (ranks == 0) | (cum <= typical)
        sp_t = torch.where(keep_t, sp_t, 0.0)
        sp = torch.zeros_like(sp).index_copy(0, order, sp_t)
        sp = sp / sp.sum()

    return torch.zeros_like(sp).index_copy(0, si, sp)


def filter_probs(logits, temperature, top_k, top_p, min_p, typical):
    """Batched :func:`_filter_row` over [B, V] f32 logits."""
    lg = logits.to(torch.float32)
    return torch.stack([
        _filter_row(row, temperature, top_k, top_p, min_p, typical)
        for row in lg
    ])


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


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax per row (the temperature -> 0 limit / top_k = 1)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
