"""Rotary position embeddings (port of exllama_tpu/ops/rope.py).

sin/cos tables are precomputed once per model; linear position compression
(``compress_pos_emb``) and NTK-alpha theta scaling (applied to ``base`` by the
config) are both supported. The rotation runs in f32.
"""

from __future__ import annotations

import torch


def rope_tables(
    max_seq_len: int,
    head_dim: int,
    base: float = 10000.0,
    compress_pos_emb: float = 1.0,
    device="cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) f32 tables of shape [max_seq_len, head_dim]."""
    inv_freq = 1.0 / (
        base ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim)
    )
    t = torch.arange(max_seq_len, dtype=torch.float32) / compress_pos_emb
    freqs = torch.outer(t, inv_freq)                     # [S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)              # [S, D]
    return torch.sin(emb).to(device), torch.cos(emb).to(device)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def slice_tables(sin, cos, past_len, t: int):
    """Rows [past, past+t) of the tables, shaped to broadcast over
    [B, T, H, D]. ``past_len`` is an int or a [B] tensor of per-row cursors."""
    if isinstance(past_len, int):
        s = sin[past_len : past_len + t]
        c = cos[past_len : past_len + t]
        return s[None, :, None, :], c[None, :, None, :]
    pos = past_len.to(torch.long)[:, None] + torch.arange(
        t, device=past_len.device
    )[None, :]
    return sin[pos][:, :, None, :], cos[pos][:, :, None, :]


def apply_rope_sliced(x: torch.Tensor, s: torch.Tensor, c: torch.Tensor):
    """Rotate [B, T, H, D] by pre-sliced tables; f32 math, result in x.dtype."""
    xf = x.to(torch.float32)
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)
