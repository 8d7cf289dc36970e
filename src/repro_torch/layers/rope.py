"""Rotary position embeddings (half-split convention), counterpart of
``repro.layers.rope`` without M-RoPE."""

from __future__ import annotations

import torch


def rope_tables(positions: torch.Tensor, dim: int, theta: float = 1e4):
    """(cos, sin) f32 [B, S, 1, dim//2] from positions [B, S]; computed
    once per forward and shared by q/k and every layer."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv  # [B, S, dim//2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               tables=None) -> torch.Tensor:
    """x [B, S, H, D]. The f32 tables are cast to ``x.dtype`` first, as in
    the reference."""
    d = x.shape[-1]
    if tables is None:
        tables = rope_tables(positions, d, theta)
    cos = tables[0].to(x.dtype)
    sin = tables[1].to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
