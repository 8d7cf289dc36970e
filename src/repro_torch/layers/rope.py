"""Rotary position embeddings (half-split convention), counterpart of
``repro.layers.rope`` without M-RoPE."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _inv_freq(dim: int, theta: float, device: str) -> torch.Tensor:
    """theta^-(2i/dim), f32 [dim//2] on ``device``: computed there once per
    (dim, theta), so a forward copies nothing from the host (a CUDA graph
    of the decode step captures no host-to-device copy)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_tables(positions: torch.Tensor, dim: int, theta: float = 1e4):
    """(cos, sin) f32 [B, S, 1, dim//2] from positions [B, S]; computed
    once per forward and shared by q/k and every layer."""
    inv = _inv_freq(dim, float(theta), str(positions.device))
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
