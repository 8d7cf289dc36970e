"""Rotary position embeddings (half-split convention) and Qwen2-VL's
multimodal M-RoPE, counterpart of ``repro.layers.rope``."""

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


@functools.lru_cache(maxsize=None)
def _mrope_component(sections: tuple, device: str) -> torch.Tensor:
    """int64 [sum(sections)]: the position component (0, 1, 2) that drives
    each frequency band; made on ``device`` once per sections, so a
    captured step copies nothing from the host."""
    return torch.repeat_interleave(torch.arange(3),
                                   torch.tensor(sections)).to(device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x [B, S, H, D]; positions [3, B, S]
    (temporal, height, width position ids); ``sections`` split the D//2
    frequencies among the three components, in order."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {d // 2}")
    dev = str(positions.device)
    inv = _inv_freq(d, float(theta), dev)
    ang3 = positions.to(torch.float32)[..., None] * inv  # [3, B, S, d//2]
    comp = _mrope_component(tuple(sections), dev)
    ang = torch.gather(torch.movedim(ang3, 0, -1), -1,
                       comp.expand(ang3.shape[1:-1] + (d // 2,))[..., None]
                       )[..., 0]  # [B, S, d//2]
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE position ids: all three components equal."""
    return positions[None].expand((3,) + tuple(positions.shape))
