"""Plain PyTorch version of the flash-attention kernel: the naive softmax
attention oracle of ``repro.kernels.flash_attention.ref``, in f32, with
causal and sliding-window masks relative to ``q_offset`` and GQA."""

from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D], k / v [B, Sk, Hkv, D] -> [B, Sq, H, D] in q's
    dtype. A query row with no visible key yields zeros."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * d ** -0.5
    qp = torch.arange(sq, device=q.device) + q_offset
    kp = torch.arange(sk, device=q.device)
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kp[None, :] <= qp[:, None]
    if window > 0:
        m &= kp[None, :] > qp[:, None] - window
    s = torch.where(m, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(b, sq, h, d).to(q.dtype)
