"""Digital-stage numerics (paper §4.4-4.5): MXFP4 systolic attention with
BF16 accumulation and a FlashAttention-style deferred softmax
(counterpart of ``repro.core.digital``).

This is the numerics simulator of fidelity experiments, kept apart from
the model's digital SDPA (``layers/attention.py``) and its kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core import mx as mxlib


def mx_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = False, tile: int = 64,
                 quantize_sv: bool = True) -> torch.Tensor:
    """Scaled dot-product attention on the paper's digital datapath.

    q, k, v: [..., S, D] (per head). Q and K are MXFP4-quantized along D
    (the QK^T contraction); the scores round to bf16; softmax streams over
    key tiles of ``tile`` with a running max and sum (division deferred to
    the end); each probability tile and V (along S, the SV contraction)
    are re-quantized to MXFP4 before the SV product. Returns bf16."""
    dk = q.shape[-1]
    qq = mxlib.fake_quant(q.to(torch.float32))
    kq = mxlib.fake_quant(k.to(torch.float32))
    s = torch.einsum("...qd,...kd->...qk", qq, kq).to(torch.bfloat16)
    s = (s.to(torch.float32) * dk ** -0.5).to(torch.bfloat16)
    sl = s.shape[-1]
    if causal:
        ii = torch.arange(s.shape[-2], device=s.device)[:, None]
        jj = torch.arange(sl, device=s.device)[None, :]
        s = torch.where(jj <= ii, s, torch.tensor(-torch.inf,
                                                  dtype=torch.bfloat16,
                                                  device=s.device))
    pad = (-sl) % tile
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf)
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    nt = s.shape[-1] // tile
    st = s.reshape(s.shape[:-1] + (nt, tile)).to(torch.float32)
    vt = v.reshape(v.shape[:-2] + (nt, tile, v.shape[-1])).to(torch.float32)
    m = torch.full(st.shape[:-2], -torch.inf, dtype=torch.float32,
                   device=s.device)
    acc = torch.zeros(st.shape[:-2] + (v.shape[-1],), dtype=torch.float32,
                      device=s.device)
    den = torch.zeros(st.shape[:-2], dtype=torch.float32, device=s.device)
    for t in range(nt):
        sc = st[..., t, :]
        m_new = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(torch.isfinite(sc), p, 0.0)
        vtile = vt[..., t, :, :]
        if quantize_sv:
            p = mxlib.fake_quant(p)
            vtile = mxlib.fake_quant_axis(vtile, -2)
        pv = torch.einsum("...qk,...kd->...qd", p, vtile)
        acc = acc * corr[..., None] + pv
        den = den * corr + p.sum(dim=-1)
        m = m_new
    den = torch.where(den == 0.0, 1.0, den)
    return (acc / den[..., None]).to(torch.bfloat16)  # deferred division


def attention_ref(q, k, v, causal: bool = False) -> torch.Tensor:
    """Full-precision oracle (f32)."""
    dk = q.shape[-1]
    s = torch.einsum("...qd,...kd->...qk", q, k).to(torch.float32) \
        * dk ** -0.5
    if causal:
        ii = torch.arange(s.shape[-2], device=s.device)[:, None]
        jj = torch.arange(s.shape[-1], device=s.device)[None, :]
        s = torch.where(jj <= ii, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v.to(torch.float32))
