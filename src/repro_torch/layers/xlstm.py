"""xLSTM blocks (counterpart of ``repro.layers.xlstm``): mLSTM (matrix
memory, exponential gating; chunkwise-parallel prefill, one step a
decode) and sLSTM (scalar memory, block-diagonal recurrence, then a GeGLU
FFN). The static projections run through ``linear_apply``; the
recurrences are torch ops, as the reference computes them in jnp.

The reference's call sites pass no ``name`` to ``linear_apply``, so no
xLSTM linear is calibrated: under ``cim`` they stay float and run on the
digital MXFP4 W+A path. mLSTM's ``wv`` is initialised but never applied
(``v`` is the up-projection's first half), as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.layers.common import (
    RunCtx,
    linear_apply,
    linear_init,
    norm_apply,
    norm_init,
    rmsnorm_apply,
)
from repro_torch.layers.ffn import _gelu_tanh, _silu
from repro_torch.layers.ssm import cumsum, softplus


@dataclasses.dataclass(frozen=True)
class XLSTMStatic:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0  # mLSTM up-projection factor
    conv_k: int = 4
    norm: str = "rmsnorm"
    ffn_factor: float = 4.0 / 3.0  # sLSTM post-FFN

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def s_head_dim(self) -> int:
        return self.d_model // self.n_heads


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (``lax.logistic``) as XLA expands it."""
    return 1 / (1 + torch.exp(-x))


# ------------------------------------------------------------------ mLSTM

def mlstm_init(gen: torch.Generator, cfg: XLSTMStatic) -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    dev, f32 = gen.device, torch.float32
    p = {"ln": norm_init(cfg.norm, d, dev)}
    p["w_up"] = linear_init(gen, d, 2 * di)
    p["conv_w"] = torch.randn((di, cfg.conv_k), generator=gen, dtype=f32,
                              device=dev) * 0.5
    p["conv_b"] = torch.zeros((di,), dtype=f32, device=dev)
    p["wq"] = linear_init(gen, di, di)
    p["wk"] = linear_init(gen, di, di)
    p["wv"] = linear_init(gen, di, di)
    p["w_if"] = linear_init(gen, di, 2 * h)
    p["gn"] = norm_init("rmsnorm", di, dev)
    p["skip"] = torch.ones((di,), dtype=f32, device=dev)
    p["w_down"] = linear_init(gen, di, d)
    return p


def _mlstm_step(carry, inp, scale: float):
    """One stabilised mLSTM step. carry (C [b,h,dk,dv], n [b,h,dk], m
    [b,h]), inp (q, k, v [b,h,d], i~ and log f [b,h])."""
    cm, nm, mm = carry
    q, k, v, ig, fg = inp
    m_new = torch.maximum(fg + mm, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(fg + mm - m_new)
    cm = (f_p[..., None, None] * cm
          + i_p[..., None, None] * (k[..., :, None] * v[..., None, :]))
    nm = f_p[..., None] * nm + i_p[..., None] * k
    hn = torch.einsum("bhkv,bhk->bhv", cm, q) * scale
    dn = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", nm, q)
                                   * scale), 1.0)
    return (cm, nm, m_new), hn / dn[..., None]


def _mlstm_chunkwise(qf, kf, vf, ig, fg, init, scale: float,
                     chunk: int = 64):
    """Chunkwise-parallel stabilised mLSTM, the function of scanning
    :func:`_mlstm_step`: the running stabiliser is m_t = F_t + G_t with
    F_t = cumsum(log f) and G_t = max(m_prev, cummax(i~_j - F_j)), so each
    chunk is two masked products and a state update. qf / kf / vf [b,s,h,d]
    (kf pre-scaled), ig / fg [b,s,h]; init (C, n, m). Returns (h
    [b,s,h,dv], (C, n, m) final)."""
    b, s, h, _ = qf.shape
    ll = min(chunk, s)
    pad = (-s) % ll
    if pad:
        qf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        ig = F.pad(ig, (0, 0, 0, pad), value=-1e30)  # no input
        fg = F.pad(fg, (0, 0, 0, pad))  # log f = 0: no decay
    nc = (s + pad) // ll
    tri = torch.tril(torch.ones((ll, ll), dtype=torch.bool,
                                device=qf.device))[None, :, :, None]
    c_prev, n_prev, m_prev = init
    outs = []
    for c in range(nc):  # the reference's lax.scan over chunks
        sl = slice(c * ll, (c + 1) * ll)
        q, k, v, igc, fgc = qf[:, sl], kf[:, sl], vf[:, sl], ig[:, sl], \
            fg[:, sl]
        f_cum = cumsum(fgc, 1)  # [b,L,h]
        u = igc - f_cum
        g = torch.maximum(m_prev[:, None], torch.cummax(u, dim=1).values)
        dlog = u[:, None, :, :] - g[:, :, None, :]  # [b,i,j,h]
        w = torch.exp(torch.where(tri, dlog, float("-inf")))
        sij = torch.einsum("bihd,bjhd->bijh", q, k)
        sw = sij * w
        num = torch.einsum("bijh,bjhd->bihd", sw, v)
        den = torch.sum(sw, dim=2)  # [b,i,h]
        c_i = torch.exp(m_prev[:, None] - g)  # [b,L,h]
        num = num + c_i[..., None] * torch.einsum("bhkv,bihk->bihv", c_prev,
                                                  q)
        den = den + c_i * torch.einsum("bhk,bihk->bih", n_prev, q)
        outs.append(num * scale
                    / torch.clamp_min(torch.abs(den * scale), 1.0)[..., None])
        # end-of-chunk state
        g_l = g[:, -1]  # [b,h]
        wj = torch.exp(u - g_l[:, None])  # [b,L,h]
        cc = torch.exp(m_prev - g_l)
        c_prev = cc[..., None, None] * c_prev + torch.einsum(
            "bjh,bjhd,bjhe->bhde", wj, k, v)
        n_prev = cc[..., None] * n_prev + torch.einsum("bjh,bjhd->bhd", wj, k)
        m_prev = f_cum[:, -1] + g_l
    hout = torch.cat(outs, dim=1)[:, :s]
    return hout, (c_prev, n_prev, m_prev)


def _causal_conv(cfg: XLSTMStatic, p: dict, xi: torch.Tensor, cache):
    """The mLSTM's causal depthwise conv (no activation) and the new conv
    tail: prefill over [B, S, di] (taps added in the reference's order),
    or one step from ``cache["conv"]``."""
    kk = cfg.conv_k
    s = xi.shape[1]
    if cache is None or s > 1:
        padded = F.pad(xi, (0, 0, kk - 1, 0))
        conv = sum(padded[:, i:i + s, :] * p["conv_w"][:, i]
                   for i in range(kk))
        tail = xi[:, -(kk - 1):].to(torch.float32)
        if s < kk - 1:
            tail = F.pad(tail, (0, 0, kk - 1 - s, 0))
        return conv, tail.transpose(1, 2) if cache is not None else None
    win = torch.cat([cache["conv"], xi.to(torch.float32).transpose(1, 2)],
                    dim=-1)
    return torch.sum(win * p["conv_w"][None], dim=-1)[:, None], win[..., 1:]


def mlstm_apply(ctx: RunCtx, cfg: XLSTMStatic, p: dict, x: torch.Tensor,
                cache: dict | None = None):
    """Pre-norm mLSTM block with residual. Returns (y, new_cache): no
    cache without ``cache``; prefill into a cache (S > 1) runs the
    chunkwise form from the cache's state; decode (S == 1) one step. The
    new cache is new tensors."""
    b, s, _ = x.shape
    h, dk, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    f32 = torch.float32
    xn = norm_apply(cfg.norm, p["ln"], x)
    up = linear_apply(ctx, p["w_up"], xn)
    xi, z = up[..., :di], up[..., di:]

    prefill = cache is None or s > 1
    conv, new_conv = _causal_conv(cfg, p, xi, cache)
    conv = _silu(conv + p["conv_b"].to(conv.dtype))

    q = linear_apply(ctx, p["wq"], conv).reshape(b, s, h, dk)
    k = linear_apply(ctx, p["wk"], conv).reshape(b, s, h, dk)
    v = xi.reshape(b, s, h, dk)
    gates = linear_apply(ctx, p["w_if"], conv).to(f32)
    ig, fg = gates[..., :h], log_sigmoid(gates[..., h:])
    scale = dk ** -0.5

    qf = q.to(f32)
    kf = k.to(f32) * scale
    vf = v.to(f32)
    if prefill:
        if cache is not None:
            init = (cache["C"], cache["n"], cache["m"])
        else:  # the reference starts a cacheless prefill's m at -1e30
            init = (torch.zeros((b, h, dk, dk), dtype=f32, device=x.device),
                    torch.zeros((b, h, dk), dtype=f32, device=x.device),
                    torch.full((b, h), -1e30, dtype=f32, device=x.device))
        ht, (cmf, nmf, mmf) = _mlstm_chunkwise(qf, kf, vf, ig, fg, init,
                                               scale)
        new_cache = None
        if cache is not None:
            new_cache = {"conv": new_conv, "C": cmf, "n": nmf, "m": mmf}
    else:
        carry = (cache["C"], cache["n"], cache["m"])
        carry, h1 = _mlstm_step(
            carry, (qf[:, 0], kf[:, 0], vf[:, 0], ig[:, 0], fg[:, 0]), scale)
        ht = h1[:, None]
        new_cache = {"conv": new_conv, "C": carry[0], "n": carry[1],
                     "m": carry[2]}

    hflat = ht.reshape(b, s, di)
    hflat = rmsnorm_apply(p["gn"], hflat) + p["skip"] * conv.to(f32)
    out = hflat.to(torch.bfloat16) * _silu(z)
    y = linear_apply(ctx, p["w_down"], out)
    return x + y.to(x.dtype), new_cache


def mlstm_cache_init(cfg: XLSTMStatic, batch: int, device=None) -> dict:
    """Zero conv tail, C and n; m at -inf (the reference's)."""
    dev = resolve_device(device)
    h, dk, f32 = cfg.n_heads, cfg.head_dim, torch.float32
    return {
        "conv": torch.zeros((batch, cfg.d_inner, cfg.conv_k - 1), dtype=f32,
                            device=dev),
        "C": torch.zeros((batch, h, dk, dk), dtype=f32, device=dev),
        "n": torch.zeros((batch, h, dk), dtype=f32, device=dev),
        "m": torch.full((batch, h), float("-inf"), dtype=f32, device=dev),
    }


MLSTM_CACHE_SPECS = {
    "conv": ("batch", "mlp", "conv"),
    "C": ("batch", "state_heads", None, None),
    "n": ("batch", "state_heads", None),
    "m": ("batch", "state_heads"),
}


# ------------------------------------------------------------------ sLSTM

def slstm_init(gen: torch.Generator, cfg: XLSTMStatic) -> dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.s_head_dim
    dev = gen.device
    p = {"ln": norm_init(cfg.norm, d, dev)}
    p["w_in"] = linear_init(gen, d, 4 * d)
    p["r"] = torch.randn((h, dh, 4 * dh), generator=gen, dtype=torch.float32,
                         device=dev) * dh ** -0.5
    p["gn"] = norm_init("rmsnorm", d, dev)
    dff = int(d * cfg.ffn_factor)
    p["w_up"] = linear_init(gen, d, 2 * dff)
    p["w_down"] = linear_init(gen, dff, d)
    return p


def _slstm_step(carry, wx_t, r):
    """One sLSTM step; carry (c, n, m, h) [b,h,dh] each, wx_t [b,h,4dh],
    r [h,dh,4dh] (a bf16 ``r`` of a converted tree joins the f32 product
    as f32, as JAX promotes it)."""
    c, n, m, hp = carry
    rec = torch.einsum("bhd,hde->bhe", hp, r.to(torch.float32))
    pre = wx_t + rec
    zi, ii, ff, oo = torch.chunk(pre, 4, dim=-1)
    ff = log_sigmoid(ff)
    m_new = torch.maximum(ff + m, ii)
    i_p = torch.exp(ii - m_new)
    f_p = torch.exp(ff + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(zi)
    n_new = f_p * n + i_p
    h_new = _sigmoid(oo) * c_new / torch.clamp_min(n_new, 1.0)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_apply(ctx: RunCtx, cfg: XLSTMStatic, p: dict, x: torch.Tensor,
                cache: dict | None = None):
    """Pre-norm sLSTM block with residual, then its GeGLU FFN (pf 4/3)
    with residual. Returns (y, new_cache); the new cache is new
    tensors."""
    b, s, d = x.shape
    h, dh = cfg.n_heads, cfg.s_head_dim
    f32 = torch.float32
    xn = norm_apply(cfg.norm, p["ln"], x)
    wx = linear_apply(ctx, p["w_in"], xn).to(f32).reshape(b, s, h, 4 * dh)

    if cache is None:
        z0 = torch.zeros((b, h, dh), dtype=f32, device=x.device)
        carry = (z0, z0, torch.full((b, h, dh), float("-inf"), dtype=f32,
                                    device=x.device), z0)
    else:
        carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    hs = []
    for t in range(s):  # the reference's lax.scan over time
        carry, h_t = _slstm_step(carry, wx[:, t], p["r"])
        hs.append(h_t)
    ht = torch.stack(hs, dim=1).reshape(b, s, d)
    new_cache = None
    if cache is not None:
        new_cache = {"c": carry[0], "n": carry[1], "m": carry[2],
                     "h": carry[3]}

    x = x + rmsnorm_apply(p["gn"], ht).to(x.dtype)
    up = linear_apply(ctx, p["w_up"], x)
    dff = up.shape[-1] // 2
    y2 = linear_apply(ctx, p["w_down"], _gelu_tanh(up[..., :dff])
                      * up[..., dff:])
    return x + y2.to(x.dtype), new_cache


def slstm_cache_init(cfg: XLSTMStatic, batch: int, device=None) -> dict:
    """Zero c, n and h; m at -inf (the reference's)."""
    dev = resolve_device(device)
    shape, f32 = (batch, cfg.n_heads, cfg.s_head_dim), torch.float32
    z = torch.zeros(shape, dtype=f32, device=dev)
    return {"c": z, "n": z.clone(),
            "m": torch.full(shape, float("-inf"), dtype=f32, device=dev),
            "h": z.clone()}


SLSTM_CACHE_SPECS = {
    "c": ("batch", "state_heads", None),
    "n": ("batch", "state_heads", None),
    "m": ("batch", "state_heads", None),
    "h": ("batch", "state_heads", None),
}
