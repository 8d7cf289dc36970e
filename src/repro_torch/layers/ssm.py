"""Mamba2 (SSD) mixer (counterpart of ``repro.layers.ssm``): a chunked
parallel scan for prefill and a single-step state update for decode. The
static projections run through ``linear_apply`` (the backends' kernels);
the recurrence is torch ops, as the reference computes it in jnp.

The reference's call sites pass no ``name`` to ``linear_apply``, so no
Mamba linear is tapped or calibrated: under ``cim`` they stay float and
run on the digital MXFP4 W+A path (``mxfp4_ste``), as in the reference.
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
)
from repro_torch.layers.ffn import _silu


@dataclasses.dataclass(frozen=True)
class MambaStatic:
    d_model: int
    n_heads: int
    head_dim: int  # P
    d_state: int  # N
    n_groups: int = 1
    conv_k: int = 4
    chunk: int = 256
    norm: str = "rmsnorm"

    @property
    def d_inner(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba_init(gen: torch.Generator, cfg: MambaStatic) -> dict:
    """The reference's init laws: ``conv_w ~ N(0, 1/k)``, ``A_log =
    log(linspace(1, 16, h))`` (A = -exp(A_log)), ``D = 1``, ``dt_bias =
    0``."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    gn = cfg.n_groups * cfg.d_state
    dev, f32 = gen.device, torch.float32
    p = {"ln": norm_init(cfg.norm, d, dev)}
    p["in_proj"] = linear_init(gen, d, 2 * di + 2 * gn + h)
    p["conv_w"] = torch.randn((cfg.conv_dim, cfg.conv_k), generator=gen,
                              dtype=f32, device=dev) * (1.0 / cfg.conv_k) ** 0.5
    p["conv_b"] = torch.zeros((cfg.conv_dim,), dtype=f32, device=dev)
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev))
    p["D"] = torch.ones((h,), dtype=f32, device=dev)
    p["dt_bias"] = torch.zeros((h,), dtype=f32, device=dev)
    p["gn"] = norm_init("rmsnorm", di, dev)
    p["out_proj"] = linear_init(gen, di, d)
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as jnp writes it,
    max + log1p(exp(-|x - 0|)), op by op."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def cumsum(x: torch.Tensor, dim: int, base: int = 16) -> torch.Tensor:
    """Inclusive sum along ``dim`` in the order XLA's CPU backend adds a
    ``jnp.cumsum`` (its reduce-window rewrite): left to right within
    blocks of ``base``, the blocks' totals summed the same way
    (recursively), and each block's exclusive carry added to its sums.
    The decay factors exp(cumsum_i - cumsum_j) amplify a rounding of the
    sum, so the order is the reference's."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    pad = 0 if n <= base else (-n) % base
    xb = F.pad(x, (0, pad)).reshape(x.shape[:-1] + (-1, min(n, base)))
    acc = [xb[..., 0]]
    for i in range(1, xb.shape[-1]):
        acc.append(acc[-1] + xb[..., i])
    y = torch.stack(acc, dim=-1)  # [..., blocks, base]
    if y.shape[-2] > 1:
        carry = cumsum(y[..., -1], -1, base)
        y = y + F.pad(carry[..., :-1], (1, 0))[..., None]
    y = y.reshape(x.shape[:-1] + (-1,))[..., :n]
    return torch.movedim(y, -1, dim)


def _repeat(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(x, rep, axis=dim)`` (each entry ``rep`` times in a
    row) as a broadcast, with no data-dependent output size."""
    shape = x.shape
    x = x.unsqueeze(dim + 1).expand(shape[:dim + 1] + (rep,)
                                    + shape[dim + 1:])
    return x.reshape(shape[:dim] + (shape[dim] * rep,) + shape[dim + 1:])


def _split_zxbcdt(cfg: MambaStatic, zxbcdt: torch.Tensor):
    di, gn, h = cfg.d_inner, cfg.n_groups * cfg.d_state, cfg.n_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    assert dt.shape[-1] == h
    return z, xbc, dt


def _conv1d(cfg: MambaStatic, p: dict, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over [B, S, C], the taps added in the
    reference's order (0 + tap 0 + ... + tap k-1), then SiLU."""
    k = cfg.conv_k
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * p["conv_w"][:, i]
              for i in range(k))
    return _silu(out + p["conv_b"].to(out.dtype))


def _ssd_chunked(x, dt, a, bm, cm, chunk: int):
    """x [B,S,H,P], dt [B,S,H], a [H] (< 0), bm / cm [B,S,G,N]. Returns
    y [B,S,H,P] and the final state [B,H,P,N] (f32)."""
    b, s, h, pp = x.shape
    n, g = bm.shape[-1], bm.shape[-2]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    c = sp // q
    rep = h // g
    f32 = torch.float32
    xc = x.reshape(b, c, q, h, pp).to(f32)
    dtc = dt.reshape(b, c, q, h).to(f32)
    bc = _repeat(bm.reshape(b, c, q, g, n), rep, 3).to(f32)
    cc = _repeat(cm.reshape(b, c, q, g, n), rep, 3).to(f32)

    dta = dtc * a  # [b,c,q,h] (<= 0)
    csh = cumsum(dta, 2).permute(0, 1, 3, 2)  # [b,c,h,q]
    xd = xc * dtc[..., None]

    # intra-chunk (attention-like, with the decay mask); masked before exp
    # as in the reference (the i < j half would overflow)
    diff = csh[..., :, None] - csh[..., None, :]  # [b,c,h,i,j]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ll = torch.exp(torch.where(tri, diff, float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bchij", cc, bc)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", cb * ll, xd)

    # chunk states
    decay_end = torch.exp(csh[..., -1:] - csh)  # [b,c,h,q]
    states = torch.einsum("bcqhn,bchq,bcqhp->bchpn", bc, decay_end, xd)
    chunk_decay = torch.exp(csh[..., -1])  # [b,c,h]

    s_prev = torch.zeros((b, h, pp, n), dtype=f32, device=x.device)
    s_prevs = []
    for i in range(c):  # the reference's lax.scan over chunks
        s_prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, i, :, None, None] + states[:, i]
    s_prevs = torch.stack(s_prevs, dim=1)  # [b,c,h,p,n] entering each chunk

    decay_in = torch.exp(csh)  # [b,c,h,q]
    y_inter = torch.einsum("bcqhn,bchq,bchpn->bcqhp", cc, decay_in, s_prevs)
    y = (y_intra + y_inter).reshape(b, sp, h, pp)[:, :s]
    return y, s_prev


def mamba_apply(ctx: RunCtx, cfg: MambaStatic, p: dict, x: torch.Tensor,
                cache: dict | None = None):
    """Pre-norm Mamba2 sublayer with residual. Returns (y, new_cache):

    - prefill (``cache=None``): the chunked scan, no cache;
    - prefill into a cache (``cache`` + S > 1): the chunked scan, and the
      cache's conv tail (the last k-1 raw conv inputs) and final state;
    - decode (``cache`` + S == 1): one state update.

    The new cache is new tensors; ``cache`` is left as it is."""
    b, s, _ = x.shape
    h, pp, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    f32 = torch.float32
    xn = norm_apply(cfg.norm, p["ln"], x)
    zxbcdt = linear_apply(ctx, p["in_proj"], xn)
    z, xbc, dt = _split_zxbcdt(cfg, zxbcdt)
    a = -torch.exp(p["A_log"])  # [h]
    dtv = softplus(dt.to(f32) + p["dt_bias"])

    if cache is None or s > 1:
        xbc_raw = xbc
        xbc = _conv1d(cfg, p, xbc)
        xin = xbc[..., :cfg.d_inner].reshape(b, s, h, pp)
        bm = xbc[..., cfg.d_inner:cfg.d_inner + g * n].reshape(b, s, g, n)
        cm = xbc[..., cfg.d_inner + g * n:].reshape(b, s, g, n)
        y, s_final = _ssd_chunked(xin, dtv, a, bm, cm, cfg.chunk)
        new_cache = None
        if cache is not None:  # prefill-into-cache handoff
            kk = cfg.conv_k - 1
            tail = xbc_raw[:, -kk:].to(f32)
            if s < kk:
                tail = F.pad(tail, (0, 0, kk - s, 0))
            new_cache = {"conv": tail.transpose(1, 2), "state": s_final}
    else:
        # single-step decode: x [b, 1, d]
        win = torch.cat([cache["conv"], xbc.to(f32).transpose(1, 2)],
                        dim=-1)  # [b, convdim, k]
        conv_out = _silu(torch.sum(win * p["conv_w"][None], dim=-1)
                         + p["conv_b"])  # [b, convdim]
        new_conv = win[..., 1:]
        xin = conv_out[:, :cfg.d_inner].reshape(b, h, pp)
        bm = conv_out[:, cfg.d_inner:cfg.d_inner + g * n].reshape(b, g, n)
        cm = conv_out[:, cfg.d_inner + g * n:].reshape(b, g, n)
        bh = _repeat(bm, h // g, 1)
        ch = _repeat(cm, h // g, 1)
        dt1 = dtv[:, 0]  # [b, h]
        da = torch.exp(dt1 * a)  # [b, h]
        xd = xin * dt1[..., None]
        st = (cache["state"] * da[..., None, None]
              + torch.einsum("bhp,bhn->bhpn", xd, bh))
        y = torch.einsum("bhn,bhpn->bhp", ch, st)[:, None]  # [b,1,h,p]
        new_cache = {"conv": new_conv, "state": st}

    y = y + xin.reshape(y.shape) * p["D"][:, None]
    y = y.reshape(b, s, cfg.d_inner)
    y = norm_apply("rmsnorm", p["gn"], y * _silu(z.to(f32)))
    out = linear_apply(ctx, p["out_proj"], y.to(torch.bfloat16))
    return x + out.to(x.dtype), new_cache


def mamba_cache_init(cfg: MambaStatic, batch: int, device=None) -> dict:
    """Zero conv tail [B, conv_dim, k-1] and state [B, H, P, N] (f32) on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.conv_dim, cfg.conv_k - 1), dtype=f32,
                            device=dev),
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                             dtype=f32, device=dev),
    }


MAMBA_CACHE_SPECS = {
    "conv": ("batch", "mlp", "conv"),
    "state": ("batch", "state_heads", "head_dim", "state"),
}
