"""Grouped-query attention with RoPE, the digital MXFP4 SDPA helpers and
the fused paged KV cache (counterpart of ``repro.layers.attention``).

Ported branches of :func:`attn_apply`: prefill without a cache, prefill
into a fused or a legacy split cache, chunked prefill into a fused page,
the fused paged decode, over float pages or (under a digital-SDPA
backend) the quantized-resident mirrors, and the legacy decode (torch
ops, as the reference's einsums), at a scalar or per-lane position, float
or on the digital MXFP4 SDPA from the resident mirrors or by
requantizing the cache each step. Prefill past ``RunCtx.dense_attn_max``
takes the online-softmax ``_flash_attn``; on CUDA, without the digital
SDPA, that is the ``flash_attention`` kernel. Chunked prefill runs into
a fused page or a legacy split page (the engine's two layouts).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import mx as mxlib
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import layout as paged_layout
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.layers import rope as ropelib
from repro_torch.layers.common import (
    RunCtx,
    init_device,
    linear_apply,
    linear_init,
    linear_specs,
    norm_apply,
    norm_init,
    norm_specs,
    rmsnorm_apply,
)


@dataclasses.dataclass(frozen=True)
class AttnStatic:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    causal: bool = True
    window: int = 0  # 0 = full attention; >0 = sliding window
    rope_theta: float = 1e4
    use_rope: bool = True
    mrope: bool = False
    qk_norm: bool = False
    use_bias: bool = False
    norm: str = "rmsnorm"
    softmax_scale: float | None = None

    @property
    def scale(self) -> float:
        return (self.head_dim ** -0.5 if self.softmax_scale is None
                else self.softmax_scale)


def attn_init(gen: torch.Generator, cfg: AttnStatic, device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dev = init_device(gen, device)
    p = {"ln": norm_init(cfg.norm, d, dev)}
    p["wq"] = linear_init(gen, d, h * hd, use_bias=cfg.use_bias, device=dev)
    p["wk"] = linear_init(gen, d, kv * hd, use_bias=cfg.use_bias, device=dev)
    p["wv"] = linear_init(gen, d, kv * hd, use_bias=cfg.use_bias, device=dev)
    p["wo"] = linear_init(gen, h * hd, d, use_bias=cfg.use_bias, device=dev)
    if cfg.qk_norm:
        p["qn"] = norm_init("rmsnorm", hd, dev)
        p["kn"] = norm_init("rmsnorm", hd, dev)
    return p


def attn_specs(cfg: AttnStatic) -> dict:
    """Logical axes of :func:`attn_init`'s leaves (the reference's)."""
    b = cfg.use_bias
    s = {"ln": norm_specs(cfg.norm),
         "wq": linear_specs("embed", "qkv_fused", use_bias=b),
         "wk": linear_specs("embed", "kv_fused", use_bias=b),
         "wv": linear_specs("embed", "kv_fused", use_bias=b),
         "wo": linear_specs("qkv_fused", "embed", use_bias=b)}
    if cfg.qk_norm:
        s["qn"] = norm_specs("rmsnorm")
        s["kn"] = norm_specs("rmsnorm")
    return s


# Sentinel position of padded K/V entries (fixed-shape serving prefill):
# keys at or below the threshold never attend.
KV_PAD = -(10**9)
_KV_PAD_MIN = KV_PAD // 2


def _mask(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """bool [..., Sq, Sk]; True = attend. Keys at KV_PAD never attend."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.broadcast_to(kp > _KV_PAD_MIN,
                           torch.broadcast_shapes(qp.shape, kp.shape))
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return m


# Digital MXFP4 systolic SDPA quantization (paper §4.4-4.5).

def _mx_fq(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bfloat16:
        return mxlib.fake_quant(t)
    return mxlib.fake_quant(t.to(torch.float32))


def _mx_qk(q, k):
    """Quantize Q/K along the head_dim contraction (last axis)."""
    return _mx_fq(q), _mx_fq(k)


def _mx_score_round(s: torch.Tensor) -> torch.Tensor:
    """BF16 systolic accumulator round of the QK^T scores."""
    return s.to(torch.bfloat16).to(torch.float32)


def _mx_p(p: torch.Tensor):
    """Quantize P along the key axis + the hardware normalizer sum."""
    p = mxlib.fake_quant(p)
    den = p.sum(-1, keepdim=True)
    return p, torch.where(den == 0.0, 1.0, den)


def _mx_pv(p, v):
    """Re-quantize P (last axis) and V (key axis 1) before the SV array;
    outputs are divided by ``den``, the sum of the quantized P."""
    p, den = _mx_p(p)
    vq = (mxlib.fake_quant_axis(v, 1) if v.dtype == torch.bfloat16
          else mxlib.fake_quant_axis(v.to(torch.float32), 1))
    return p, vq, den


# Quantized-resident mirrors of the legacy split cache (digital-SDPA
# decode): K codes [B, W, Hkv, Dh_pad] quantized along head_dim (exps
# [B, W, Hkv, Dh_pad // 32]); V codes [B, Hkv, Dh, W_pad] with the key
# axis last (exps [B, Hkv, Dh, W_pad // 32]). A decode step re-quantizes
# the written K row and the active 32-block of V only, bitwise a full
# requant of the cache.

def _quant_cache_sizes(w: int, hd: int) -> tuple[int, int]:
    dpad = -(-hd // mxlib.BLOCK) * mxlib.BLOCK
    wpad = -(-w // mxlib.BLOCK) * mxlib.BLOCK
    return dpad, wpad


def quant_cache_init(batch: int, w: int, n_kv: int, hd: int,
                     device=None) -> dict:
    """Mirrors of a zero K/V cache: zero codes, E8M0 floor exponents."""
    dev = resolve_device(device)
    dpad, wpad = _quant_cache_sizes(w, hd)
    i8 = torch.int8
    return {
        "k_codes": torch.zeros((batch, w, n_kv, dpad), dtype=i8, device=dev),
        "k_exps": torch.full((batch, w, n_kv, dpad // mxlib.BLOCK),
                             mxlib.E8M0_MIN, dtype=i8, device=dev),
        "v_codes": torch.zeros((batch, n_kv, hd, wpad), dtype=i8, device=dev),
        "v_exps": torch.full((batch, n_kv, hd, wpad // mxlib.BLOCK),
                             mxlib.E8M0_MIN, dtype=i8, device=dev),
    }


def _quant_cache_full(kw: torch.Tensor, vw: torch.Tensor) -> dict:
    """Quantize a whole cache-shaped K/V pair (prefill into a cache): K a
    row along head_dim, V along the key axis in 32-blocks."""
    kq = mxlib.quantize(kw.to(torch.float32))
    vq = mxlib.quantize_axis(vw.to(torch.float32), 1)  # key axis last
    return {"k_codes": kq.codes, "k_exps": kq.exps,
            "v_codes": vq.codes, "v_exps": vq.exps}


def _quant_cache_step(cache: dict, ck: torch.Tensor, cv: torch.Tensor,
                      lanes: torch.Tensor, slot: torch.Tensor) -> None:
    """In-place per-step update of the mirrors in ``cache`` from the
    just-written raw caches ``ck`` / ``cv``: the written K row of each
    lane and the V block holding its slot (a partial end block reads 0
    past the cache), the reference's ``_quant_cache_step``."""
    b, w = cv.shape[0], cv.shape[1]
    kq = mxlib.quantize(ck[lanes, slot].to(torch.float32))  # [B, Hkv, *]
    cache["k_codes"][lanes, slot] = kq.codes
    cache["k_exps"][lanes, slot] = kq.exps
    start = (slot // mxlib.BLOCK) * mxlib.BLOCK  # [B]
    idx = start[:, None] + torch.arange(mxlib.BLOCK, device=cv.device)
    blk = cv[lanes[:, None], torch.clamp(idx, max=w - 1)]  # [B, 32, Hkv, Dh]
    blk = torch.where((idx < w)[:, :, None, None], blk,
                      torch.zeros((), dtype=blk.dtype, device=blk.device))
    vq = mxlib.quantize_axis(blk.to(torch.float32), 1)  # [B, Hkv, Dh, 32]
    vc = cache["v_codes"]
    cache["v_codes"].scatter_(
        3, idx[:, None, None, :].expand(b, vc.shape[1], vc.shape[2],
                                        mxlib.BLOCK), vq.codes)
    ve = cache["v_exps"]
    cache["v_exps"].scatter_(
        3, (slot // mxlib.BLOCK)[:, None, None, None].expand(
            b, ve.shape[1], ve.shape[2], 1), vq.exps)


def _dense_attn(q, k, v, q_pos, k_pos, cfg: AttnStatic,
                mx_digital: bool = False) -> torch.Tensor:
    """q [B,Sq,Hkv,G,Dh]; k,v [B,Sk,Hkv,Dh]. With ``mx_digital`` the SDPA
    runs on the digital MXFP4 systolic datapath: Q/K quantized along
    head_dim, BF16 score round, P/V re-quantized along the key axis,
    division by the quantized-P sum after the SV product. bf16 operands
    with f32 accumulation are computed as f32 products of the (exactly
    bf16-valued) operands."""
    if mx_digital:
        q, k = _mx_qk(q, k)
        q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * cfg.scale
    if mx_digital:
        s = _mx_score_round(s)
    m = _mask(q_pos, k_pos, cfg.causal, cfg.window)[:, None, None]
    s = torch.where(m, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isfinite(s).any(-1, keepdim=True), p, 0.0)
    if mx_digital:
        p, v, den = _mx_pv(p, v)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.bfloat16).float(),
                         v.to(torch.bfloat16).float())
        o = o / torch.movedim(den, -2, 1)
        return o.to(torch.bfloat16)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _qkv(ctx: RunCtx, cfg: AttnStatic, p: dict, x, positions,
         rope_tables=None):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = linear_apply(ctx, p["wq"], x, name="wq").reshape(b, s, h, hd)
    k = linear_apply(ctx, p["wk"], x, name="wk").reshape(b, s, kv, hd)
    v = linear_apply(ctx, p["wv"], x, name="wv").reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["qn"], q)
        k = rmsnorm_apply(p["kn"], k)
    if cfg.use_rope:
        if cfg.mrope:  # text positions; the vision stub feeds the same layer
            mp = ropelib.text_mrope_positions(positions)
            sec = (hd // 8, hd * 3 // 16, hd * 3 // 16)
            q = ropelib.apply_mrope(q, mp, cfg.rope_theta, sec)
            k = ropelib.apply_mrope(k, mp, cfg.rope_theta, sec)
        else:
            q = ropelib.apply_rope(q, positions, cfg.rope_theta,
                                   tables=rope_tables)
            k = ropelib.apply_rope(k, positions, cfg.rope_theta,
                                   tables=rope_tables)
    return q, k, v


def _flash_attn(q, k, v, q_pos, k_pos, cfg: AttnStatic, ctx: RunCtx,
                mx_digital: bool = False) -> torch.Tensor:
    """Online-softmax attention, tile for tile the reference's: queries in
    ``ctx.q_chunk`` tiles, keys in ``ctx.attn_chunk`` tiles (padded keys
    sit at KV_PAD), a running max, a corrected denominator and f32 ``acc``;
    a query row with no live key gives 0. q [B,Sq,Hkv,G,Dh]; k,v
    [B,Sk,Hkv,Dh]. Each tile's PV is rounded to v's dtype before it joins
    ``acc``, as the eager reference does on the CPU (pinned by
    ``tests/test_torch_flash_prefill.py``).

    With ``mx_digital`` Q/K are quantized along head_dim, scores get the
    BF16 round, and P/V are re-quantized per KV tile along the key axis;
    the denominator sums the quantized P."""
    if mx_digital:
        qq, kq = _mx_qk(q, k)
        q, k = qq.to(q.dtype), kq.to(k.dtype)
    b, sq, hkv, g, dh = q.shape
    sk = k.shape[1]
    kc, qc = min(ctx.attn_chunk, sk), min(ctx.q_chunk, sq)
    nkc, nqc = -(-sk // kc), -(-sq // qc)
    pad_k, pad_q = nkc * kc - sk, nqc * qc - sq
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = F.pad(k_pos, (0, pad_k), value=KV_PAD)
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q))
    f32 = torch.float32
    out = []
    for i in range(nqc):
        qi = q[:, i * qc:(i + 1) * qc].to(f32)
        qpi = q_pos[:, i * qc:(i + 1) * qc]
        m_run = torch.full(qi.shape[:-1], float("-inf"), dtype=f32,
                           device=q.device)
        den = torch.zeros_like(m_run)
        acc = torch.zeros(qi.shape, dtype=f32, device=q.device)
        for j in range(nkc):
            kci, vci = k[:, j * kc:(j + 1) * kc], v[:, j * kc:(j + 1) * kc]
            kpi = k_pos[:, j * kc:(j + 1) * kc]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qi, kci.to(f32)) * cfg.scale
            if mx_digital:
                s = _mx_score_round(s)
            msk = _mask(qpi, kpi, cfg.causal, cfg.window)  # [B, qc, kc]
            s = torch.where(msk[:, :, None, None, :], s, float("-inf"))
            m_new = torch.maximum(m_run, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m_run),
                               torch.exp(m_run - m_safe), 0.0)
            if mx_digital:  # per-tile P/V re-quant; den sums quantized P
                p, vq, _ = _mx_pv(p, vci)
                vci = vq.to(vci.dtype)
            pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(vci.dtype).to(f32),
                              vci.to(f32)).to(vci.dtype)
            acc = acc * corr[..., None] + pv.to(f32)
            den = den * corr + p.sum(-1)
            m_run = m_new
        den = torch.where(den == 0.0, 1.0, den)
        out.append((acc / den[..., None]).to(q.dtype))
    return torch.cat(out, dim=1)[:, :sq]


def _flash_kernel(ctx, cfg, q, k, v, positions) -> torch.Tensor:
    """``_flash_attn``'s function through the ``flash_attention`` kernel
    wrapper, for positions in the ``RunCtx.arange_positions`` layout: the
    kernel puts query and key i at position i, which the live rows are;
    it attends causally from a KV_PAD row too, where ``_flash_attn``
    gives 0, so those rows are zeroed. q [B,S,Hkv,G,Dh] goes in as
    [B,S,H,Dh] (head h reads KV head h // G)."""
    b, s, hkv, g, dh = q.shape
    o = flash_ops.flash_attention(q.reshape(b, s, hkv * g, dh), k, v,
                                  causal=cfg.causal, window=cfg.window,
                                  q_offset=0, obs=ctx.obs)
    live = (positions > _KV_PAD_MIN)[:, :, None, None, None]
    return torch.where(live, o.reshape(q.shape),
                       torch.zeros((), dtype=o.dtype, device=o.device))


def _takes_flash_kernel(ctx, cfg, device_type: str, mx_dig: bool,
                        s: int, grad: bool = False) -> bool:
    """Whether a prefill of ``s`` rows runs on the ``flash_attention``
    kernel: past ``dense_attn_max``, on CUDA (or ``meta``, where the
    dry-run counts the card's path) under ``impl="auto"``, and
    only where the kernel computes ``_flash_attn``'s function: without
    the digital SDPA, causally (a KV_PAD key would enter a bidirectional
    row), at its own d^-0.5 scale and in the arange layout of the
    positions. Never where autograd needs a gradient through it
    (``grad``): the kernel has no backward, so a differentiable prefill
    takes the torch-op ``_flash_attn``, the function the reference's
    training differentiates."""
    return (s > ctx.dense_attn_max and device_type in ("cuda", "meta")
            and ctx.impl == "auto" and not mx_dig and ctx.arange_positions
            and cfg.causal and cfg.scale == cfg.head_dim ** -0.5
            and not grad)


def _prefill_attn(ctx, cfg, q, k, v, positions, mx_dig):
    if q.shape[1] <= ctx.dense_attn_max:
        return _dense_attn(q, k, v, positions, positions, cfg,
                           mx_digital=mx_dig)
    if _takes_flash_kernel(ctx, cfg, q.device.type, mx_dig, q.shape[1],
                           grad=_build.needs_grad(q, k, v)):
        return _flash_kernel(ctx, cfg, q, k, v, positions)
    return _flash_attn(q, k, v, positions, positions, cfg, ctx,
                       mx_digital=mx_dig)


def attn_apply(ctx: RunCtx, cfg: AttnStatic, p: dict, x: torch.Tensor,
               positions: torch.Tensor, cache: dict | None = None,
               pos=None, rope_tables=None):
    """Pre-norm attention sublayer with residual. Returns (y, cache).

    - Prefill, ``cache=None``: attention over the sequence (dense up to
      ``ctx.dense_attn_max``, online softmax past it).
    - Prefill into a fused cache (``cache`` + S > 1, ``pos=None``): the
      returned cache holds the page filled with the last W positions.
    - Chunked prefill (``cache`` + S > 1 + ``pos``, the chunk's start):
      ``positions`` are absolute prompt offsets; the returned page holds
      the chunk's rows at their slots (:func:`_chunk_prefill`).
    - Fused paged decode (S == 1): the new K/V row and its quantized
      mirrors are written *in place* into ``cache`` at pool rows
      ``ctx.paged_rows`` (default: lane i -> row i), then one ragged paged
      decode over the pool. The reference returns new arrays that the
      engine donates; writing in place has the same effect.
    - Legacy decode (S == 1, ``cache={"k", "v"}`` and, under the digital
      SDPA, optionally the resident mirrors): the new row is written in
      place at slot ``pos % W`` of each lane, then attention over the
      lane's valid slots (:func:`_legacy_decode`).
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = h // kv
    mx_dig = ctx.hybrid_digital_sdpa
    xn = norm_apply(cfg.norm, p["ln"], x)
    q, k, v = _qkv(ctx, cfg, p, xn, positions, rope_tables=rope_tables)
    if s > 1:
        # zero K/V at KV_PAD positions (fixed-shape padded prefill): the
        # MXFP4 SDPA quantizes V in blocks along the key axis, so garbage
        # pad rows would perturb real rows' codes and land in the cache
        kvm = (positions > _KV_PAD_MIN)[:, :, None, None]
        k = torch.where(kvm, k, torch.zeros((), dtype=k.dtype, device=k.device))
        v = torch.where(kvm, v, torch.zeros((), dtype=v.dtype, device=v.device))
    q = q.reshape(b, s, kv, g, hd)
    fused = cache is not None and "kv" in cache

    if cache is not None and s > 1 and pos is not None:
        o, cache = _chunk_prefill(cfg, q, k, v, positions, cache, mx_dig)
    elif cache is not None and s > 1:
        # prefill into a page: ring convention, slot = pos % W
        w = (cache["kv"] if fused else cache["k"]).shape[1]
        if s < w:
            kw = F.pad(k, (0, 0, 0, 0, 0, w - s))
            vw = F.pad(v, (0, 0, 0, 0, 0, w - s))
        else:
            kw, vw = k[:, -w:], v[:, -w:]
            if s % w:
                kw = torch.roll(kw, s % w, dims=1)
                vw = torch.roll(vw, s % w, dims=1)
        if fused:
            dt = cache["kv"].dtype
            kcast, vcast = kw.to(dt), vw.to(dt)
            resident = "kv_codes" in cache
            cache = {"kv": paged_layout.fuse_kv(kcast, vcast)}
            if resident:
                cache.update(paged_layout.quant_page_full(kcast, vcast))
        else:
            resident = "k_codes" in cache
            cache = {"k": kw.to(cache["k"].dtype),
                     "v": vw.to(cache["v"].dtype)}
            if resident:  # from the cache-dtype pages, as a requant sees them
                cache.update(_quant_cache_full(cache["k"], cache["v"]))
        o = _prefill_attn(ctx, cfg, q, k, v, positions, mx_dig)
    elif fused:
        o = _fused_decode(ctx, cfg, q, k, v, cache, pos, mx_dig)
    elif cache is not None:
        o = _legacy_decode(cfg, q, k, v, cache, pos, mx_dig)
    else:
        o = _prefill_attn(ctx, cfg, q, k, v, positions, mx_dig)

    o = o.reshape(b, s, h * hd)
    y = linear_apply(ctx, p["wo"], o, name="wo")
    return x + y.to(x.dtype), cache


def _chunk_prefill(cfg, q, k, v, positions, cache, mx_dig):
    """One window of a longer prompt into an existing page, fused or
    legacy (the engine's ``chunk_len`` step): ``positions`` carry
    absolute prompt offsets (KV_PAD on pad columns). Fresh K/V rows land
    at their absolute slots, pad columns are dropped, and this chunk's
    queries attend over the whole page: rows past the written prefix are
    zero (the engine clones or resets the page at admission) and carry
    k_pos > q_pos, so the causal mask drops them. Under the digital SDPA
    the quantized mirrors are recomputed for the whole page every chunk
    (O(page) a chunk, as in the reference): blockwise V exponents near
    the chunk's edge depend on rows outside it, and mirrors equal to a
    full requant of the raw page make pages content-addressable
    (``serving/prefix.py``). Returns (o, the new page dict)."""
    b = q.shape[0]
    fused = "kv" in cache
    raw = cache["kv"] if fused else cache["k"]
    w, dev = raw.shape[1], raw.device
    rows = torch.arange(b, device=dev)[:, None]
    # pad columns go to an extra slot W, cut off again
    slot = torch.where(positions > _KV_PAD_MIN, positions, w)

    def write(page, new):
        page = F.pad(page, (0, 0, 0, 0, 0, 1))
        page[rows, slot] = new.to(page.dtype)
        return page[:, :w]

    if fused:
        dt = raw.dtype
        page = write(raw, paged_layout.fuse_kv(k.to(dt), v.to(dt)))
        new_cache = {"kv": page}
        kpage, vpage = paged_layout.split_kv(page)
        if "kv_codes" in cache:
            new_cache.update(paged_layout.quant_page_full(kpage, vpage))
    else:
        kpage, vpage = write(cache["k"], k), write(cache["v"], v)
        new_cache = {"k": kpage, "v": vpage}
        if "k_codes" in cache:
            new_cache.update(_quant_cache_full(kpage, vpage))
    k_pos = torch.arange(w, device=dev)[None].expand(b, w)
    o = _dense_attn(q, kpage, vpage, positions, k_pos, cfg, mx_digital=mx_dig)
    return o, new_cache


def _fused_decode(ctx, cfg, q, k, v, cache, pos, mx_dig):
    b = q.shape[0]
    w = cache["kv"].shape[1]
    dev = q.device
    pos_b = torch.as_tensor(pos, device=dev).to(torch.long).expand(b)
    rows = (torch.arange(b, device=dev) if ctx.paged_rows is None
            else ctx.paged_rows.to(device=dev, dtype=torch.long))
    slot = pos_b % w
    kvnew = paged_layout.fuse_kv(k[:, 0], v[:, 0])
    cache["kv"][rows, slot] = kvnew.to(cache["kv"].dtype)
    resident = "kv_codes" in cache
    if resident:
        paged_layout.quant_page_step(cache, cache["kv"], rows, slot)
    # min(pos+1, W): a contiguous valid prefix, all W once the ring wraps
    lengths = torch.clamp(pos_b + 1, max=w).to(torch.int32)
    qd, kv_pages, quant = q, cache["kv"], None
    if mx_dig:
        if not resident:
            raise ValueError("fused paged decode under a digital-SDPA backend "
                             "needs the quantized-resident mirrors — init the "
                             "cache with mx_digital=True")
        qd = _mx_fq(q).to(torch.bfloat16)
        kv_pages = None
        quant = {n: cache[n] for n in ("kv_codes", "k_exps", "v_exps")}
    if ctx.impl == "ref":
        o = paged_ref.ragged_paged_decode_ref(
            qd[:, 0], rows, lengths, kv=kv_pages, quant=quant,
            scale=cfg.scale)
    else:
        o = paged_ops.ragged_paged_decode(
            qd[:, 0], rows, lengths, kv=kv_pages, quant=quant,
            scale=cfg.scale, obs=ctx.obs)
    return o[:, None]


def _legacy_decode(cfg, q, k, v, cache, pos, mx_dig):
    """One decode step over the legacy split cache, the reference's
    einsum decode: each lane's new K/V row is written in place at slot
    ``pos % W`` (``pos`` an int or an int tensor, 0-d or [B]), and its
    query attends over slots ``<= pos`` (all W once the ring has wrapped).
    Under the digital SDPA, Q and K are quantized along head_dim (K read
    back from the resident mirrors, updated in place, or requantized whole
    each step), the scores get the BF16 round, P is quantized along the
    key axis and V along its key axis (resident or requantized), and the
    output is divided by the quantized P's sum."""
    b, hd = q.shape[0], cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    w = ck.shape[1]
    dev = q.device
    pos_b = torch.as_tensor(pos, device=dev).to(torch.long).expand(b)
    slot = pos_b % w
    lanes = torch.arange(b, device=dev)
    ck[lanes, slot] = k[:, 0].to(ck.dtype)
    cv[lanes, slot] = v[:, 0].to(cv.dtype)
    resident = "k_codes" in cache
    if resident:
        _quant_cache_step(cache, ck, cv, lanes, slot)
    idx = torch.arange(w, device=dev)
    valid = (idx[None, :] <= pos_b[:, None]) | (pos_b[:, None] >= w)
    qd, kd = q, ck
    if mx_dig:
        qd = _mx_fq(q)
        if resident:  # O(1) a step: K read back from its codes
            kd = mxlib.dequantize(mxlib.MX(cache["k_codes"], cache["k_exps"]),
                                  out_len=hd)
        else:  # the requant-per-step reference
            kd = _mx_fq(ck)
        qd, kd = qd.to(torch.bfloat16), kd.to(torch.bfloat16)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qd.float(), kd.float()) * cfg.scale
    if mx_dig:
        sc = _mx_score_round(sc)
    sc = torch.where(valid[:, None, None, None, :], sc, float("-inf"))
    if not mx_dig:
        pr = torch.softmax(sc, dim=-1).to(cv.dtype)
        return torch.einsum("bhgqk,bkhd->bqhgd", pr, cv)
    pr, den = _mx_p(torch.softmax(sc, dim=-1))
    if resident:
        vd = torch.movedim(mxlib.dequantize(
            mxlib.MX(cache["v_codes"], cache["v_exps"]), out_len=w), -1, 1)
    else:
        vd = mxlib.fake_quant_axis(cv, 1)  # bf16-native chain
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr.to(torch.bfloat16).float(),
                     vd.to(torch.bfloat16).float())
    return (o / torch.movedim(den, -2, 1)).to(cv.dtype)


def attn_cache_init(cfg: AttnStatic, batch: int, max_len: int,
                    dtype=torch.bfloat16, mx_digital: bool = False,
                    fused: bool = False, device=None) -> dict:
    """K/V decode cache on ``device`` (default ``cuda``; raises without a
    GPU unless ``device="cpu"`` is given): the fused paged layout
    (``fused``) or the legacy split ``{"k", "v"}`` [B, W, Hkv, Dh]; with
    ``mx_digital`` it also carries the quantized-resident code mirrors for
    the digital-SDPA decode."""
    w = min(cfg.window, max_len) if cfg.window > 0 else max_len
    if not fused:
        dev = resolve_device(device)
        shape = (batch, w, cfg.n_kv, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if mx_digital:
            cache.update(quant_cache_init(batch, w, cfg.n_kv, cfg.head_dim,
                                          dev))
        return cache
    cache = paged_layout.fused_cache_init(batch, w, cfg.n_kv, cfg.head_dim,
                                          dtype, device)
    if mx_digital:
        cache.update(paged_layout.fused_quant_init(batch, w, cfg.n_kv,
                                                   cfg.head_dim, device))
    return cache


ATTN_CACHE_SPECS = {
    "k": ("batch", "cache_seq", None, None),
    "v": ("batch", "cache_seq", None, None),
}
ATTN_QUANT_CACHE_SPECS = {
    **ATTN_CACHE_SPECS,
    "k_codes": ("batch", "cache_seq", None, None),
    "k_exps": ("batch", "cache_seq", None, None),
    "v_codes": ("batch", None, None, "cache_seq"),
    "v_exps": ("batch", None, None, None),
}
FUSED_ATTN_CACHE_SPECS = {"kv": ("batch", "cache_seq", None, None)}
FUSED_ATTN_QUANT_CACHE_SPECS = {
    **FUSED_ATTN_CACHE_SPECS,
    "kv_codes": ("batch", "cache_seq", None, None),
    "k_exps": ("batch", "cache_seq", None, None),
    "v_exps": ("batch", None, None, None),  # slot-block-major key axis
}


def attn_cache_specs(mx_digital: bool = False, fused: bool = False) -> dict:
    if not fused:
        return ATTN_QUANT_CACHE_SPECS if mx_digital else ATTN_CACHE_SPECS
    return FUSED_ATTN_QUANT_CACHE_SPECS if mx_digital else FUSED_ATTN_CACHE_SPECS
