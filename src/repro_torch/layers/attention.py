"""Grouped-query attention with RoPE, the digital MXFP4 SDPA helpers and
the fused paged KV cache (counterpart of ``repro.layers.attention``).

Ported branches of :func:`attn_apply`: prefill without a cache, prefill
into a fused cache, chunked prefill into a fused page, and the fused paged
decode, over float pages or (under a digital-SDPA backend) the
quantized-resident mirrors. Prefill past ``RunCtx.dense_attn_max`` takes
the online-softmax ``_flash_attn``; on CUDA, without the digital SDPA,
that is the ``flash_attention`` kernel. The legacy split cache raises
``NotImplementedError`` (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import mx as mxlib
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import layout as paged_layout
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.layers import rope as ropelib
from repro_torch.layers.common import (
    RunCtx,
    linear_apply,
    linear_init,
    norm_apply,
    norm_init,
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


def attn_init(gen: torch.Generator, cfg: AttnStatic) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"ln": norm_init(cfg.norm, d, gen.device)}
    p["wq"] = linear_init(gen, d, h * hd, use_bias=cfg.use_bias)
    p["wk"] = linear_init(gen, d, kv * hd, use_bias=cfg.use_bias)
    p["wv"] = linear_init(gen, d, kv * hd, use_bias=cfg.use_bias)
    p["wo"] = linear_init(gen, h * hd, d, use_bias=cfg.use_bias)
    if cfg.qk_norm:
        p["qn"] = norm_init("rmsnorm", hd, gen.device)
        p["kn"] = norm_init("rmsnorm", hd, gen.device)
    return p


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
        if cfg.mrope:
            raise NotImplementedError("M-RoPE is not ported (ROADMAP.md)")
        q = ropelib.apply_rope(q, positions, cfg.rope_theta, tables=rope_tables)
        k = ropelib.apply_rope(k, positions, cfg.rope_theta, tables=rope_tables)
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
                        s: int) -> bool:
    """Whether a prefill of ``s`` rows runs on the ``flash_attention``
    kernel: past ``dense_attn_max``, on CUDA under ``impl="auto"``, and
    only where the kernel computes ``_flash_attn``'s function: without
    the digital SDPA, causally (a KV_PAD key would enter a bidirectional
    row), at its own d^-0.5 scale and in the arange layout of the
    positions."""
    return (s > ctx.dense_attn_max and device_type == "cuda"
            and ctx.impl == "auto" and not mx_dig and ctx.arange_positions
            and cfg.causal and cfg.scale == cfg.head_dim ** -0.5)


def _prefill_attn(ctx, cfg, q, k, v, positions, mx_dig):
    if q.shape[1] <= ctx.dense_attn_max:
        return _dense_attn(q, k, v, positions, positions, cfg,
                           mx_digital=mx_dig)
    if _takes_flash_kernel(ctx, cfg, q.device.type, mx_dig, q.shape[1]):
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
    if cache is not None and "kv" not in cache:
        raise NotImplementedError("the legacy split K/V cache is not ported "
                                  "(ROADMAP.md Queue 1); use fused=True")

    if cache is not None and s > 1 and pos is not None:
        o, cache = _chunk_prefill(cfg, q, k, v, positions, cache, mx_dig)
    elif cache is not None and s > 1:
        # prefill into a page: ring convention, slot = pos % W
        w = cache["kv"].shape[1]
        if s < w:
            kw = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, w - s))
            vw = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, w - s))
        else:
            kw, vw = k[:, -w:], v[:, -w:]
            if s % w:
                kw = torch.roll(kw, s % w, dims=1)
                vw = torch.roll(vw, s % w, dims=1)
        dt = cache["kv"].dtype
        kcast, vcast = kw.to(dt), vw.to(dt)
        resident = "kv_codes" in cache
        cache = {"kv": paged_layout.fuse_kv(kcast, vcast)}
        if resident:
            cache.update(paged_layout.quant_page_full(kcast, vcast))
        o = _prefill_attn(ctx, cfg, q, k, v, positions, mx_dig)
    elif cache is not None:
        o = _fused_decode(ctx, cfg, q, k, v, cache, pos, mx_dig)
    else:
        o = _prefill_attn(ctx, cfg, q, k, v, positions, mx_dig)

    o = o.reshape(b, s, h * hd)
    y = linear_apply(ctx, p["wo"], o, name="wo")
    return x + y.to(x.dtype), cache


def _chunk_prefill(cfg, q, k, v, positions, cache, mx_dig):
    """One window of a longer prompt into an existing page (the engine's
    ``chunk_len`` step): ``positions`` carry absolute prompt offsets
    (KV_PAD on pad columns). Fresh K/V rows land at their absolute slots,
    pad columns are dropped, and this chunk's queries attend over the
    whole page: rows past the written prefix are zero (the engine clones
    or resets the page at admission) and carry k_pos > q_pos, so the
    causal mask drops them. Under the digital SDPA the quantized mirrors
    are recomputed for the whole page every chunk: blockwise V exponents
    near the chunk's edge depend on rows outside it, and mirrors equal to
    a full requant of the raw page make pages content-addressable
    (``serving/prefix.py``). Returns (o, the new page dict)."""
    b = q.shape[0]
    kv = cache["kv"]
    w, dt = kv.shape[1], kv.dtype
    rows = torch.arange(b, device=kv.device)[:, None]
    # pad columns go to an extra slot W, cut off again
    slot = torch.where(positions > _KV_PAD_MIN, positions, w)
    page = F.pad(kv, (0, 0, 0, 0, 0, 1))
    page[rows, slot] = paged_layout.fuse_kv(k.to(dt), v.to(dt))
    page = page[:, :w]
    new_cache = {"kv": page}
    kpage, vpage = paged_layout.split_kv(page)
    if "kv_codes" in cache:
        new_cache.update(paged_layout.quant_page_full(kpage, vpage))
    k_pos = torch.arange(w, device=kv.device)[None].expand(b, w)
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


def attn_cache_init(cfg: AttnStatic, batch: int, max_len: int,
                    dtype=torch.bfloat16, mx_digital: bool = False,
                    fused: bool = False, device=None) -> dict:
    """Fused paged K/V cache on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"`` is given); with ``mx_digital`` it
    also carries the quantized-resident code mirrors for the digital-SDPA
    decode."""
    if not fused:
        raise NotImplementedError("the legacy split K/V cache is not ported "
                                  "(ROADMAP.md Queue 1); use fused=True")
    w = min(cfg.window, max_len) if cfg.window > 0 else max_len
    cache = paged_layout.fused_cache_init(batch, w, cfg.n_kv, cfg.head_dim,
                                          dtype, device)
    if mx_digital:
        cache.update(paged_layout.fused_quant_init(batch, w, cfg.n_kv,
                                                   cfg.head_dim, device))
    return cache


FUSED_ATTN_CACHE_SPECS = {"kv": ("batch", "cache_seq", None, None)}
FUSED_ATTN_QUANT_CACHE_SPECS = {
    **FUSED_ATTN_CACHE_SPECS,
    "kv_codes": ("batch", "cache_seq", None, None),
    "k_exps": ("batch", "cache_seq", None, None),
    "v_exps": ("batch", None, None, None),  # slot-block-major key axis
}


def attn_cache_specs(mx_digital: bool = False, fused: bool = False) -> dict:
    if not fused:
        raise NotImplementedError("the legacy split K/V cache is not ported")
    return FUSED_ATTN_QUANT_CACHE_SPECS if mx_digital else FUSED_ATTN_CACHE_SPECS
