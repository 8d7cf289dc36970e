"""Grouped-query attention with RoPE, the digital MXFP4 SDPA helpers and
the fused paged KV cache (counterpart of ``repro.layers.attention``).

Ported branches of :func:`attn_apply`: prefill without a cache, prefill
into a fused or a legacy split cache, chunked prefill into a fused page,
the fused paged decode (``distributed.seq_parallel.fused_decode``), over
float pages or (under a digital-SDPA backend) the quantized-resident
mirrors, and the legacy decode (torch
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
from repro_torch.distributed import seq_parallel as spl
from repro_torch.distributed import tensor_parallel as tpl
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
    row_linear_apply,
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
                      lanes: torch.Tensor, slot: torch.Tensor,
                      write: torch.Tensor | None = None) -> None:
    """In-place per-step update of the mirrors in ``cache`` from the
    just-written raw caches ``ck`` / ``cv``: the written K row of each
    lane and the V block holding its slot (a partial end block reads 0
    past the cache), the reference's ``_quant_cache_step``. ``write``
    (bool [B]) limits the update to its lanes (a rank's block of a cache
    cut along its sequence: the lanes whose slot it holds)."""
    b, w = cv.shape[0], cv.shape[1]

    def put(old, new, dims):  # old: a thunk, read only under ``write``
        if write is None:
            return new
        return torch.where(write.reshape((-1,) + (1,) * dims), new, old())

    kq = mxlib.quantize(ck[lanes, slot].to(torch.float32))  # [B, Hkv, *]
    for name, new in (("k_codes", kq.codes), ("k_exps", kq.exps)):
        cache[name][lanes, slot] = put(lambda: cache[name][lanes, slot],
                                       new, 2)
    start = (slot // mxlib.BLOCK) * mxlib.BLOCK  # [B]
    idx = start[:, None] + torch.arange(mxlib.BLOCK, device=cv.device)
    blk = cv[lanes[:, None], torch.clamp(idx, max=w - 1)]  # [B, 32, Hkv, Dh]
    blk = torch.where((idx < w)[:, :, None, None], blk,
                      torch.zeros((), dtype=blk.dtype, device=blk.device))
    vq = mxlib.quantize_axis(blk.to(torch.float32), 1)  # [B, Hkv, Dh, 32]
    vc = cache["v_codes"]
    ci = idx[:, None, None, :].expand(b, vc.shape[1], vc.shape[2],
                                      mxlib.BLOCK)
    cache["v_codes"].scatter_(
        3, ci, put(lambda: torch.gather(vc, 3, ci), vq.codes, 3))
    ve = cache["v_exps"]
    ei = (slot // mxlib.BLOCK)[:, None, None, None].expand(
        b, ve.shape[1], ve.shape[2], 1)
    cache["v_exps"].scatter_(
        3, ei, put(lambda: torch.gather(ve, 3, ei), vq.exps, 3))


def _dense_attn(q, k, v, q_pos, k_pos, cfg: AttnStatic,
                mx_digital: bool = False, v_dtype=None) -> torch.Tensor:
    """q [B,Sq,Hkv,G,Dh]; k,v [B,Sk,Hkv,Dh]. With ``mx_digital`` the SDPA
    runs on the digital MXFP4 systolic datapath: Q/K quantized along
    head_dim, BF16 score round, P/V re-quantized along the key axis,
    division by the quantized-P sum after the SV product. bf16 operands
    with f32 accumulation are computed as f32 products of the (exactly
    bf16-valued) operands. ``v_dtype`` (default v's) is the dtype P and
    the output are rounded to: bf16 for f32 k and v of bf16 values, whose
    gradients then stay in f32 (a tensor-parallel rank's part)."""
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
    dt = v.dtype if v_dtype is None else v_dtype
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(dt).to(v.dtype), v).to(dt)


def tp_heads(cfg: AttnStatic, tp_size: int, tp_rank: int):
    """A model rank's part of the attention under tensor parallelism: (its
    ``AttnStatic``, of n_heads / tp_size query heads and the KV heads
    they read; the range (lo, hi) of those KV heads in k and v gathered
    whole, or None where the rank's ``wk`` / ``wv`` columns are its own
    KV heads). Raises ``NotImplementedError`` where the model axis does
    not divide the query heads (the reference's sequence-parallel
    ``kv_seq`` rule), or the rank's query heads do not read their KV
    heads in equal groups."""
    h, kv = cfg.n_heads, cfg.n_kv
    if h % tp_size:
        raise NotImplementedError(
            f"{h} query heads over a model axis of {tp_size}: the "
            "reference's sequence-parallel attention (kv_seq on 'model') is "
            "not ported; see ROADMAP.md")
    hl = h // tp_size
    if kv % tp_size == 0:
        return dataclasses.replace(cfg, n_heads=hl, n_kv=kv // tp_size), None
    g = h // kv
    if hl % g and g % hl:
        raise NotImplementedError(
            f"{hl} query heads a model rank in groups of {g}: not an equal "
            "grouping over the rank's KV heads; see ROADMAP.md")
    lo, hi = tp_rank * hl // g, ((tp_rank + 1) * hl - 1) // g + 1
    return dataclasses.replace(cfg, n_heads=hl, n_kv=hi - lo), (lo, hi)


def _qkv(ctx: RunCtx, cfg: AttnStatic, p: dict, x, positions,
         rope_tables=None, kv_range=None, gather: bool = False,
         want_all: bool = False):
    """Q, K, V of ``x``, heads split, qk-normed and rotated. Under
    tensor parallelism (``ctx.tp``) ``cfg`` is the rank's
    (:func:`tp_heads`) and, with ``kv_range``, k and v are gathered over
    the model ranks along features (their fused dim is cut inside a KV
    head) before the head reshape, the norm and RoPE, which then run on
    every KV head as on one device; the rank's KV heads go on in f32
    (bf16 values) with their gradients summed over the model ranks. The
    qk-norm gammas are replicated over the model ranks; one that only the
    rank's heads read (``qn``, and ``kn`` without ``kv_range``) has its
    gradient summed over the ranks.

    ``gather`` (the sharded decode, whose heads are whole): q, k and v
    are gathered over the model ranks in one all-gather, and ``cfg`` is
    the whole layer's. ``want_all`` (a sharded prefill into a cache):
    also every KV head's k and v, bf16, as on one device (returned after
    q, k, v)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = linear_apply(ctx, p["wq"], x, name="wq")
    k = linear_apply(ctx, p["wk"], x, name="wk")
    v = linear_apply(ctx, p["wv"], x, name="wv")
    if gather:
        q, k, v = spl.gather_heads(ctx.tp, q, k, v)
    q = q.reshape(b, s, h, hd)
    if kv_range is not None:  # every KV head, as on one device
        k = tpl.gather_from_model(k, ctx.tp, -1)
        v = tpl.gather_from_model(v, ctx.tp, -1)
        kv = k.shape[-1] // hd
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        qn, kn = p["qn"], p["kn"]
        if ctx.tp is not None:  # replicated, read by the rank's heads only
            qn = {"gamma": tpl.copy_to_model(qn["gamma"].to(torch.float32),
                                             ctx.tp)}
            if kv_range is None:  # else it reads every KV head
                kn = {"gamma": tpl.copy_to_model(
                    kn["gamma"].to(torch.float32), ctx.tp)}
        q = rmsnorm_apply(qn, q)
        k = rmsnorm_apply(kn, k)
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
    every = (k, v)
    if want_all and kv_range is None:  # the other ranks' KV heads
        every = tuple(t.reshape(b, s, -1, hd) for t in spl.gather_heads(
            ctx.tp, k.reshape(b, s, -1), v.reshape(b, s, -1)))
    if kv_range is not None:
        # the rank's heads' gradients of every KV head, summed over the
        # model ranks in f32 where the one-device attention rounds its
        # sum over all heads once; then the rank's KV heads
        lo, hi = kv_range
        k, v = (tpl.copy_to_model(t.to(torch.float32), ctx.tp)[:, :, lo:hi]
                for t in (k, v))
    return (q, k, v) + (every if want_all else ())


def _flash_attn(q, k, v, q_pos, k_pos, cfg: AttnStatic, ctx: RunCtx,
                mx_digital: bool = False, v_dtype=None) -> torch.Tensor:
    """Online-softmax attention, tile for tile the reference's: queries in
    ``ctx.q_chunk`` tiles, keys in ``ctx.attn_chunk`` tiles (padded keys
    sit at KV_PAD), a running max, a corrected denominator and f32 ``acc``;
    a query row with no live key gives 0. q [B,Sq,Hkv,G,Dh]; k,v
    [B,Sk,Hkv,Dh]. Each tile's PV is rounded to v's dtype before it joins
    ``acc``, as the eager reference does on the CPU (pinned by
    ``tests/test_torch_flash_prefill.py``).

    With ``mx_digital`` Q/K are quantized along head_dim, scores get the
    BF16 round, and P/V are re-quantized per KV tile along the key axis;
    the denominator sums the quantized P. ``v_dtype`` as
    :func:`_dense_attn`'s."""
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
    dt = v.dtype if v_dtype is None else v_dtype
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
            pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(dt).to(f32),
                              vci.to(f32)).to(dt)
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
    # f32 k and v of bf16 values (a tensor-parallel rank's gathered KV
    # heads) round P and the output to q's bf16
    v_dtype = q.dtype if v.dtype != q.dtype else None
    if q.shape[1] <= ctx.dense_attn_max:
        return _dense_attn(q, k, v, positions, positions, cfg,
                           mx_digital=mx_dig, v_dtype=v_dtype)
    if _takes_flash_kernel(ctx, cfg, q.device.type, mx_dig, q.shape[1],
                           grad=_build.needs_grad(q, k, v)):
        return _flash_kernel(ctx, cfg, q, k, v, positions)
    return _flash_attn(q, k, v, positions, positions, cfg, ctx,
                       mx_digital=mx_dig, v_dtype=v_dtype)


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
      lane's valid slots (``distributed.seq_parallel.legacy_decode``).

    Under tensor parallelism (``ctx.tp``, the sharded train step) the
    prefill without a cache runs on the rank's query heads and their KV
    heads (:func:`tp_heads`): ``wq`` / ``wk`` / ``wv`` hold its columns,
    ``wo`` its rows (``layers.common.row_linear_apply``). The sharded
    serving steps run two more branches: a prefill into a legacy cache
    under ``ctx.tp`` attends on the rank's heads too, and writes every
    KV head's rows (gathered over the model ranks) into the cache, of
    which it keeps its block of the sequence (``ctx.seq``); a legacy
    decode under ``ctx.tp`` gathers q, k and v over the model ranks
    (heads are whole at decode) and takes ``wo``'s rows of its features;
    over a cache whose sequence is cut (``ctx.seq``) it is the
    flash-decoding of ``distributed.seq_parallel``. The fused paged
    decode does the same (q, k and v gathered under ``ctx.tp``), kernel B
    or D in its partial mode on the rank's block of the pool and the
    blocks' (o, lse) combined over the ranks
    (``distributed.seq_parallel.fused_decode``; under ``ctx.tp`` on a
    whole sequence, at one block). The prefill into a fused page and the
    chunked prefill, which no sharded step of the reference runs (its
    engine is unsharded), raise ``NotImplementedError`` under either.
    """
    b, s, _ = x.shape
    kv_range = None
    tp, seq = ctx.tp, ctx.seq
    decode_tp = tp is not None and cache is not None and s == 1
    if (tp is not None or seq is not None) and cache is not None and s > 1 \
            and ("kv" in cache or pos is not None):
        raise NotImplementedError(
            "the sharded serving steps prefill into legacy caches: the "
            "prefill into a fused page and the chunked prefill on a model "
            "axis or a cut cache sequence are not ported; see ROADMAP.md")
    if tp is not None and not decode_tp:
        cfg, kv_range = tp_heads(cfg, tp.size, tp.rank)
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = h // kv
    mx_dig = ctx.hybrid_digital_sdpa
    xn = norm_apply(cfg.norm, p["ln"], x)
    want_all = tp is not None and cache is not None and s > 1
    qkv = _qkv(ctx, cfg, p, xn, positions, rope_tables=rope_tables,
               kv_range=kv_range, gather=decode_tp, want_all=want_all)
    q, k, v = qkv[:3]
    kc, vc = qkv[3:] if want_all else (k, v)  # every KV head
    if s > 1:
        # zero K/V at KV_PAD positions (fixed-shape padded prefill): the
        # MXFP4 SDPA quantizes V in blocks along the key axis, so garbage
        # pad rows would perturb real rows' codes and land in the cache
        kvm = (positions > _KV_PAD_MIN)[:, :, None, None]
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        k, v = torch.where(kvm, k, zero), torch.where(kvm, v, zero)
        if want_all:
            kc, vc = torch.where(kvm, kc, zero), torch.where(kvm, vc, zero)
        else:
            kc, vc = k, v
    q = q.reshape(b, s, kv, g, hd)
    fused = cache is not None and "kv" in cache

    if cache is not None and s > 1 and pos is not None:
        o, cache = _chunk_prefill(cfg, q, k, v, positions, cache, mx_dig)
    elif cache is not None and s > 1:
        # prefill into a page: ring convention, slot = pos % W (W the
        # whole window: a cut cache holds its block of it)
        w = (cache["kv"] if fused else cache["k"]).shape[1]
        w *= seq.n if seq is not None else 1
        if s < w:
            kw = F.pad(kc, (0, 0, 0, 0, 0, w - s))
            vw = F.pad(vc, (0, 0, 0, 0, 0, w - s))
        else:
            kw, vw = kc[:, -w:], vc[:, -w:]
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
            if seq is not None:
                cache = _keep_seq_block(cache, seq)
        o = _prefill_attn(ctx, cfg, q, k, v, positions, mx_dig)
    elif fused:
        o = spl.fused_decode(ctx, cfg, q, k, v, cache, pos, mx_dig, seq,
                             partial=tp is not None)
    elif cache is not None:
        o = spl.legacy_decode(cfg, q, k, v, cache, pos, mx_dig, seq)
    else:
        o = _prefill_attn(ctx, cfg, q, k, v, positions, mx_dig)

    o = o.reshape(b, s, h * hd)
    if decode_tp:  # wo's rows are the rank's features of every head
        o = tp.block(o, -1).contiguous()
    y = row_linear_apply(ctx, p["wo"], o, name="wo")
    return x + y.to(x.dtype), cache


def _keep_seq_block(cache: dict, seq) -> dict:
    """A legacy page's leaves (the whole window) cut to this rank's block of
    the sequence: the key axis of ``k`` / ``v`` and of the K mirrors, the
    last axis of the V mirrors (its codes and, held beside them, its
    32-block exponents)."""
    out = {}
    for name, t in cache.items():
        dim = 3 if name.startswith("v_") else 1
        if name.startswith("v_"):
            spl.check_blocks(cache["k"].shape[1] // seq.n,
                             "the resident V mirrors")
        out[name] = spl.keep_block(t, dim, seq)
    return out


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
