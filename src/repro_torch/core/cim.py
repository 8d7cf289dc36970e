"""Analog CTT-CIM datapath simulation (paper §3, §5.2.2).

PyTorch counterpart of ``repro.core.cim``: a CIM linear ``y = x @ w``
with ``w`` resident as MXFP4 INT5 codes, ``x`` block-quantized per
(row, 32-block), each block's exact integer partial aligned to a target
exponent ``E_N`` under a ``CM``-bit mirror window (underflow to zero
below, clamp above), the optional second pass at ``E_N - CM``, and an
n-bit ADC per (pass, column) sum.

Target-exponent strategies (Fig 5): the offline ``row_hist`` (per-layer
``E_N`` from calibration; the serving hot path) walks the blocks in
ascending order with one running f32 sum per pass, the accumulation order
of the reference's scan, so the result is bitwise the reference's. The
online ``row0`` / ``row_opt`` baselines need the whole block-exponent
field and take the materialized composition; its per-block sums are
multiples of ``2^-CM`` far below 2^24, so they are exact in any order.
Also here: the fidelity probe's instrumented forward and ADC health
(:func:`cim_linear_fidelity`, :func:`adc_health`), the unsigned-weight
bias-column variant and the bit-plane dot.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import mx as mxlib
from repro_torch.core.mx import BLOCK, MXW


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    adc_bits: int | None = 10  # None disables the ADC model
    cm_bits: int = 3
    two_pass: bool = True
    strategy: str = "row_hist"
    strategy_offset: int = 0
    collect_stats: bool = False


class LayerCalib(NamedTuple):
    e_n: torch.Tensor  # [] int32 per-layer target exponent
    adc_fs: torch.Tensor  # [] f32 ADC full scale (aligned-integer units)


def _block_partials(x: torch.Tensor, w: MXW):
    """Quantize activations and form the per-block integer partial sums:
    (S [..., nb, N] exact integers in f32, es [..., nb, N] = E_X + E_W)."""
    cx, ex, nb = _xq_blocks(x, w.codes.shape[0])
    cw = w.codes.to(torch.float32).reshape(nb, BLOCK, -1)
    s = torch.einsum("...bk,bkm->...bm", cx, cw)
    es = ex[..., :, None] + w.exps.to(torch.int32)
    return s, es


def _adc(c: torch.Tensor, fs: torch.Tensor, bits: int | None) -> torch.Tensor:
    if bits is None:
        return c
    half = 2.0 ** (bits - 1)
    delta = fs / half
    q = torch.clamp(torch.round(c / delta), -half, half - 1.0)
    return q * delta


def _target_exponent(cfg: CIMConfig, calib: LayerCalib | None,
                     es: torch.Tensor):
    if cfg.strategy == "row_hist":
        if calib is None:
            raise ValueError("row_hist needs offline calibration "
                             "(calib=None)")
        return calib.e_n
    if cfg.strategy == "row0":
        # the first block-row's exponent reused for all rows (per column)
        return es[..., 0:1, :] + cfg.strategy_offset
    if cfg.strategy == "row_opt":
        # per-column median exponent: for an even block count the mean of
        # the two middle values (jnp.median), truncated toward zero
        srt = es.sort(dim=-2).values
        n = srt.shape[-2]
        hi = srt[..., n // 2:n // 2 + 1, :]
        med = hi if n % 2 else (
            srt[..., n // 2 - 1:n // 2, :].to(torch.float32)
            + hi.to(torch.float32)) * 0.5
        return med.to(torch.int32) + cfg.strategy_offset
    raise ValueError(f"unknown strategy {cfg.strategy!r}")


def _en_scale(e_n, delta: int = 0) -> torch.Tensor:
    """2^(E_N - delta), exact, broadcastable to [..., N] (the block axis
    that online strategies carry is squeezed)."""
    sc = mxlib.exp2i(torch.as_tensor(e_n).to(torch.int32) - delta)
    if sc.ndim > 0:
        sc = sc[..., 0, :]
    return sc


def _xq_blocks(x: torch.Tensor, k: int):
    """Quantize activations to the code domain with the 32-block
    structure exposed: (cx f32 [..., nb, 32], ex int32 [..., nb], nb)."""
    xq = mxlib.quantize(x[..., :k])
    nb = xq.codes.shape[-1] // BLOCK
    cx = xq.codes.reshape(xq.codes.shape[:-1] + (nb, BLOCK)).to(torch.float32)
    return cx, xq.exps.to(torch.int32), nb


def _scan_blocks(cx, ex, w: MXW, e_n, cfg: CIMConfig):
    """Walk the 32-blocks in ascending order: each step forms one block's
    exact integer partial [..., N] (|S| <= 32*144, exact in f32), aligns it
    to the scalar target ``e_n`` in the linear domain —
    ``uv = 2^(E_X - E_N) * 2^(E_W)``, zero below ``2^-cm``, clamped at 1 —
    and adds it to the running pass-1 / pass-2 sums.

    Returns (c1 [..., N], c2 [..., N], counts int32 [4] = (overflow,
    underflow_p1, underflow_p2, live blocks); counts are zero unless
    ``cfg.collect_stats``).
    """
    cm = cfg.cm_bits
    nb = cx.shape[-2]
    # row-major copies: a block's rows of K-major codes are strided
    wc = w.codes.contiguous().to(torch.float32).reshape(nb, BLOCK, -1)
    e_n = torch.as_tensor(e_n, device=cx.device).to(torch.int32)
    u = mxlib.exp2i(ex - e_n)  # [..., nb]
    v = mxlib.exp2i(w.exps.contiguous().to(torch.int32))  # [nb, N]
    lo = 2.0 ** -cm
    lo2 = 2.0 ** -(2 * cm)
    c1 = torch.zeros(cx.shape[:-2] + (wc.shape[-1],), dtype=torch.float32,
                     device=cx.device)
    c2 = torch.zeros_like(c1)
    cnt = torch.zeros(4, dtype=torch.int32, device=cx.device)
    for b in range(nb):
        s = cx[..., b, :] @ wc[b]  # exact integer partial
        uv = u[..., b, None] * v[b]  # 2^sh, exact
        under1 = uv < lo
        c1 = c1 + s * torch.where(under1, 0.0, torch.clamp(uv, max=1.0))
        if cfg.two_pass:
            # pass-2 target E_N2 = E_N - CM: window sh in [-2cm, -cm)
            c2 = c2 + s * torch.where(under1 & (uv >= lo2),
                                      uv * (2.0 ** cm), 0.0)
        if cfg.collect_stats:
            nz = s.abs() > 0
            under12 = ((uv < lo2) & nz if cfg.two_pass
                       else torch.zeros_like(nz))
            cnt = cnt + torch.stack([
                ((uv > 1.0) & nz).sum(), (under1 & nz).sum(),
                under12.sum(), nz.sum(),
            ]).to(torch.int32)
    return c1, c2, cnt


def cim_linear(x: torch.Tensor, w: MXW, cfg: CIMConfig,
               calib: LayerCalib | None = None):
    """Analog CIM forward. Returns (y [..., N] float32, stats dict). The
    offline ``row_hist`` strategy runs the blockwise walk; the online
    ``row0`` / ``row_opt`` baselines the materialized composition."""
    if cfg.strategy != "row_hist":
        return _cim_linear_materialized(x, w, cfg, calib)
    if calib is None:
        raise ValueError("row_hist needs offline calibration (calib=None)")
    cx, ex, _ = _xq_blocks(x, w.codes.shape[0])
    c1, c2, cnt = _scan_blocks(cx, ex, w, calib.e_n, cfg)
    y = read_out(c1, c2, calib, cfg)
    stats = {}
    if cfg.collect_stats:
        tot = torch.clamp(cnt[3], min=1)
        stats = {
            "overflow_rate": cnt[0] / tot,
            "underflow_rate_p1": cnt[1] / tot,
            "underflow_rate_p2": cnt[2] / tot,
        }
    return y.to(torch.float32), stats


def read_out(c1: torch.Tensor, c2: torch.Tensor, calib: LayerCalib,
             cfg: CIMConfig) -> torch.Tensor:
    """The read-out of the two pass sums ``c1``, ``c2`` (f32, in units of
    2^E_N / 4 and 2^(E_N - CM) / 4): the n-bit ADC of each, scaled, pass 2
    added. Element-wise: the epilogue of :func:`cim_linear` and of
    :func:`read_out_sums`, and the kernel's (``csrc/cim_linear.cu``)."""
    y = _adc(c1, calib.adc_fs, cfg.adc_bits) * _en_scale(calib.e_n) * 0.25
    if cfg.two_pass:
        y = y + (_adc(c2, calib.adc_fs, cfg.adc_bits)
                 * _en_scale(calib.e_n, cfg.cm_bits) * 0.25)
    return y.to(torch.float32)


def sums_dtype(k: int, cm: int) -> torch.dtype:
    """The integer type of :func:`pass_sums` over a contraction of ``k``:
    int32 while a row's bound K * 144 * 2^CM (32 products of at most
    12 * 12 a block, each shifted by up to CM) stays below 2^31, else
    int64."""
    return torch.int32 if k * 144 * 2 ** cm < 2 ** 31 else torch.int64


def pass_sums(x: torch.Tensor, w: MXW, calib: LayerCalib,
              cfg: CIMConfig) -> torch.Tensor:
    """The two pass sums of the ``row_hist`` datapath before the read-out,
    as exact integers in units of 2^-CM: [2, ..., N] of
    :func:`sums_dtype`. Each block's dot is an exact integer and its
    aligned term an integer multiple of 2^-CM, so the sums are exact in
    any order: the sums of the K-slices of a linear add up to the whole
    one's (a row-parallel linear's ranks add theirs before the one
    :func:`read_out_sums`). :func:`cim_linear`'s ordered f32 sums equal
    them times 2^-CM wherever a row stays below 2^24 units (where
    ``kernels.cim_linear.ops.needs_guard`` is false, always); past that
    the f32 walk may round and the two differ."""
    if cfg.strategy != "row_hist":
        raise ValueError("pass sums take the row_hist strategy")
    k = w.codes.shape[0]
    cm = cfg.cm_bits
    cx, ex, nb = _xq_blocks(x, k)
    wc = w.codes.contiguous().to(torch.float32).reshape(nb, BLOCK, -1)
    e_n = torch.as_tensor(calib.e_n, device=cx.device).to(torch.int32)
    u = mxlib.exp2i(ex - e_n)
    v = mxlib.exp2i(w.exps.contiguous().to(torch.int32))
    lo, lo2, hi = 2.0 ** -cm, 2.0 ** -(2 * cm), 2.0 ** cm
    shape = cx.shape[:-2] + (wc.shape[-1],)
    c1 = torch.zeros(shape, dtype=torch.int64, device=cx.device)
    c2 = torch.zeros_like(c1)
    for b in range(nb):
        s = cx[..., b, :] @ wc[b]  # exact integer partial
        uv = u[..., b, None] * v[b]
        under1 = uv < lo
        # both terms exact integers in f32: |s| <= 32 * 144, times <= 2^CM
        c1 += (s * torch.where(under1, 0.0, torch.clamp(uv, max=1.0))
               * hi).to(torch.int64)
        if cfg.two_pass:
            c2 += (s * torch.where(under1 & (uv >= lo2), uv * (hi * hi),
                                   0.0)).to(torch.int64)
    return torch.stack([c1, c2]).to(sums_dtype(k, cm))


def read_out_sums(sums: torch.Tensor, calib: LayerCalib,
                  cfg: CIMConfig) -> torch.Tensor:
    """:func:`read_out` of integer pass sums [2, ..., N] (units of 2^-CM,
    :func:`pass_sums`, summed over a linear's K-slices): each converted to
    f32 (exact below 2^24), times 2^-CM, read out. f32 [..., N]."""
    unit = 2.0 ** -cfg.cm_bits
    return read_out(sums[0].to(torch.float32) * unit,
                    sums[1].to(torch.float32) * unit, calib, cfg)


def _cim_linear_materialized(x: torch.Tensor, w: MXW, cfg: CIMConfig,
                             calib: LayerCalib | None = None):
    """The composition over the materialized [..., nb, N] block partials,
    which the online strategies need (their target exponent is a function
    of the whole exponent field)."""
    s, es = _block_partials(x, w)
    e_n = _target_exponent(cfg, calib, es)
    sh = es - e_n  # required shift; exact iff -CM <= sh <= 0
    cm = cfg.cm_bits
    over = sh > 0
    under1 = sh < -cm
    a1 = torch.where(under1, 0.0, s * mxlib.exp2i(torch.clamp(sh, -cm, 0)))
    c1 = a1.sum(dim=-2)  # [..., N] in units of 2^E_N / 4
    fs = (calib.adc_fs if calib is not None
          else torch.zeros((), dtype=torch.float32, device=x.device))
    y = _adc(c1, fs, cfg.adc_bits) * _en_scale(e_n) * 0.25
    under2 = torch.zeros_like(under1)
    if cfg.two_pass:
        sh2 = sh + cm  # pass-2 target E_N2 = E_N - CM
        under2 = sh2 < -cm
        a2 = torch.where(under1 & ~under2,
                         s * mxlib.exp2i(torch.clamp(sh2, -cm, 0)), 0.0)
        y = y + _adc(a2.sum(dim=-2), fs, cfg.adc_bits) * _en_scale(e_n, cm) \
            * 0.25
    stats = {}
    if cfg.collect_stats:
        nz = s.abs() > 0  # only blocks with nonzero partials matter
        tot = torch.clamp(nz.sum(), min=1)
        stats = {
            "overflow_rate": (over & nz).sum() / tot,
            "underflow_rate_p1": (under1 & nz).sum() / tot,
            "underflow_rate_p2": (under1 & under2 & nz).sum() / tot,
        }
    return y.to(torch.float32), stats


# ------------------------------------------------------------ calibration

def _calib_max_exponent(x: torch.Tensor, w: MXW) -> torch.Tensor:
    """Max live block-output exponent over one batch (int32 [] on the
    activations' device; no host read)."""
    cx, ex, nb = _xq_blocks(x, w.codes.shape[0])
    wc = w.codes.contiguous().to(torch.float32).reshape(nb, BLOCK, -1)
    we = w.exps.contiguous().to(torch.int32)
    dead = torch.full((), -(10**6), dtype=torch.int32, device=x.device)
    m = dead
    for b in range(nb):
        s = cx[..., b, :] @ wc[b]
        es = ex[..., b, None] + we[b]
        cand = torch.where(s.abs() > 0, es, dead)
        m = torch.maximum(m, cand.amax())
    return m


def _calib_full_scale(x: torch.Tensor, w: MXW, e_n, cfg: CIMConfig):
    """Max |per-pass column sum| over one batch at target ``e_n``: the
    same blockwise accumulation as the forward, so the calibrated full
    scale covers exactly what the forward's ADC sees."""
    cx, ex, _ = _xq_blocks(x, w.codes.shape[0])
    c1, c2, _ = _scan_blocks(cx, ex, w, e_n,
                             dataclasses.replace(cfg, collect_stats=False))
    fs = c1.abs().amax()
    if cfg.two_pass:
        fs = torch.maximum(fs, c2.abs().amax())
    return fs


def _percentile_exponent(x: torch.Tensor, w: MXW,
                         percentile: float) -> torch.Tensor:
    """The reference's percentile of one batch's block-output exponents:
    ``jnp.percentile`` (linear, f32) over the field with dead blocks
    (``S == 0``) masked to NaN, then ``ceil`` and an int32 cast. That
    percentile propagates NaN, and XLA casts NaN to 0, so a batch with
    any dead block gives 0 (ROADMAP.md, the reference's caveats); the
    port gives the same. Sorted, so no element limit applies."""
    s, es = _block_partials(x, w)
    if not bool((s.abs() > 0).all()):
        return torch.zeros((), dtype=torch.int32, device=x.device)
    a = es.reshape(-1).to(torch.float32).sort().values
    n = a.numel()
    q = torch.tensor(percentile, dtype=torch.float32) / 100.0
    q = q * float(n - 1)
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo
    lw = 1.0 - hw
    v = (a[int(lo.clamp(0, n - 1))] * lw.to(a.device)
         + a[int(hi.clamp(0, n - 1))] * hw.to(a.device))
    return torch.ceil(v).to(torch.int32)


def calibrate_rowhist(batches, w: MXW, cfg: CIMConfig,
                      percentile: float = 100.0) -> LayerCalib:
    """Offline Row-Hist calibration (paper §3.2.1): the per-layer target
    exponent is the max live block-output exponent over the batches (zero
    overflow) or, below 100, that percentile of the block exponents (see
    :func:`_percentile_exponent`); then the ADC full scale is calibrated
    at that E_N."""
    e_n = None
    for xb in batches:
        m = (_calib_max_exponent(xb, w) if percentile >= 100.0
             else _percentile_exponent(xb, w, percentile))
        e_n = m if e_n is None else torch.maximum(e_n, m)
    e_n = e_n.to(torch.int32)
    fs = torch.zeros((), dtype=torch.float32, device=e_n.device)
    for xb in batches:
        fs = torch.maximum(fs, _calib_full_scale(xb, w, e_n, cfg))
    return LayerCalib(e_n=e_n, adc_fs=fs)


# ------------------------------------------------- fidelity observability

def adc_health(c: torch.Tensor, fs, bits: int | None,
               code_buckets: tuple = ()) -> dict:
    """ADC occupancy of one pass's pre-ADC column sums ``c``:
    ``saturated`` counts samples whose ideal code ``round(c / delta)``
    falls outside ``[-half, half]`` (a sample at exactly +fs rounds to
    ``half`` and is clipped one LSB by :func:`_adc`: quantization error,
    not saturation); ``occ_*`` bucket |clipped code| / half in [0, 1] on
    ``code_buckets`` (plus sum, min and max); ``peak`` is max |c|."""
    peak = c.abs().amax()
    n = c.numel()
    if bits is None:  # no ADC model: nothing saturates, no codes
        z = torch.zeros((), dtype=torch.int32, device=c.device)
        zf = torch.zeros((), dtype=torch.float32, device=c.device)
        return {"total": n, "saturated": z, "peak": peak,
                "occ_counts": torch.zeros(len(code_buckets) + 1,
                                          dtype=torch.int32, device=c.device),
                "occ_sum": zf, "occ_n": 0, "occ_min": zf, "occ_max": zf}
    half = 2.0 ** (bits - 1)
    raw = torch.round(c / (fs / half))
    occ = torch.clamp(raw, -half, half - 1.0).abs() / half
    return {
        "total": n,
        "saturated": ((raw < -half) | (raw > half)).sum(),
        "peak": peak,
        "occ_counts": mxlib.bucket_counts(occ, code_buckets),
        "occ_sum": occ.sum(),
        "occ_n": n,
        "occ_min": occ.amin(),
        "occ_max": occ.amax(),
    }


def cim_linear_fidelity(x: torch.Tensor, w: MXW, cfg: CIMConfig,
                        calib: LayerCalib, code_buckets: tuple = ()):
    """Instrumented Row-Hist forward in torch ops on ``x``'s device: ``y``
    is bitwise :func:`cim_linear` (the same walk, which only adds its
    count accumulator) and so the ``cim_linear`` kernel's, plus the
    probe's stats: ``counts`` int32 [4] (overflow, underflow_p1,
    underflow_p2, live blocks), ``pass1`` / ``pass2`` (:func:`adc_health`
    a pass), ``live_fs`` (max |column sum| over the passes: above
    ``calib.adc_fs`` means traffic drifted past calibration) and
    ``live_e_max`` (max live block-output exponent, against
    ``calib.e_n``). The ``row_hist`` strategy only."""
    if cfg.strategy != "row_hist" or calib is None:
        raise ValueError("cim_linear_fidelity takes the row_hist strategy "
                         "with its calibration")
    cx, ex, _ = _xq_blocks(x, w.codes.shape[0])
    c1, c2, cnt = _scan_blocks(
        cx, ex, w, calib.e_n, dataclasses.replace(cfg, collect_stats=True))
    y = _adc(c1, calib.adc_fs, cfg.adc_bits) * _en_scale(calib.e_n) * 0.25
    if cfg.two_pass:
        y = y + (_adc(c2, calib.adc_fs, cfg.adc_bits)
                 * _en_scale(calib.e_n, cfg.cm_bits) * 0.25)
    h1 = adc_health(c1, calib.adc_fs, cfg.adc_bits, code_buckets)
    stats = {"counts": cnt, "pass1": h1, "live_fs": h1["peak"],
             "live_e_max": _calib_max_exponent(x, w)}
    if cfg.two_pass:
        h2 = adc_health(c2, calib.adc_fs, cfg.adc_bits, code_buckets)
        stats["pass2"] = h2
        stats["live_fs"] = torch.maximum(h1["peak"], h2["peak"])
    return y.to(torch.float32), stats


# ------------------------------------------------- bias-column equivalence

def cim_linear_unsigned(x: torch.Tensor, w: MXW, cfg: CIMConfig,
                        calib: LayerCalib) -> torch.Tensor:
    """Weights stored as unsigned [0, 24] codes (w + 12), the bias term
    ``12 * sum_i x_i`` made by a bias column a block and subtracted before
    the per-block alignment (paper eq. (2)): bitwise :func:`cim_linear`,
    which proves the affine encoding and bias column exact."""
    cx, ex, nb = _xq_blocks(x, w.codes.shape[0])
    wu = (w.codes.to(torch.int16) + mxlib.WEIGHT_BIAS).to(torch.float32)
    s_u = torch.einsum("...bk,bkm->...bm", cx, wu.reshape(nb, BLOCK, -1))
    bias = cx.sum(dim=-1)[..., None] * float(mxlib.WEIGHT_BIAS)
    s = s_u - bias  # per block, before the alignment
    es = ex[..., :, None] + w.exps.to(torch.int32)
    e_n = _target_exponent(cfg, calib, es)
    cm = cfg.cm_bits
    sh = es - e_n
    a1 = torch.where(sh < -cm, 0.0,
                     s * mxlib.exp2i(torch.clamp(sh, -cm, 0)))
    y = _adc(a1.sum(dim=-2), calib.adc_fs, cfg.adc_bits) * _en_scale(e_n) \
        * 0.25
    if cfg.two_pass:
        sh2 = sh + cm
        a2 = torch.where((sh < -cm) & (sh2 >= -cm),
                         s * mxlib.exp2i(torch.clamp(sh2, -cm, 0)), 0.0)
        y = y + _adc(a2.sum(dim=-2), calib.adc_fs, cfg.adc_bits) \
            * _en_scale(e_n, cm) * 0.25
    return y.to(torch.float32)


# --------------------------------------------------- bit-plane decomposition

def bitplane_dot(cx: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """Bit-serial ``sum_i cx_i * cw_i`` with ``cx`` in [-12, 12] streamed
    as 5-bit two's-complement planes (paper eq. (1)), in f32."""
    xi = cx.to(torch.int32) & 0x1F
    cwf = cw.to(torch.float32)
    t = [(((xi >> j) & 1).to(torch.float32) * cwf).sum(dim=-1)
         for j in range(5)]
    return sum(wj * tj for wj, tj in zip((1, 2, 4, 8, -16), t))
