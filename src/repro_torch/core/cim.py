"""Analog CTT-CIM datapath simulation (paper §3, §5.2.2).

PyTorch counterpart of ``repro.core.cim``: a CIM linear ``y = x @ w``
with ``w`` resident as MXFP4 INT5 codes, ``x`` block-quantized per
(row, 32-block), each block's exact integer partial aligned to the
per-layer Row-Hist target exponent ``E_N`` under a ``CM``-bit mirror
window (underflow to zero below, clamp above), the optional second pass
at ``E_N - CM``, and an n-bit ADC per (pass, column) sum.

Only the offline-calibrated ``row_hist`` strategy (the serving hot path)
is ported; the online ``row0`` / ``row_opt`` baselines are listed in
ROADMAP.md. Blocks are taken in ascending order with one running f32 sum
per pass, the accumulation order of the reference's scan, so the result
is bitwise the reference's.
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


def _check_strategy(cfg: CIMConfig) -> None:
    if cfg.strategy != "row_hist":
        raise NotImplementedError(
            f"CIM strategy {cfg.strategy!r} is not ported (only the "
            "offline row_hist strategy is; see ROADMAP.md Queue 1)"
        )


def _adc(c: torch.Tensor, fs: torch.Tensor, bits: int | None) -> torch.Tensor:
    if bits is None:
        return c
    half = 2.0 ** (bits - 1)
    delta = fs / half
    q = torch.clamp(torch.round(c / delta), -half, half - 1.0)
    return q * delta


def _en_scale(e_n, delta: int = 0) -> torch.Tensor:
    """2^(E_N - delta), exact."""
    return mxlib.exp2i(torch.as_tensor(e_n).to(torch.int32) - delta)


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
    wc = w.codes.to(torch.float32).reshape(nb, BLOCK, -1)
    e_n = torch.as_tensor(e_n, device=cx.device).to(torch.int32)
    u = mxlib.exp2i(ex - e_n)  # [..., nb]
    v = mxlib.exp2i(w.exps.to(torch.int32))  # [nb, N]
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
    """Analog CIM forward. Returns (y [..., N] float32, stats dict)."""
    _check_strategy(cfg)
    if calib is None:
        raise ValueError("row_hist needs offline calibration (calib=None)")
    cx, ex, _ = _xq_blocks(x, w.codes.shape[0])
    c1, c2, cnt = _scan_blocks(cx, ex, w, calib.e_n, cfg)
    y = _adc(c1, calib.adc_fs, cfg.adc_bits) * _en_scale(calib.e_n) * 0.25
    if cfg.two_pass:
        y = y + (_adc(c2, calib.adc_fs, cfg.adc_bits)
                 * _en_scale(calib.e_n, cfg.cm_bits) * 0.25)
    stats = {}
    if cfg.collect_stats:
        tot = torch.clamp(cnt[3], min=1)
        stats = {
            "overflow_rate": cnt[0] / tot,
            "underflow_rate_p1": cnt[1] / tot,
            "underflow_rate_p2": cnt[2] / tot,
        }
    return y.to(torch.float32), stats


# ------------------------------------------------------------ calibration

def _calib_max_exponent(x: torch.Tensor, w: MXW) -> torch.Tensor:
    """Max live block-output exponent over one batch (int32 [] on the
    activations' device; no host read)."""
    cx, ex, nb = _xq_blocks(x, w.codes.shape[0])
    wc = w.codes.to(torch.float32).reshape(nb, BLOCK, -1)
    we = w.exps.to(torch.int32)
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


def calibrate_rowhist(batches, w: MXW, cfg: CIMConfig,
                      percentile: float = 100.0) -> LayerCalib:
    """Offline Row-Hist calibration (paper §3.2.1): the per-layer target
    exponent is the max live block-output exponent over the batches (zero
    overflow), then the ADC full scale is calibrated at that E_N."""
    if percentile < 100.0:
        raise NotImplementedError(
            "percentile Row-Hist calibration is not ported (ROADMAP.md "
            "Queue 1)"
        )
    e_n = None
    for xb in batches:
        m = _calib_max_exponent(xb, w)
        e_n = m if e_n is None else torch.maximum(e_n, m)
    e_n = e_n.to(torch.int32)
    fs = torch.zeros((), dtype=torch.float32, device=e_n.device)
    for xb in batches:
        fs = torch.maximum(fs, _calib_full_scale(xb, w, e_n, cfg))
    return LayerCalib(e_n=e_n, adc_fs=fs)
