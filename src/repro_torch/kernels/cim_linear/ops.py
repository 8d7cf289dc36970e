"""Wrapper for the fused CIM kernel (``csrc/cim_linear.cu``): raw
activations in (the MXFP4 activation quantize runs inside the kernel)
against resident INT5 weight codes + per-block exponents and the layer's
Row-Hist calibration.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise. ``cim_linear.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import cim as cimlib
from repro_torch.core import mx as mxlib
from repro_torch.kernels import _build
from repro_torch.kernels.cim_linear.ref import cim_linear_ref
from repro_torch.obs.profile import profiled_call

BM = 8  # the kernel's row tile: M pads up to it, never shrinks
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def calib_buffer(calib: cimlib.LayerCalib) -> torch.Tensor:
    """(E_N, adc_fs) as a 2-float tensor on the calibration's device — the
    kernel reads it from device memory, so no host sync per linear."""
    return torch.stack((calib.e_n.to(torch.float32),
                        calib.adc_fs.to(torch.float32)))


def _launch(xm, w: mxlib.MXW, cal, cfg: cimlib.CIMConfig) -> torch.Tensor:
    m, k = xm.shape
    n = w.codes.shape[1]
    if k % mxlib.BLOCK or n % 4:
        raise ValueError(f"cim_linear kernel needs K % 32 == 0 and "
                         f"N % 4 == 0, got K={k} N={n}")
    for t, name in ((w.codes, "codes"), (w.exps, "exps"), (cal, "calib")):
        if t.device != xm.device or not t.is_contiguous():
            raise ValueError(f"cim_linear: {name} must be contiguous on "
                             f"{xm.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=xm.device)
    fn = _build.function("cim_linear", "cim_linear_launch", _ARGTYPES)
    cm = cfg.cm_bits
    err = fn(xm.data_ptr(), w.codes.data_ptr(), w.exps.data_ptr(),
             cal.data_ptr(), out.data_ptr(), m, k, n,
             2.0 ** -cm, 2.0 ** -(2 * cm), 2.0 ** cm, cm,
             -1 if cfg.adc_bits is None else cfg.adc_bits,
             int(cfg.two_pass), torch.cuda.current_stream(xm.device).cuda_stream)
    cim_linear.launches += 1
    _build.check(err, "cim_linear")
    return out


def cim_linear(x: torch.Tensor, w: mxlib.MXW, calib: cimlib.LayerCalib, *,
               cfg: cimlib.CIMConfig | None = None, obs=None) -> torch.Tensor:
    """x [..., K] float -> [..., N] f32 through the analog CIM datapath."""
    cfg = cfg or cimlib.CIMConfig()
    if cfg.strategy != "row_hist" or cfg.collect_stats:
        raise ValueError("the CIM kernel runs the row_hist strategy only, "
                         "without stats")
    if x.device.type == "cpu":
        return profiled_call("cim_linear.ref", obs,
                             lambda: cim_linear_ref(x, w, calib, cfg))
    if x.device.type != "cuda":
        raise ValueError(f"cim_linear: unsupported device {x.device}")
    k, n = w.codes.shape
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])[:, :k].to(torch.float32)
    m = xm.shape[0]
    pm = -m % BM
    pk = k - xm.shape[1]  # activations shorter than the padded weight K
    if pm or pk:
        xm = F.pad(xm, (0, pk, 0, pm))
    out = profiled_call("cim_linear", obs, lambda: _launch(
        xm.contiguous(), w, calib_buffer(calib), cfg))
    return out[:m].reshape(lead + (n,))


cim_linear.launches = 0
