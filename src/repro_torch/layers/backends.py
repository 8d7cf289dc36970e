"""Pluggable linear-execution backends (the paper's hybrid partition),
counterpart of ``repro.layers.backends``.

==================  =======================================================
``float_bf16``      unquantized BF16 matmul
``mxfp4_ste``       fake-quant of weights + activations (STE); with the
                    digital MXFP4 SDPA this is the ``mxfp4_digital`` mode
``mxfp4_wonly``     weight-only packed MXFP4 (4.25 b/param resident); the
                    hand-written ``mxfp4_matmul`` kernel on CUDA
``cim_analog``      analog CTT-CIM array: resident INT5 codes, per-block
                    exponents, Row-Hist ``LayerCalib`` (paper §3, §5.2.2)
==================  =======================================================

Aliases: ``none -> float_bf16``, ``cim -> cim_analog``, ``mxfp4_digital ->
mxfp4_ste``. Unknown names raise ``ValueError``. ``mxfp4_ste_prequant``
(training) is not ported yet and raises ``NotImplementedError``; it does
not fall through to float.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cim as cimlib
from repro_torch.core import mx as mxlib
from repro_torch.kernels.cim_linear import ops as cim_ops
from repro_torch.kernels.mxfp4_matmul import ops as mm_ops


# ----------------------------------------------------------- param packing

def _dequant_packed(codes: torch.Tensor, exps: torch.Tensor) -> torch.Tensor:
    """packed uint8 codes [K//2, N] + biased exps [K//32, N] -> bf16 [K, N]
    through the pair table, bitwise the reference's. The scale 2^(b-128)
    is exact in bf16; for ``b <= 1`` it is the subnormal that the
    reference's platforms flush, so it is 0 here."""
    kp2, n = codes.shape[-2], codes.shape[-1]
    k = 2 * kp2
    pair = mxlib.pair_table(str(codes.device))[codes.long()]  # [K//2, N]
    cb = pair.view(torch.int16).view(torch.bfloat16)  # [K//2, 2N]: lo, hi
    cb = cb.reshape(kp2, n, 2).transpose(-1, -2).reshape(k, n)
    b = exps.to(torch.int32)
    scale = torch.where(b <= 1, torch.zeros((), device=b.device),
                        mxlib._f32_from_field(b - 1)).to(torch.bfloat16)
    w = cb.reshape(k // mxlib.BLOCK, mxlib.BLOCK, n) * scale[:, None, :]
    return w.reshape(k, n)


def _quantize_packed(w: torch.Tensor) -> dict:
    """[K, N] float -> packed MXFP4 {codes [K//2, N] uint8, exps [K//32, N]
    uint8 biased} quantized along K."""
    mxq = mxlib.quantize(w.transpose(-1, -2))
    return {"codes": mxlib.pack_codes(mxq.codes).transpose(-1, -2).contiguous(),
            "exps": mxlib.exps_to_biased(mxq.exps).transpose(-1, -2)
            .contiguous()}


def quantize_linear_params(params: dict) -> dict:
    """Convert a float linear param dict to packed MXFP4 (weight-only);
    the bias stays as it is, as in the reference."""
    out = _quantize_packed(params["w"])
    if "b" in params:
        out["b"] = params["b"]
    return out


class LinearBackend:
    """One linear-execution strategy."""

    name = "?"

    def handles(self, params: dict) -> bool:
        """True if ``params`` is this backend's converted serving node."""
        return False

    def forward(self, ctx, params: dict, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


_REGISTRY: dict[str, LinearBackend] = {}
_ALIASES = {"none": "float_bf16", "cim": "cim_analog",
            "mxfp4_digital": "mxfp4_ste"}
_NOT_PORTED = ("mxfp4_ste_prequant",)


def backend_names() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(name: str) -> LinearBackend:
    key = _ALIASES.get(name, name)
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"linear backend {name!r} is not ported yet (ROADMAP.md Queue 1)")
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown linear-execution backend {name!r}; known: "
            f"{backend_names()} (aliases {sorted(_ALIASES)})")
    return _REGISTRY[key]


def resolve_backend(ctx, params: dict) -> LinearBackend:
    """Converted-param markers win, in the reference's order (what is
    resident decides execution: a packed node runs weight-only whatever
    ``ctx.quant`` says); otherwise ``ctx.quant`` names the backend."""
    for marker in ("cim_analog", "mxfp4_wonly"):
        if _REGISTRY[marker].handles(params):
            return _REGISTRY[marker]
    return get_backend(ctx.quant)


def cim_config(ctx) -> cimlib.CIMConfig:
    """The run's CIM config (paper operating point unless overridden:
    10b ADC, CM=3, Row-Hist 2-pass)."""
    return ctx.cim if ctx.cim is not None else cimlib.CIMConfig()


def _register(cls):
    _REGISTRY[cls.name] = cls()
    return cls


@_register
class _FloatBF16(LinearBackend):
    name = "float_bf16"

    def forward(self, ctx, params, x):
        return torch.matmul(x.to(torch.bfloat16),
                            params["w"].to(torch.bfloat16))


@_register
class _MXFP4STE(LinearBackend):
    name = "mxfp4_ste"

    def forward(self, ctx, params, x):
        wq = mxlib.fake_quant_axis(params["w"], 0)
        xq = mxlib.fake_quant(x.to(torch.float32))
        return torch.matmul(xq.to(torch.bfloat16), wq.to(torch.bfloat16))


@_register
class _MXFP4WeightOnly(LinearBackend):
    """Weight-only packed MXFP4. Converted node: ``codes`` uint8 [K//2, N],
    ``exps`` uint8 [K//32, N] biased E8M0, optional ``b``."""

    name = "mxfp4_wonly"

    def handles(self, params):
        return "codes" in params and "e_n" not in params

    def convert(self, params) -> dict:
        return quantize_linear_params(params)

    def forward(self, ctx, params, x):
        if "codes" not in params:
            # not converted (eval on a float tree): weight-only quantization
            # happens at convert time, so this is the plain bf16 matmul
            return _REGISTRY["float_bf16"].forward(ctx, params, x)
        if ctx.impl == "ref":
            w = _dequant_packed(params["codes"], params["exps"])
            return torch.matmul(x.to(torch.bfloat16), w)
        return mm_ops.mxfp4_matmul(x, params["codes"], params["exps"],
                                   obs=ctx.obs)


@_register
class _CIMAnalog(LinearBackend):
    """Analog CTT-CIM execution of a static linear. Converted node:
    ``codes`` int8 [K, N], ``exps`` int8 [K//32, N], both K-major (the
    kernel's layout, ``core.mx.MXW``), ``e_n`` int32 [], ``adc_fs`` f32
    [], optional ``b`` (bf16, added after read-out)."""

    name = "cim_analog"

    def handles(self, params):
        return "e_n" in params

    def convert(self, params, calib: cimlib.LayerCalib,
                wq: mxlib.MXW | None = None) -> dict:
        if wq is None:
            wq = mxlib.quantize_w(params["w"].to(torch.float32))
        out = {"codes": mxlib.kmajor(wq.codes),
               "exps": mxlib.kmajor(wq.exps),
               "e_n": calib.e_n.to(torch.int32),
               "adc_fs": calib.adc_fs.to(torch.float32)}
        if "b" in params:
            out["b"] = params["b"].to(torch.bfloat16)
        return out

    def forward(self, ctx, params, x):
        if "e_n" not in params:
            # linears without a resident analog copy run on the digital
            # MXFP4 W+A path, as in the reference
            return _REGISTRY["mxfp4_ste"].forward(ctx, params, x)
        cfg = cim_config(ctx)
        w = mxlib.MXW(params["codes"], params["exps"])
        calib = cimlib.LayerCalib(e_n=params["e_n"], adc_fs=params["adc_fs"])
        if ctx.impl == "ref":
            y, _ = cimlib.cim_linear(x, w, cfg, calib)
        else:
            y = cim_ops.cim_linear(x, w, calib, cfg=cfg, obs=ctx.obs)
        return y.to(torch.bfloat16)


# --------------------------------------------------- Row-Hist calibration

@dataclasses.dataclass
class ActivationTap:
    """Records per-linear input activations during a capture run, keyed by
    param-tree path. Only static analog candidates are kept: 2-D weights
    with a 32-aligned contraction dim and at least ``min_n`` outputs. Rows
    are subsampled to ``max_rows`` per call, deterministically in shape.
    Captures stay on the device."""

    min_n: int = 256
    max_rows: int = 512
    records: dict = dataclasses.field(default_factory=dict)
    weights: dict = dataclasses.field(default_factory=dict)

    def eligible(self, params) -> bool:
        w = params.get("w") if isinstance(params, dict) else None
        return (w is not None and w.ndim == 2
                and w.shape[0] % mxlib.BLOCK == 0 and w.shape[1] >= self.min_n)

    def record(self, path: str, params: dict, x: torch.Tensor) -> None:
        if not self.eligible(params):
            return
        k = params["w"].shape[0]
        xf = x.to(torch.float32).reshape(-1, k)
        if xf.shape[0] > self.max_rows:
            idx = np.linspace(0, xf.shape[0] - 1, self.max_rows).astype(int)
            xf = xf[torch.as_tensor(idx, device=xf.device)]
        self.records.setdefault(path, []).append(xf)
        self.weights[path] = params["w"]


def calibrate_taps(tap: ActivationTap, cfg: cimlib.CIMConfig | None = None,
                   wq_cache: dict | None = None) -> dict:
    """Row-Hist calibration of every tapped linear: ``{path: LayerCalib}``.
    Pass a dict as ``wq_cache`` to receive each path's quantized weight."""
    cfg = cfg or cimlib.CIMConfig()
    out = {}
    for path, xs in tap.records.items():
        wq = mxlib.quantize_w(tap.weights[path].to(torch.float32))
        if wq_cache is not None:
            wq_cache[path] = wq
        out[path] = cimlib.calibrate_rowhist(xs, wq, cfg)
    return out


def layer_paths(path: str, n: int) -> list[str]:
    """Capture scope of each layer of a segment: ``segments/<i>/L<j>``
    for a run of layers, ``segments/<i>`` for a single one (the
    reference's stacked-vs-unstacked scoping)."""
    return [f"{path}/L{j}" for j in range(n)] if n > 1 else [path]


def convert_params_cim(tree, calibs: dict, min_n: int = 256,
                       wq_cache: dict | None = None):
    """Serving transform for the hybrid deployment: static linears with a
    Row-Hist calibration (keyed by param-tree path) become resident
    ``cim_analog`` nodes; every other float leaf is cast to bf16. The
    port's tree keeps one dict per layer under ``segments[i]``."""
    cim = _REGISTRY["cim_analog"]
    wq_cache = wq_cache or {}

    def rec(node, path):
        if isinstance(node, dict):
            w = node.get("w")
            if (w is not None and w.ndim == 2 and w.shape[0] % mxlib.BLOCK == 0
                    and w.shape[1] >= min_n and path in calibs):
                return cim.convert(node, calibs[path], wq=wq_cache.get(path))
            return {k: rec(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            if path.startswith("segments/"):  # one segment's layers
                return [rec(v, p) for v, p in
                        zip(node, layer_paths(path, len(node)))]
            return [rec(v, f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(node)]
        if torch.is_tensor(node) and node.dtype == torch.float32:
            return node.to(torch.bfloat16)
        return node

    return rec(tree, "")
