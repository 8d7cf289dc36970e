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

``mxfp4_ste_prequant`` is the training step's form of ``mxfp4_ste``: the
weights arrive fake-quantized once a step (``layers.common.
quantize_weights_tree``), and only the activations are fake-quantized
here.

Aliases: ``none -> float_bf16``, ``cim -> cim_analog``, ``mxfp4_digital ->
mxfp4_ste``. Unknown names raise ``ValueError``. :func:`register_backend`
adds a backend under its ``name``.
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
    """packed uint8 codes [..., K//2, N] + biased exps [..., K//32, N] ->
    bf16 [..., K, N] through the pair table, bitwise the reference's (an
    expert bank [E, K//2, N] dequantizes expert by expert alike). The
    scale 2^(b-128) is exact in bf16; for ``b <= 1`` it is the subnormal
    that the reference's platforms flush, so it is 0 here."""
    kp2, n = codes.shape[-2], codes.shape[-1]
    lead, k = tuple(codes.shape[:-2]), 2 * kp2
    pair = mxlib.pair_table(str(codes.device))[codes.long()]  # [.., K//2, N]
    cb = pair.view(torch.int16).view(torch.bfloat16)  # [.., K//2, 2N]: lo, hi
    cb = cb.reshape(lead + (kp2, n, 2)).transpose(-1, -2).reshape(
        lead + (k, n))
    b = exps.to(torch.int32)
    scale = torch.where(b <= 1, torch.zeros((), device=b.device),
                        mxlib._f32_from_field(b - 1)).to(torch.bfloat16)
    w = (cb.reshape(lead + (k // mxlib.BLOCK, mxlib.BLOCK, n))
         * scale[..., :, None, :])
    return w.reshape(lead + (k, n))


def _packed_empty(w: torch.Tensor) -> dict:
    """The packed format's tensors for ``w`` [..., K, N], unfilled."""
    *lead, k, n = w.shape
    return {"codes": torch.empty((*lead, k // 2, n), dtype=torch.uint8,
                                 device=w.device),
            "exps": torch.empty((*lead, k // mxlib.BLOCK, n),
                                dtype=torch.uint8, device=w.device)}


def _quantize_packed(w: torch.Tensor) -> dict:
    """[..., K, N] float -> packed MXFP4 {codes [..., K//2, N] uint8, exps
    [..., K//32, N] uint8 biased} quantized along K. On ``meta`` (no
    values: the dry-run's shapes) only the outputs are made."""
    if w.is_meta:
        return _packed_empty(w)
    mxq = mxlib.quantize(w.transpose(-1, -2))
    return {"codes": mxlib.pack_codes(mxq.codes).transpose(-1, -2).contiguous(),
            "exps": mxlib.exps_to_biased(mxq.exps).transpose(-1, -2)
            .contiguous()}


def quantize_bank(w: torch.Tensor) -> dict:
    """An expert bank [E, K, N] float -> packed MXFP4 {codes [E, K//2, N],
    exps [E, K//32, N]}: each expert's ``[K//2, N]`` slice is the
    resident format of the ``mxfp4_matmul`` kernel. Quantized one expert
    at a time (the blocks run along K, so this is the whole bank's
    quantization) to bound the f32 temporaries at a full-width bank."""
    out = _packed_empty(w)
    if w.is_meta:
        return out
    codes, exps = out["codes"], out["exps"]
    for i in range(w.shape[0]):
        q = _quantize_packed(w[i])
        codes[i], exps[i] = q["codes"], q["exps"]
    return {"codes": codes, "exps": exps}


def is_expert_bank(key: str, v) -> bool:
    """An MoE layer's ``w1`` / ``w2`` / ``w3`` float bank [E, K, N] with a
    32-aligned contraction dim: the conversions pack it into digital
    MXFP4 under every backend (``quantize_bank``)."""
    return (key in ("w1", "w2", "w3") and torch.is_tensor(v) and v.ndim == 3
            and v.shape[-2] % mxlib.BLOCK == 0)


def expert_weight(ctx, w) -> torch.Tensor:
    """Resolve a stacked [E, K, N] expert weight for the digital expert
    product (the reference's ``expert_weight``). Expert banks stay on the
    digital MXFP4 path under every backend: dispatch is dynamic, and the
    paper's hybrid partition keeps only static-weight linears in the
    analog array. A packed ``{codes, exps}`` bank dequantizes exactly;
    under ``mxfp4_ste`` and ``cim_analog`` a float bank is fake-quantized
    along K (one expert at a time, the same values; differentiable, STE);
    under ``mxfp4_ste_prequant`` the bank was quantized at the step
    boundary and is returned as it is (bf16); unknown backend names
    raise. bf16 out."""
    if isinstance(w, dict):  # serving-converted packed MXFP4
        return _dequant_packed(w["codes"], w["exps"])
    backend = get_backend(ctx.quant)  # raises on unknown backend names
    if backend.name not in ("mxfp4_ste", "cim_analog"):
        return w.to(torch.bfloat16)
    out = torch.empty(w.shape, dtype=torch.bfloat16, device=w.device)
    for i in range(w.shape[0]):
        out[i] = mxlib.fake_quant_axis(w[i], 0).to(torch.bfloat16)
    return out


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


def register_backend(backend: LinearBackend) -> LinearBackend:
    _REGISTRY[backend.name] = backend
    return backend


def backend_names() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(name: str) -> LinearBackend:
    key = _ALIASES.get(name, name)
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
    register_backend(cls())
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
class _MXFP4STEPrequant(LinearBackend):
    name = "mxfp4_ste_prequant"

    def forward(self, ctx, params, x):
        # the weights were fake-quantized once at the step boundary (exact:
        # they are constant within a step), so the quant runs once a step
        # and not once a microbatch
        xq = mxlib.fake_quant(x.to(torch.float32))
        return torch.matmul(xq.to(torch.bfloat16),
                            params["w"].to(torch.bfloat16))


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
    Captures stay on the device.

    ``include_converted`` also captures at converted serving nodes: the
    SQNR tracer runs the tap over the converted tree and compares
    captures path by path with a float reference run. ``cim_analog``
    codes are int8 [K, N] (K-major), ``mxfp4_wonly`` codes packed nibble
    pairs [K // 2, N]. Calibration keeps the default (float only)."""

    min_n: int = 256
    max_rows: int = 512
    records: dict = dataclasses.field(default_factory=dict)
    weights: dict = dataclasses.field(default_factory=dict)
    include_converted: bool = False

    def _in_dim(self, params) -> int | None:
        """Contraction dim of a capturable linear node, else None."""
        if not isinstance(params, dict):
            return None
        w = params.get("w")
        if w is not None and w.ndim == 2:
            k, n = w.shape
            return k if k % mxlib.BLOCK == 0 and n >= self.min_n else None
        c = params.get("codes")
        if not self.include_converted or c is None or c.ndim != 2:
            return None
        k = c.shape[0] * (1 if "e_n" in params else 2)
        return k if c.shape[1] >= self.min_n else None

    def eligible(self, params) -> bool:
        return self._in_dim(params) is not None

    def record(self, path: str, params: dict, x: torch.Tensor) -> None:
        k = self._in_dim(params)
        if k is None:
            return
        xf = x.to(torch.float32).reshape(-1, k)
        if xf.shape[0] > self.max_rows:
            idx = np.linspace(0, xf.shape[0] - 1, self.max_rows).astype(int)
            xf = xf[torch.as_tensor(idx, device=xf.device)]
        self.records.setdefault(path, []).append(xf)
        if "w" in params:
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
                       wq_cache: dict | None = None, free: bool = False):
    """Serving transform for the hybrid deployment: static linears with a
    Row-Hist calibration (keyed by param-tree path) become resident
    ``cim_analog`` nodes; MoE expert banks become packed digital MXFP4
    (dynamic dispatch stays digital: ``quantize_bank``); every other float
    leaf is cast to bf16. The port's tree keeps one dict per layer under
    ``segments[i]``. With ``free`` each layer's float dict is dropped from
    ``tree`` once it is converted, so a full-width model never holds its
    whole float tree beside the converted one (``tree`` is left with
    ``None`` for each layer)."""
    cim = _REGISTRY["cim_analog"]
    wq_cache = wq_cache or {}

    def rec(node, path):
        if isinstance(node, dict):
            w = node.get("w")
            if (w is not None and w.ndim == 2 and w.shape[0] % mxlib.BLOCK == 0
                    and w.shape[1] >= min_n and path in calibs):
                return cim.convert(node, calibs[path], wq=wq_cache.get(path))
            return {k: quantize_bank(v) if is_expert_bank(k, v)
                    else rec(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            if path.startswith("segments/"):  # one segment's layers
                out = []
                for j, p in enumerate(layer_paths(path, len(node))):
                    out.append(rec(node[j], p))
                    if free:
                        node[j] = None
                return out
            return [rec(v, f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(node)]
        if torch.is_tensor(node) and node.dtype == torch.float32:
            return node.to(torch.bfloat16)
        return node

    return rec(tree, "")
