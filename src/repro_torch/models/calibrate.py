"""Model-wide Row-Hist calibration + hybrid analog/digital conversion
(counterpart of ``repro.models.calibrate``).

Representative batches run through the model with an activation tap on
the digital MXFP4 path (the distribution each analog layer sees at
serving time); each static linear gets its target exponent ``E_N`` and
ADC full scale; the weights become resident INT5 codes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import cim as cimlib
from repro_torch.layers import backends
from repro_torch.layers.common import RunCtx
from repro_torch.models import lm


def capture_rowhist_calibration(params, cfg, ctx: RunCtx, batches, *,
                                cim_cfg: cimlib.CIMConfig | None = None,
                                min_n: int = 256, max_rows: int = 512,
                                calib_quant: str = "mxfp4_digital",
                                wq_cache: dict | None = None,
                                forward_fn=None) -> dict:
    """``{param-tree path: LayerCalib}`` for every static analog-eligible
    linear, from ``batches`` (model-input dicts) run on ``calib_quant``
    through ``forward_fn(params, cfg, ctx, batch)`` (default
    ``lm.forward``; ``vit.forward`` for the encoder)."""
    forward_fn = forward_fn or lm.forward
    tap = backends.ActivationTap(min_n=min_n, max_rows=max_rows)
    cap_ctx = dataclasses.replace(ctx, quant=calib_quant, tap=tap, scope="")
    with torch.no_grad():
        for batch in batches:
            forward_fn(params, cfg, cap_ctx, batch)
        return backends.calibrate_taps(tap, cim_cfg or cimlib.CIMConfig(),
                                       wq_cache=wq_cache)


def capture_linear_inputs(params, cfg, ctx: RunCtx, batch, *,
                          quant: str | None = None, min_n: int = 32,
                          max_rows: int = 512, forward_fn=None,
                          fidelity=None):
    """One eager forward with an ``include_converted`` ActivationTap:
    ``({param-tree path: f32 [rows, k] activations on the device},
    output)``, the raw material of the per-layer SQNR tracer. Run it once
    on a reference tree and backend and once on the instrumented one, then
    compare the captures path by path (``obs.fidelity.sqnr_trace``): the
    tap's row subsampling is deterministic in shape, so both runs keep the
    same rows. A path visited more than once records each visit,
    concatenated here in visit order.

    ``quant=None`` keeps ``ctx.quant``; pass a ``FidelityProbe`` as
    ``fidelity`` to collect quantizer / ADC health in the same forward."""
    forward_fn = forward_fn or lm.forward
    tap = backends.ActivationTap(min_n=min_n, max_rows=max_rows,
                                 include_converted=True)
    rep: dict = {"tap": tap, "scope": ""}
    if quant is not None:
        rep["quant"] = quant
    if fidelity is not None:
        rep["fidelity"] = fidelity
    with torch.no_grad():
        out = forward_fn(params, cfg, dataclasses.replace(ctx, **rep), batch)
    caps = {path: torch.cat(xs, dim=0) for path, xs in tap.records.items()}
    return caps, out


def convert_model_cim(params, cfg, ctx: RunCtx, batches, *,
                      cim_cfg: cimlib.CIMConfig | None = None,
                      min_n: int = 256, max_rows: int = 512,
                      forward_fn=None, free: bool = False):
    """Capture -> Row-Hist calibrate -> convert. Returns
    ``(converted_params, calibs)``; serve with ``RunCtx(quant="cim",
    cim=cim_cfg)``. ``forward_fn`` selects the model family (default
    ``lm.forward``, see :func:`capture_rowhist_calibration`). Taps see
    only the 2-D static linears that run through ``linear_apply``: an MoE
    layer's router and expert banks are not tapped (the banks become
    packed digital MXFP4). ``free`` drops each float layer of ``params``
    once it is converted (``backends.convert_params_cim``)."""
    cim_cfg = cim_cfg or cimlib.CIMConfig()
    wq_cache: dict = {}
    calibs = capture_rowhist_calibration(
        params, cfg, ctx, batches, cim_cfg=cim_cfg, min_n=min_n,
        max_rows=max_rows, wq_cache=wq_cache, forward_fn=forward_fn)
    conv = backends.convert_params_cim(params, calibs, min_n=min_n,
                                       wq_cache=wq_cache, free=free)
    return conv, calibs


def calibration_batches(cfg, n_batches: int = 4, batch: int = 4,
                        seq: int = 32, seed: int = 1234, device=None):
    """Synthetic representative batches (random token ids) from a seeded
    ``torch.Generator`` (not the reference's jax.random stream), on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"`` is given)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return [{"ids": torch.randint(0, cfg.vocab_size, (batch, seq),
                                  generator=gen, device=device)}
            for _ in range(n_batches)]
