"""Numerical-fidelity observability for the hybrid CIM stack
(counterpart of ``repro.obs.fidelity``).

Where the serving telemetry (``obs/tracing.py``) watches requests, this
module watches numerics: per-layer MXFP4 quantizer health (clip /
underflow / block-exponent occupancy), ADC code utilization and
saturation, per-layer SQNR against a reference forward, and a
calibration-drift detector that compares live Row-Hist statistics with
the stored :class:`~repro_torch.core.cim.LayerCalib`.

The :class:`FidelityProbe` attaches to ``RunCtx.fidelity`` and is called
by ``layers.common.linear_apply`` with the same scoped param-tree paths
Row-Hist calibration uses (``segments/<i>/L<j>/...``), so every metric is
keyed by the layer it describes. The probe's statistics are plain torch
ops on the activations' device, read back to the host once a linear: an
eager path only, and a call during a CUDA graph capture raises. With
``fidelity=None`` (the default) the forward is untouched.

Home of ``sqnr_db``; ``core/metrics.py`` re-exports it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.obs.log import get_logger, kv
from repro_torch.obs.profile import capturing
from repro_torch.obs.registry import EXP_BUCKETS, RATIO_BUCKETS

# backends whose forward quantizes activations to MXFP4: the ones the
# quantizer-health counters describe (weight-only and float linears leave
# activations untouched)
_ACT_QUANT_BACKENDS = ("mxfp4_ste", "mxfp4_ste_prequant", "cim_analog")

# Drift tolerances, both in tail mass (the reference's). Row-Hist
# calibrates E_N at the max live block-output exponent and adc_fs at the
# max |column sum| over the calibration batches on the digital-matched
# path, so calibration traffic overflows and saturates nothing by
# construction; but the deployed hybrid feeds each layer activations
# perturbed by upstream ADC quantization, so a thin tail legitimately
# spills over. The detector reads tail mass against these tolerances and
# publishes the peak statistics (fidelity_drift_exp_margin /
# fidelity_drift_fs_ratio) as raw gauges. A mis-scaled layer lands far
# beyond both (adc_fs/4: >10% of samples saturated a layer).
SAT_DRIFT_TOL = 0.05
OVF_DRIFT_TOL = 0.02


def sqnr_db(ref, test) -> float:
    """Signal-to-quantization-noise ratio in dB (f64 accumulation, on the
    device of ``ref`` when it is a tensor). A zero-signal ``ref`` returns
    NaN (with no signal the ratio is undefined); exact matches cap at the
    1e-30 error floor (> 200 dB)."""
    ref = torch.as_tensor(ref).to(torch.float64)
    err = torch.as_tensor(test).to(ref.device, torch.float64) - ref
    sig = float((ref ** 2).mean())
    if sig == 0.0:
        return float("nan")
    return 10 * math.log10(sig / max(float((err ** 2).mean()), 1e-30))


def sqnr_trace(ref_caps: dict, test_caps: dict) -> dict:
    """Per-path SQNR between two activation captures (from
    ``models.calibrate.capture_linear_inputs``) of the same batch: the
    tap's row subsampling is deterministic in shape, so entries compare
    element for element. Paths missing on either side or of another
    shape are left out."""
    out = {}
    for path in sorted(ref_caps):
        ref, test = ref_caps[path], test_caps.get(path)
        if test is not None and tuple(ref.shape) == tuple(test.shape):
            out[path] = sqnr_db(ref, test)
    return out


def scale_adc_fs(tree, factor: float, match: str | None = None):
    """Copy of a cim-converted param tree with its ``adc_fs`` leaves
    scaled by ``factor``: the deliberate mis-calibration that shows the
    saturation counters predict fidelity loss. ``match`` restricts it to
    nodes whose path contains the substring; a segment's layers are named
    as calibration names them (``segments/<i>/L<j>``)."""
    from repro_torch.layers.backends import layer_paths

    def rec(node, path):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "adc_fs" and (match is None or match in path):
                    out[k] = v * factor
                else:
                    out[k] = rec(v, f"{path}/{k}" if path else k)
            return out
        if isinstance(node, (list, tuple)):
            paths = (layer_paths(path, len(node))
                     if path.startswith("segments/")
                     else [f"{path}/{i}" if path else str(i)
                           for i in range(len(node))])
            return type(node)(rec(v, p) for v, p in zip(node, paths))
        return node

    return rec(tree, "")


def _to_host(tree):
    """The tensor leaves of a nest of dicts and tuples, read to the host
    in one copy: 0-d leaves become Python numbers (int for integer
    dtypes), others numpy arrays."""
    leaves: list = []

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)
        elif torch.is_tensor(node):
            leaves.append(node)

    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
    flat = flat.cpu().numpy()
    vals, at = {}, 0
    for t in leaves:
        a = flat[at:at + t.numel()]
        at += t.numel()
        if not t.is_floating_point():
            a = a.astype(np.int64)
        vals[id(t)] = a.reshape(tuple(t.shape)) if t.ndim else a[0].item()

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return vals[id(node)] if torch.is_tensor(node) else node

    return rebuild(tree)


class FidelityProbe:
    """Host-side per-layer numerical-fidelity recorder.

    Attach through ``RunCtx.fidelity``; ``linear_apply`` calls
    :meth:`observe_linear` with the calibration path of every named
    linear. Eager only: a call during a CUDA graph capture raises.

    All publishing goes through the owning :class:`~repro_torch.obs.Obs`
    handle and stops at once when ``obs.enabled`` is False, so a disabled
    probe costs one attribute check a linear.

    Published metric families (all labelled ``{layer=<path>}``):

    - ``fidelity_mxfp4_{values,clip,underflow}_total`` counters and the
      derived ``fidelity_mxfp4_{clip,underflow}_ratio`` gauges;
    - ``fidelity_block_exponent`` histogram (:data:`EXP_BUCKETS`);
    - ``adc_{saturation,samples}_total{pass=1|2}`` counters,
      ``adc_saturation_ratio`` / ``adc_fs_headroom`` gauges, and the
      ``adc_code_utilization`` histogram (:data:`RATIO_BUCKETS`);
    - ``fidelity_cim_{overflow,underflow}_ratio`` gauges (CM alignment);
    - ``fidelity_sqnr_db`` gauges through :meth:`note_sqnr`;
    - ``fidelity_drift_*`` through :meth:`drift_report`.
    """

    def __init__(self, obs=None, max_rows: int = 512):
        if obs is None:
            from repro_torch.obs.tracing import Obs

            obs = Obs()
        self.obs = obs
        self.max_rows = max_rows
        self.records: dict = {}

    @property
    def registry(self):
        return self.obs.registry

    # ------------------------------------------------------ linear hook

    def observe_linear(self, path: str, ctx, params, x) -> None:
        if not self.obs.enabled:
            return
        if capturing():
            raise RuntimeError(
                "FidelityProbe is eager-only: its statistics are read to "
                "the host, which a CUDA graph capture cannot do; got a "
                f"call during capture at layer {path!r}")
        from repro_torch.core import cim as cimlib
        from repro_torch.core import mx as mxlib
        from repro_torch.layers import backends as backends_lib

        if not isinstance(params, dict):
            return
        k = x.shape[-1]
        if k % mxlib.BLOCK:
            return
        backend = backends_lib.resolve_backend(ctx, params).name
        if backend not in _ACT_QUANT_BACKENDS:
            return  # activations stay float: nothing to probe
        xf = x.to(torch.float32).reshape(-1, k)
        if xf.shape[0] > self.max_rows:
            idx = np.linspace(0, xf.shape[0] - 1, self.max_rows).astype(int)
            xf = xf[torch.as_tensor(idx, device=xf.device)]

        h = mxlib.quant_health(xf, EXP_BUCKETS)
        stats = None
        if "e_n" in params:  # resident analog node: ADC + alignment stats
            w = mxlib.MXW(params["codes"], params["exps"])
            calib = cimlib.LayerCalib(e_n=params["e_n"],
                                      adc_fs=params["adc_fs"])
            _, stats = cimlib.cim_linear_fidelity(
                xf, w, backends_lib.cim_config(ctx), calib,
                code_buckets=RATIO_BUCKETS)
            stats.update(e_n=params["e_n"], adc_fs=params["adc_fs"])
        h, stats = _to_host((h, stats))  # the one host read a linear

        lab = {"layer": path}
        rec = self.records.setdefault(path, {})
        self._observe_quant(lab, rec, h)
        if stats is not None:
            self._observe_cim(lab, rec, stats)

    def _observe_quant(self, lab, rec, h) -> None:
        r = self.registry
        total, clip, under = (
            int(h["total"]), int(h["clipped"]), int(h["underflow"]))
        rec["act_total"] = rec.get("act_total", 0) + total
        rec["act_clipped"] = rec.get("act_clipped", 0) + clip
        rec["act_underflow"] = rec.get("act_underflow", 0) + under
        r.counter("fidelity_mxfp4_values_total",
                  "activation elements quantized", labels=lab).inc(total)
        r.counter("fidelity_mxfp4_clip_total",
                  "elements clipped to the E2M1 max magnitude",
                  labels=lab).inc(clip)
        r.counter("fidelity_mxfp4_underflow_total",
                  "nonzero elements flushed to zero by the block exponent",
                  labels=lab).inc(under)
        t = max(rec["act_total"], 1)
        r.gauge("fidelity_mxfp4_clip_ratio",
                "cumulative clip fraction", labels=lab
                ).set(rec["act_clipped"] / t)
        r.gauge("fidelity_mxfp4_underflow_ratio",
                "cumulative underflow fraction", labels=lab
                ).set(rec["act_underflow"] / t)
        r.histogram("fidelity_block_exponent",
                    "shared block exponents of live blocks (E8M0, unbiased)",
                    labels=lab, buckets=EXP_BUCKETS).merge_counts(
            h["exp_counts"], h["exp_sum"], h["exp_n"],
            h["exp_min"], h["exp_max"],
        )

    def _observe_cim(self, lab, rec, stats) -> None:
        r = self.registry
        for pname in ("1", "2"):
            h = stats.get(f"pass{pname}")
            if h is None:
                continue
            sat, n = int(h["saturated"]), int(h["total"])
            rec["adc_saturated"] = rec.get("adc_saturated", 0) + sat
            rec["adc_samples"] = rec.get("adc_samples", 0) + n
            pl = dict(lab, **{"pass": pname})
            r.counter("adc_saturation_total",
                      "column sums clipped by the ADC range",
                      labels=pl).inc(sat)
            r.counter("adc_samples_total", "column sums through the ADC",
                      labels=pl).inc(n)
            r.histogram("adc_code_utilization",
                        "|ADC code| / half-range occupancy",
                        labels=lab, buckets=RATIO_BUCKETS).merge_counts(
                h["occ_counts"], h["occ_sum"], h["occ_n"],
                h["occ_min"], h["occ_max"],
            )
        r.gauge("adc_saturation_ratio",
                "cumulative ADC saturation fraction (both passes)",
                labels=lab).set(
            rec.get("adc_saturated", 0) / max(rec.get("adc_samples", 0), 1)
        )
        # drift raw material: the live analogues of what Row-Hist stored
        rec["e_n"] = int(stats["e_n"])
        rec["adc_fs"] = float(stats["adc_fs"])
        rec["live_fs"] = max(rec.get("live_fs", 0.0), float(stats["live_fs"]))
        rec["live_e_max"] = max(rec.get("live_e_max", -(10**6)),
                                int(stats["live_e_max"]))
        r.gauge("adc_fs_headroom",
                "calibrated full scale / live peak |column sum| (<1 means "
                "traffic exceeds calibration)", labels=lab).set(
            rec["adc_fs"] / rec["live_fs"] if rec["live_fs"] > 0
            else math.inf
        )
        over, und1, und2, live = (int(c) for c in stats["counts"])
        rec["blk_overflow"] = rec.get("blk_overflow", 0) + over
        rec["blk_under1"] = rec.get("blk_under1", 0) + und1
        rec["blk_under2"] = rec.get("blk_under2", 0) + und2
        rec["blk_live"] = rec.get("blk_live", 0) + live
        bl = max(rec["blk_live"], 1)
        r.gauge("fidelity_cim_overflow_ratio",
                "blocks shift-clamped above the CM window", labels=lab
                ).set(rec["blk_overflow"] / bl)
        r.gauge("fidelity_cim_underflow_ratio",
                "blocks zeroed below the pass-2 CM window", labels=lab
                ).set(rec["blk_under2"] / bl)

    # ------------------------------------------------------ SQNR + drift

    def note_sqnr(self, per_path: dict) -> None:
        """Fold per-layer SQNR (from :func:`sqnr_trace`) into the records
        and publish ``fidelity_sqnr_db{layer=...}`` gauges."""
        if not self.obs.enabled:
            return
        for path, db in per_path.items():
            self.records.setdefault(path, {})["sqnr_db"] = float(db)
            self.registry.gauge(
                "fidelity_sqnr_db",
                "per-layer SQNR vs the reference forward",
                labels={"layer": path},
            ).set(float(db))

    def drift_report(self, log=None, sat_tol: float = SAT_DRIFT_TOL,
                     ovf_tol: float = OVF_DRIFT_TOL) -> dict:
        """Compare live Row-Hist statistics with the stored per-layer
        calibration and publish drift gauges. A layer has drifted when
        more than ``ovf_tol`` of its live blocks overflowed the stored
        ``E_N``, or more than ``sat_tol`` of its ADC samples saturated.
        The verdicts read tail mass; the peak statistics (``exp_margin`` /
        ``fs_ratio``) stay published as raw gauges (see
        :data:`SAT_DRIFT_TOL`). Replaying the calibration batches never
        fires. Emits one structured warning a drifted layer and returns
        ``{"layers": {...}, "drifted": [...], "n_drifted": int}``."""
        if not self.obs.enabled:
            return {"layers": {}, "drifted": [], "n_drifted": 0}
        r = self.registry
        layers: dict = {}
        drifted: list = []
        for path in sorted(self.records):
            rec = self.records[path]
            if "e_n" not in rec:
                continue
            exp_margin = rec["e_n"] - rec["live_e_max"]
            fs_ratio = (rec["adc_fs"] / rec["live_fs"]
                        if rec["live_fs"] > 0 else math.inf)
            n = rec.get("adc_samples", 0)
            sat_ratio = rec.get("adc_saturated", 0) / n if n else 0.0
            live = rec.get("blk_live", 0)
            ovf_ratio = rec.get("blk_overflow", 0) / live if live else 0.0
            is_drifted = sat_ratio > sat_tol or ovf_ratio > ovf_tol
            lab = {"layer": path}
            r.gauge("fidelity_drift_exp_margin",
                    "stored E_N minus live max block-output exponent "
                    "(negative: drifted)", labels=lab).set(exp_margin)
            r.gauge("fidelity_drift_fs_ratio",
                    "calibrated ADC full scale / live peak (<1: drifted)",
                    labels=lab).set(fs_ratio)
            layers[path] = {
                "exp_margin": exp_margin,
                "fs_ratio": fs_ratio,
                "sat_ratio": sat_ratio,
                "ovf_ratio": ovf_ratio,
                "drifted": is_drifted,
            }
            if is_drifted:
                drifted.append(path)
                r.counter("fidelity_drift_total",
                          "layers whose live range exceeded calibration"
                          ).inc()
                (log or get_logger("repro_torch.fidelity")).warning(
                    "calibration drift: %s",
                    kv(layer=path, exp_margin=exp_margin,
                       fs_ratio=fs_ratio, sat_ratio=sat_ratio,
                       ovf_ratio=ovf_ratio,
                       e_n=rec["e_n"], live_e_max=rec["live_e_max"],
                       adc_fs=rec["adc_fs"], live_fs=rec["live_fs"]),
                )
        return {"layers": layers, "drifted": drifted,
                "n_drifted": len(drifted)}

    def summary(self) -> dict:
        """JSON-able per-layer digest of everything recorded so far."""
        out: dict = {}
        for path in sorted(self.records):
            rec = self.records[path]
            e: dict = {}
            t = rec.get("act_total", 0)
            if t:
                e["clip_ratio"] = rec.get("act_clipped", 0) / t
                e["underflow_ratio"] = rec.get("act_underflow", 0) / t
            n = rec.get("adc_samples", 0)
            if n:
                e["adc_saturation_ratio"] = rec.get("adc_saturated", 0) / n
            if "e_n" in rec:
                e["exp_margin"] = rec["e_n"] - rec["live_e_max"]
                e["fs_headroom"] = (rec["adc_fs"] / rec["live_fs"]
                                    if rec["live_fs"] > 0 else math.inf)
            if "sqnr_db" in rec:
                e["sqnr_db"] = rec["sqnr_db"]
            out[path] = e
        return out


def run_fidelity_pass(ref_params, params, cfg, ctx, batch, *, obs=None,
                      probe: FidelityProbe | None = None, forward_fn=None,
                      ref_quant: str = "mxfp4_digital", quant: str = "cim",
                      min_n: int = 32, max_rows: int = 512) -> tuple:
    """The per-layer SQNR trace, health probe and drift check in two eager
    forwards of one batch:

    1. a reference forward of ``ref_params`` (the float tree) on the
       ``ref_quant`` backend, capturing each linear's input;
    2. an instrumented forward of ``params`` (the converted serving tree)
       with a :class:`FidelityProbe` attached, capturing at the same
       paths.

    Per-path SQNR between the captures (and of the model output) is
    published as ``fidelity_sqnr_db{layer=...}``; the probe publishes
    quantizer / ADC health; :meth:`FidelityProbe.drift_report` closes the
    pass. Returns ``(probe, report)``, ``report`` holding ``sqnr_db`` a
    path, the drift report and the per-layer summary."""
    from repro_torch.models import calibrate

    if probe is None:
        probe = FidelityProbe(obs=obs, max_rows=max_rows)
    ref_caps, ref_out = calibrate.capture_linear_inputs(
        ref_params, cfg, ctx, batch, quant=ref_quant,
        min_n=min_n, max_rows=max_rows, forward_fn=forward_fn)
    caps, out = calibrate.capture_linear_inputs(
        params, cfg, ctx, batch, quant=quant,
        min_n=min_n, max_rows=max_rows, forward_fn=forward_fn,
        fidelity=probe)
    per = sqnr_trace(ref_caps, caps)
    ref_y = ref_out[0] if isinstance(ref_out, tuple) else ref_out
    y = out[0] if isinstance(out, tuple) else out
    per["output"] = sqnr_db(ref_y, y)
    probe.note_sqnr(per)
    drift = probe.drift_report()
    report = {"sqnr_db": per, "drift": drift, "layers": probe.summary()}
    return probe, report
