"""The port's numerical-fidelity observability against the JAX reference.

- ``cim_linear_fidelity``: ``y`` bitwise the port's ``cim_linear`` (and
  so the kernel's plain version), its stats (alignment counts, both ADC
  passes' health, ``live_fs``, ``live_e_max``) equal to the reference's on
  the same inputs and calibration; an under-scaled full scale saturates
  and costs SQNR in the same run.
- ``tests/test_fidelity.py`` one for one: zero-signal SQNR is NaN,
  ``sqnr_trace`` pairs paths of equal shape, ``bucket_counts`` is
  ``bisect_left``, ``merge_counts`` accumulates, quantizer health counts,
  the disabled-``Obs`` probe is a no-op, ``scale_adc_fs`` with ``match``
  (on the port's per-layer tree, by calibration paths), a NaN gauge
  survives export.
- Tiny h2o-danube-1.8b, the reference's float and Row-Hist-converted
  trees carried across by ``from_reference``: ``run_fidelity_pass`` in
  both packages on the first calibration batch covers every calibrated
  path, gives output SQNR > 5 dB and no drift; under ``adc_fs / 4`` it
  trips drift on the reference's paths, each saturating > 5%, with output
  SQNR 3 dB lower or more; per-path SQNR within 1 dB of the reference's.
  The tap's converted captures (int8 K-major CIM codes, packed MXFP4
  nibbles) key the reference's paths.
- The probe raises during a CUDA graph capture (``cuda`` marker; on the
  CPU the same check through a stand-in); ``Engine.trace`` is the
  reference's tuple view; ``--profile`` counts and times eager calls.
- The launcher on the CPU: ``--backend cim --fidelity --metrics-out``
  writes the ``fidelity_*`` and ``adc_*`` families; ``--impl ref``,
  ``--profile`` and ``--log-every`` work; the vision path's
  ``--backend mxfp4 --fidelity`` probes packed linears.
"""

import dataclasses
import io
import logging
import types
from bisect import bisect_left

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import cim as jcim  # noqa: E402
from repro.core import mx as jmx  # noqa: E402
from repro.layers import backends as jbackends  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.models import calibrate as jcalibrate  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers import common as tcommon  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.obs import EXP_BUCKETS, RATIO_BUCKETS  # noqa: E402
from repro_torch.obs import fidelity as tfid  # noqa: E402
from repro_torch.obs.profile import profiled_call  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

ARCH = "h2o-danube-1.8b"
HEALTH = ("total", "saturated", "occ_counts", "occ_n", "peak", "occ_min",
          "occ_max")


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ sqnr sentinel

def test_sqnr_all_zero_reference_is_nan():
    assert np.isnan(tobs.sqnr_db(np.zeros(8), np.ones(8)))
    assert np.isnan(tobs.sqnr_db(np.zeros(8), np.zeros(8)))
    assert np.isfinite(tobs.sqnr_db(np.ones(8), np.ones(8) * 1.01))
    assert tmetrics.sqnr_db is tobs.sqnr_db
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(50), rng.standard_normal(50)
    assert tobs.sqnr_db(_t(a), _t(b)) == pytest.approx(jobs.sqnr_db(a, b),
                                                       rel=1e-12)


def test_sqnr_trace_matches_paths_with_equal_shapes():
    a = {"x": np.ones((4, 8)), "y": np.ones((2, 8)), "only_ref": np.ones(3)}
    b = {"x": np.ones((4, 8)) * 1.1, "y": np.ones((3, 8))}
    per = tobs.sqnr_trace(a, b)
    assert set(per) == {"x"}  # "y" shape mismatch, "only_ref" unmatched
    assert per["x"] == pytest.approx(jobs.sqnr_trace(a, b)["x"], rel=1e-12)


# ------------------------------------------------- device/host histograms

def test_bucket_counts_matches_host_bisect():
    rng = np.random.default_rng(0)
    v = rng.integers(-30, 30, size=257).astype(np.float32)
    dev = tmx.bucket_counts(_t(v), EXP_BUCKETS).numpy()
    host = np.zeros(len(EXP_BUCKETS) + 1, np.int64)
    for x in v:
        host[bisect_left(EXP_BUCKETS, x)] += 1
    assert (dev == host).all()
    assert dev.sum() == v.size


def test_histogram_merge_counts_accumulates():
    reg = tobs.MetricsRegistry()
    h = reg.histogram("h", "t", buckets=RATIO_BUCKETS)
    counts = np.zeros(len(RATIO_BUCKETS) + 1, np.int64)
    counts[0], counts[-1] = 3, 1
    h.merge_counts(counts, sum=1.3, count=4, vmin=0.01, vmax=1.7)
    h.merge_counts(counts, sum=1.3, count=4, vmin=0.005, vmax=1.2)
    assert h.count == 8 and h.sum == pytest.approx(2.6)
    assert h.min == pytest.approx(0.005) and h.max == pytest.approx(1.7)
    assert h.counts[0] == 6 and h.counts[-1] == 2
    with pytest.raises(ValueError):
        h.merge_counts(counts[:-1], sum=0.0, count=1, vmin=0.0, vmax=0.0)
    h.merge_counts(np.zeros_like(counts), sum=0.0, count=0, vmin=9.0,
                   vmax=-9.0)
    assert h.count == 8 and h.max == pytest.approx(1.7)


# ----------------------------------------------------- quantizer health

def test_quant_health_counts_clip_and_underflow():
    x = np.zeros((2, tmx.BLOCK), np.float32)
    x[0, 0] = 1.0
    x[0, 1] = 1e-8   # underflows to zero code next to a 1.0 block max
    x[1, :] = 3e38   # beyond FP4_MAX * 2^125 (the biased-exponent clamp)
    h = tmx.quant_health(_t(x), EXP_BUCKETS)
    assert h["total"] == 2 * tmx.BLOCK
    assert int(h["underflow"]) == 1
    assert int(h["clipped"]) == tmx.BLOCK
    assert int(h["exp_n"]) == 2
    assert int(h["exp_min"]) == -2 and int(h["exp_max"]) == 125
    assert int(h["exp_counts"].sum()) == 2
    z = tmx.quant_health(torch.zeros((1, tmx.BLOCK)), EXP_BUCKETS)
    assert int(z["underflow"]) == 0 and int(z["clipped"]) == 0
    assert int(z["exp_n"]) == 0


# ------------------------------------- single-layer ADC health + bitwise

def _layer_setup(seed=0, t=32, k=64, m=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, k)).astype(np.float32)
    w = (rng.standard_normal((k, m)) / np.sqrt(k)).astype(np.float32)
    tw = tmx.quantize_w(_t(w))
    cfg = tcim.CIMConfig()
    calib = tcim.calibrate_rowhist([_t(x)], tw, cfg)
    return x, w, tw, cfg, calib


def _assert_stats_equal(got, ref, two_pass):
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(ref["counts"]))
    assert int(got["live_e_max"]) == int(ref["live_e_max"])
    assert float(got["live_fs"]) == float(ref["live_fs"])
    for p in ("pass1", "pass2") if two_pass else ("pass1",):
        for key in HEALTH:
            np.testing.assert_array_equal(np.asarray(got[p][key]),
                                          np.asarray(ref[p][key]),
                                          err_msg=f"{p} {key}")
        assert float(got[p]["occ_sum"]) == pytest.approx(
            float(ref[p]["occ_sum"]), rel=1e-6)
    assert ("pass2" in got) == two_pass == ("pass2" in ref)


@pytest.mark.parametrize("adc,cm,two,scale", [
    (10, 3, True, 1.0), (10, 3, True, 0.25), (None, 2, False, 1.0),
    (8, 4, True, 0.5)])
def test_fidelity_linear_is_bitwise_cim_linear_and_the_reference(
        adc, cm, two, scale):
    x, w, tw, _, _ = _layer_setup(seed=cm)
    cfg = tcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    calib = tcim.calibrate_rowhist([_t(x)], tw, cfg)
    calib = calib._replace(adc_fs=calib.adc_fs * scale)
    y_ref, _ = tcim.cim_linear(_t(x), tw, cfg, calib)
    y, stats = tcim.cim_linear_fidelity(_t(x), tw, cfg, calib,
                                        code_buckets=RATIO_BUCKETS)
    assert torch.equal(y, y_ref)
    assert int(stats["pass1"]["total"]) == y_ref.numel()
    occupied = 0 if adc is None else y_ref.numel()  # no ADC: no codes
    assert int(stats["pass1"]["occ_counts"].sum()) == occupied
    jcfg = jcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    jcal = jcim.LayerCalib(jnp.int32(int(calib.e_n)),
                           jnp.float32(float(calib.adc_fs)))
    jy, jstats = jcim.cim_linear_fidelity(
        jnp.asarray(x), jmx.quantize_w(jnp.asarray(w)), jcfg, jcal,
        code_buckets=RATIO_BUCKETS)
    np.testing.assert_array_equal(y.numpy().view(np.uint32),
                                  np.asarray(jy).view(np.uint32))
    _assert_stats_equal(stats, jax.device_get(jstats), two)


def test_underscaled_fs_saturates_and_degrades_sqnr_same_run():
    x, _, tw, cfg, calib = _layer_setup()
    ref = (tmx.dequantize(tmx.quantize(_t(x)), out_len=tw.codes.shape[0])
           @ tmx.dequantize_w(tw))
    y_good, s_good = tcim.cim_linear_fidelity(_t(x), tw, cfg, calib)
    bad = calib._replace(adc_fs=calib.adc_fs * 0.25)
    y_bad, s_bad = tcim.cim_linear_fidelity(_t(x), tw, cfg, bad)
    assert int(s_good["pass1"]["saturated"]) == 0
    assert int(s_bad["pass1"]["saturated"]) > 0
    assert tobs.sqnr_db(ref, y_bad) < tobs.sqnr_db(ref, y_good) - 3.0


# ----------------------------------------------------- probe no-op gate

def test_disabled_obs_probe_is_noop():
    probe = tobs.FidelityProbe(obs=tobs.Obs(enabled=False))
    probe.observe_linear("p", None, None, None)
    probe.note_sqnr({"p": 3.0})
    rep = probe.drift_report()
    assert probe.records == {}
    assert rep == {"layers": {}, "drifted": [], "n_drifted": 0}
    assert probe.summary() == {}
    assert probe.registry.families() == []


def test_probe_raises_while_a_graph_is_captured(monkeypatch):
    """The capture check runs before anything touches the arguments (the
    real capture is the cuda-marked test below)."""
    monkeypatch.setattr(tfid, "capturing", lambda: True)
    probe = tobs.FidelityProbe()
    with pytest.raises(RuntimeError, match="eager-only"):
        probe.observe_linear("segments/0/L0/attn/wq", None, None, None)
    assert probe.records == {}


@pytest.mark.cuda
def test_cuda_probe_raises_under_graph_capture():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w, tw, cfg, calib = _layer_setup()
    dev = torch.device("cuda")
    params = {"codes": tmx.kmajor(tw.codes).to(dev),
              "exps": tmx.kmajor(tw.exps).to(dev),
              "e_n": calib.e_n.to(dev), "adc_fs": calib.adc_fs.to(dev)}
    ctx = TCtx(quant="cim", cim=cfg)
    xd = _t(x).to(dev, torch.bfloat16)
    probe = tobs.FidelityProbe()
    probe.observe_linear("eager", ctx, params, xd)  # eager: recorded
    assert "eager" in probe.records
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="eager-only"):
        with torch.cuda.stream(side), torch.cuda.graph(g):
            probe.observe_linear("captured", ctx, params, xd)
    assert "captured" not in probe.records


# ----------------------------------------------------- scale_adc_fs tool

def test_scale_adc_fs_scales_only_matching_layers():
    tree = {
        "a": {"adc_fs": 8.0, "e_n": 1},
        "b": {"nested": [{"adc_fs": 4.0}]},
        "w": np.ones(3),
    }
    out = tobs.scale_adc_fs(tree, 0.5, match="nested")
    assert out["b"]["nested"][0]["adc_fs"] == 2.0
    assert out["a"]["adc_fs"] == 8.0
    assert tree["b"]["nested"][0]["adc_fs"] == 4.0  # original not mutated
    all_scaled = tobs.scale_adc_fs(tree, 0.5)
    assert all_scaled["a"]["adc_fs"] == 4.0
    assert all_scaled["b"]["nested"][0]["adc_fs"] == 2.0


def test_scale_adc_fs_names_layers_as_calibration_does():
    """The port keeps one dict a layer under ``segments[i]``; ``match``
    sees the calibration paths (``segments/<i>/L<j>/...``, and
    ``segments/<i>/...`` for a single-layer segment)."""
    node = lambda: {"attn": {"wq": {"adc_fs": torch.tensor(8.0)}}}  # noqa
    tree = {"segments": [[node(), node(), node()], [node()]]}
    out = tobs.scale_adc_fs(tree, 0.25, match="segments/0/L1/attn")
    fs = [[float(lay["attn"]["wq"]["adc_fs"]) for lay in seg]
          for seg in out["segments"]]
    assert fs == [[8.0, 2.0, 8.0], [8.0]]
    out = tobs.scale_adc_fs(tree, 0.25, match="segments/1/attn/wq")
    assert float(out["segments"][1][0]["attn"]["wq"]["adc_fs"]) == 2.0


# --------------------------------------------- NaN-safe metric export

def test_nan_gauge_survives_export():
    reg = tobs.MetricsRegistry()
    reg.gauge("g", "t", labels={"layer": "l"}).set(float("nan"))
    prom = tobs.to_prometheus(reg)
    assert 'g{layer="l"} NaN' in prom
    snap = tobs.to_json(reg)
    assert snap["metrics"]["g"]["series"][0]["value"] is None


# ------------------------------------------------- model-level end-to-end

@pytest.fixture(scope="module")
def tiny_hybrid():
    """Tiny danube: the reference's float tree, its Row-Hist conversion
    and its two fidelity passes (calibrated, adc_fs / 4) on the first
    calibration batch; the port's copies of both trees and its own two
    passes on the same batch."""
    jcfg = jconfigs.tiny(jconfigs.ARCHS[ARCH])
    tcfg = tconfigs.ArchConfig(**dataclasses.asdict(jcfg))
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256)
    params, _ = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    batches = jcalibrate.calibration_batches(jcfg, n_batches=2, batch=2,
                                             seq=16)
    # the port's Row-Hist calibration of the same weights and batches
    # (held to the reference's in tests/test_torch_dense_families.py and
    # tests/test_torch_lm.py), the reference's conversion with it
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    tfloat = from_reference(to_np(params), device="cpu")
    _, tcalibs = tcalibrate.convert_model_cim(
        tfloat, tcfg, TCtx(dense_attn_max=256),
        [{"ids": _t(b["ids"])} for b in batches], min_n=32)
    calibs = {path: jcim.LayerCalib(jnp.int32(int(c.e_n)),
                                    jnp.float32(float(c.adc_fs)))
              for path, c in tcalibs.items()}
    conv = jax.jit(jbackends.convert_params_cim,
                   static_argnames="min_n")(params, calibs, min_n=32)
    jhyb = dataclasses.replace(jctx, quant="cim", cim=jcim.CIMConfig())
    _, jgood = jobs.run_fidelity_pass(params, conv, jcfg, jhyb, batches[0])
    _, jbad = jobs.run_fidelity_pass(params, jobs.scale_adc_fs(conv, 0.25),
                                     jcfg, jhyb, batches[0])
    tconv = from_reference(to_np(conv), device="cpu")
    tbatch = {"ids": _t(batches[0]["ids"])}
    thyb = TCtx(quant="cim", cim=tcim.CIMConfig(), dense_attn_max=256)
    probe, good = tobs.run_fidelity_pass(tfloat, tconv, tcfg, thyb, tbatch)
    _, bad = tobs.run_fidelity_pass(tfloat, tobs.scale_adc_fs(tconv, 0.25),
                                    tcfg, thyb, tbatch)
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, params=params, calibs=calibs, jgood=jgood,
        jbad=jbad, tfloat=tfloat, tconv=tconv, tbatch=tbatch, thyb=thyb,
        probe=probe, good=good, bad=bad, jbatch=batches[0], jctx=jctx)


def test_model_fidelity_pass_publishes_everything(tiny_hybrid):
    h = tiny_hybrid
    snap = h.probe.registry.snapshot()

    def layers_of(name):
        return {s["labels"]["layer"] for s in snap[name]["series"]}

    for name in ("fidelity_sqnr_db", "fidelity_mxfp4_clip_total",
                 "adc_saturation_ratio", "adc_code_utilization"):
        assert set(h.calibs) <= layers_of(name), name
    assert "output" in h.good["sqnr_db"]
    assert h.good["sqnr_db"]["output"] > 5.0
    assert h.good["drift"]["n_drifted"] == 0
    assert set(h.good["sqnr_db"]) == set(h.jgood["sqnr_db"])
    assert set(h.good["layers"]) == set(h.jgood["layers"])


def test_model_per_path_sqnr_within_1db_of_reference(tiny_hybrid):
    h = tiny_hybrid
    for rep, jrep in ((h.good, h.jgood), (h.bad, h.jbad)):
        for path, db in jrep["sqnr_db"].items():
            assert abs(rep["sqnr_db"][path] - db) <= 1.0, (path, db)


def test_model_miscalibration_trips_drift_and_degrades_sqnr(tiny_hybrid):
    h = tiny_hybrid
    assert h.bad["drift"]["n_drifted"] > 0
    assert h.bad["drift"]["drifted"] == h.jbad["drift"]["drifted"]
    for path in h.bad["drift"]["drifted"]:
        assert h.bad["layers"][path]["adc_saturation_ratio"] > 0.05
    assert h.bad["sqnr_db"]["output"] < h.good["sqnr_db"]["output"] - 3.0


def test_converted_captures_key_the_reference_paths(tiny_hybrid):
    """The tap's ``include_converted`` captures at int8 K-major CIM codes
    and packed MXFP4 nibble pairs under the paths and shapes of the float
    tree's captures, which are the reference pass's paths."""
    h = tiny_hybrid
    trees = {"none": h.tfloat, "cim": h.tconv,
             "mxfp4_wonly": tcommon.convert_params_mxfp4(h.tfloat, min_n=32)}
    caps = {quant: tcalibrate.capture_linear_inputs(
                tree, h.tcfg, h.thyb, h.tbatch, quant=quant)[0]
            for quant, tree in trees.items()}
    want = set(h.jgood["sqnr_db"]) - {"output"}
    assert want == set(h.calibs)  # every linear, the untied head too
    for quant, got in caps.items():
        assert set(got) == want, quant
        for path, a in got.items():
            assert a.shape == caps["none"][path].shape, (quant, path)
            assert a.dtype == torch.float32


# ------------------------------------------------ engine trace, profiling

def _tiny_engine(obs):
    args = tserve.build_parser().parse_args(
        ["--device", "cpu", "--backend", "mxfp4", "--log-level", "warning"])
    cfg, params, ctx, _ = tserve.build_model(args, obs=obs)
    eng = Engine(params, cfg, ctx, EngineConfig(lanes=2, num_slots=3,
                                                page_len=24, prefill_len=12,
                                                kv_layout="fused"),
                 obs=obs)
    rng = np.random.default_rng(1)
    for n in (3, 7, 5):
        eng.add_request(rng.integers(0, cfg.vocab_size, n).tolist(),
                        max_new=4)
    eng.run()
    return eng


def test_engine_trace_is_the_reference_tuple_view():
    eng = _tiny_engine(tobs.Obs())
    jo = jobs.Obs()
    for e in eng.obs.steps:
        jo.step_recorded(e.kind, e.rids, e.n_tokens, e.t_start, e.t_end)
    ref = jengine.Engine.trace.fget(types.SimpleNamespace(obs=jo))
    assert eng.trace == ref == eng.obs.legacy_trace()
    assert {k for k, _, _ in eng.trace} == {"prefill", "decode"}
    assert sum(k == "prefill" for k, _, _ in eng.trace) == 3


def test_profile_times_eager_calls_and_labels_modes():
    obs = tobs.Obs(profile=True)
    out = profiled_call("cim_linear", obs, lambda: torch.ones(3))
    assert out.tolist() == [1.0, 1.0, 1.0]
    snap = obs.registry.snapshot()
    assert snap["kernel_calls_total"]["series"] == [
        {"labels": {"kernel": "cim_linear", "mode": "eager"}, "value": 1.0}]
    wall = snap["kernel_wall_seconds"]["series"]
    assert wall[0]["labels"] == {"kernel": "cim_linear"}
    assert wall[0]["count"] == 1
    plain = tobs.Obs()
    profiled_call("cim_linear", plain, lambda: None)
    assert "kernel_wall_seconds" not in plain.registry.snapshot()


# ----------------------------------------------------------- the launcher

def _families(path) -> set:
    return {name for name, _ in tobs.parse_prometheus(path.read_text())}


def test_launcher_fidelity_writes_fidelity_and_adc_families(tmp_path):
    out = tmp_path / "m.json"
    log = logging.getLogger("repro_torch.serve")
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    log.addHandler(handler)
    try:
        tserve.main(["--device", "cpu", "--backend", "cim", "--serve-trace",
                     "--fidelity", "--metrics-out", str(out), "--profile",
                     "--log-every", "4"])
    finally:
        log.removeHandler(handler)
    names = _families(tmp_path / "m.prom")
    for fam in ("fidelity_sqnr_db", "fidelity_mxfp4_clip_total",
                "fidelity_mxfp4_values_total", "fidelity_mxfp4_clip_ratio",
                "fidelity_drift_exp_margin", "fidelity_drift_fs_ratio",
                "fidelity_cim_overflow_ratio", "adc_saturation_total",
                "adc_samples_total", "adc_saturation_ratio",
                "adc_fs_headroom", "kernel_calls_total"):
        assert fam in names, fam
    assert any(n.startswith("adc_code_utilization") for n in names)
    assert any(n.startswith("fidelity_block_exponent") for n in names)
    assert any(n.startswith("kernel_wall_seconds") for n in names)
    err = stream.getvalue()
    assert "fidelity: layers=" in err and "drifted=0" in err
    assert err.count("progress step=") >= 2


def test_launcher_impl_ref_serves_without_the_kernels(tmp_path):
    out = tmp_path / "m.json"
    summary = tserve.main(["--device", "cpu", "--backend", "cim",
                           "--serve-trace", "--impl", "ref",
                           "--metrics-out", str(out)])
    assert summary["requests"] == 8 and summary["tokens"] > 0
    vocab = tconfigs.tiny(tconfigs.ARCHS["starcoder2-7b"]).vocab_size
    assert all(0 <= t < vocab for toks in summary["out"].values()
               for t in toks)
    assert "kernel_calls_total" not in _families(tmp_path / "m.prom")


def test_launcher_vision_mxfp4_fidelity_probes_packed_linears(tmp_path):
    out = tmp_path / "m.json"
    tserve.main(["--arch", "vit-b16", "--device", "cpu", "--backend",
                 "mxfp4", "--frames", "1", "--fidelity", "--metrics-out",
                 str(out)])
    samples = tobs.parse_prometheus((tmp_path / "m.prom").read_text())
    sq = {dict(lab)["layer"]: v for (name, lab), v in samples.items()
          if name == "fidelity_sqnr_db"}
    assert "head" in sq and "segments/0/L11/ffn/w2" in sq
    assert len(sq) == 12 * 6 + 3  # six linears a layer, patch, head, output
    assert np.isfinite(sq["output"])
