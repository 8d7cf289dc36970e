"""The port's vision serving and FWS pipeline model against the JAX
package: ``distributed.sharding.stage_partition``, the ``hwmodel``
copies, ``serving/pipeline.py``, ``Engine.trace_report``, the
``VisionEngine`` on the geometry-true tiny ViTs (the paper's token counts
and chip split at d 64) and the launcher's vision path.

- ``stage_partition``: the reference's partition, or its error, over a
  grid of (layers, chips, mode, costs).
- ``hwmodel``: every constant of ``specs`` and every function of ``perf``
  (Tables 1, 4, 7 and 9, Fig. 12) equal to the reference's.
- ``simulate`` / ``simulate_trace``: reports equal to the reference's on
  the same jobs and events, and the same gauges once published.
- The FWS FPS that the engine's measured traffic gives equals the
  reference engine's on the same frame events, and lies within 5% of the
  paper's Table 7 row: vit-b16 on one chip, vit-l32 on two with the hop.
  This is the analytical model of the MXFormer chip, not a speed of the
  device that ran the frames.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

from repro.distributed import sharding as jsharding  # noqa: E402
from repro.hwmodel import perf as jperf  # noqa: E402
from repro.hwmodel import specs as jspecs  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.serving import pipeline as jpipe  # noqa: E402
from repro.serving import vision as jvision  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.distributed.sharding import stage_partition  # noqa: E402
from repro_torch.hwmodel import perf as tperf  # noqa: E402
from repro_torch.hwmodel import specs as tspecs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers.common import RunCtx  # noqa: E402
from repro_torch.models import lm, vit  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine,
    EngineConfig,
    VisionEngine,
    synthetic_stream_report,
)
from repro_torch.serving import pipeline as tpipe  # noqa: E402

CTX = RunCtx(dense_attn_max=256)


def _result(fn, *a, **kw):
    try:
        return fn(*a, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


# ------------------------------------------------------------ partition

def test_stage_partition_matches_reference():
    rng = np.random.default_rng(0)
    cases = 0
    for n_layers, n_chips in itertools.product(range(1, 13), range(0, 14)):
        costs = rng.uniform(0.1, 3.0, n_layers).round(2).tolist()
        for mode, c in (("equal", None), ("balanced", None),
                        ("balanced", costs), ("balanced", costs[:-1]),
                        ("stacked", None)):
            got = _result(stage_partition, n_layers, n_chips, mode, c)
            ref = _result(jsharding.stage_partition, n_layers, n_chips, mode,
                          c)
            assert got == ref, (n_layers, n_chips, mode, c)
            cases += 1
    assert stage_partition(24, 2) == [(0, 12), (12, 24)]
    assert stage_partition(6, 3, "balanced", [1, 1, 1, 1, 5, 1]) == [
        (0, 4), (4, 5), (5, 6)]
    for bad in ((4, 5), (4, 0), (4, 2, "stacked"), (4, 2, "balanced", [1])):
        with pytest.raises(ValueError):
            stage_partition(*bad)
    assert cases == 12 * 14 * 5


# --------------------------------------------------------------- hwmodel

def _plain(v):
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def test_hwmodel_specs_equal_reference():
    names = [n for n in dir(jspecs) if n.isupper() or n == "C_D0"]
    assert names == [n for n in dir(tspecs) if n.isupper() or n == "C_D0"]
    assert "PAPER_TABLE7" in names and "WORKLOADS" in names
    for n in names:
        assert _plain(getattr(tspecs, n)) == _plain(getattr(jspecs, n)), n


def _perf_calls(P, S):
    """Every public function of ``perf`` on a spread of arguments."""
    systems = (S.BASE, S.LARGE)
    ws = list(S.WORKLOADS.values())
    ns = (1, 17, 50, 145, 197, 257, 512, 1000)
    calls = {
        "ceil_to": [P.ceil_to(n, m) for n in ns for m in (32, 64)],
        "macro_tops": [P.macro_tops(h, p) for h in (768, 1024)
                       for p in (1, 2)],
        "macro_area_mm2": [P.macro_area_mm2(h) for h in (768, 1024)],
        "macro_power_w": [P.macro_power_w(h) for h in (768, 1024)],
        "storage_density_kb_mm2": [P.storage_density_kb_mm2(h)
                                   for h in (768, 1024)],
        "n_arrays": [P.n_arrays(s) for s in systems],
        "analog_tops": [P.analog_tops(s, p) for s in systems for p in (1, 2)],
        "digital_peak_tops": [P.digital_peak_tops(s) for s in systems],
        "t_analog": [P.t_analog(n, p) for n in ns for p in (1, 2)],
        "t_digital": [P.t_digital(n, d) for n in ns for d in (384, 768, 1024)],
        "stage_time": [P.stage_time(n, d) for n in ns for d in (768, 1024)],
        "t_interchip": [P.t_interchip(n, d) for n in ns for d in (768, 1024)],
        "steady_state_fps": [P.steady_state_fps(n, d) for n in ns
                             for d in (768, 1024)],
        "n_balance": [P.n_balance(s) for s in systems],
        "flops_per_item": [P.flops_per_item(w) for w in ws],
        "fps": [P.fps(w) for w in ws],
        "tops": [P.tops(w) for w in ws],
        "system_peak_tops": [P.system_peak_tops(s) for s in systems],
        "system_area_mm2": [P.system_area_mm2(s) for s in systems],
        "system_power_w": [P.system_power_w(s, a, d) for s in systems
                           for a, d in ((1, 1), (0.5, 0.25))],
        "model_power_w": [P.model_power_w(w) for w in ws],
        "io_penalty": [P.io_penalty(w) for w in ws],
        "fig12_sweep": [P.fig12_sweep(s) for s in systems]
        + [P.fig12_sweep(S.BASE, [8, 197, 4096])],
        "table4": P.table4(),
        "table7": P.table7(),
    }
    return calls


def test_hwmodel_perf_equals_reference():
    """Every function of the port's ``perf`` copy (Tables 1, 4, 7, Fig.
    12 and what they rest on) gives the reference's values; the Table 7
    and Table 9 rows land within 5% of the paper's FPS."""
    public = sorted(n for n, v in vars(jperf).items()
                    if callable(v) and not n.startswith("_")
                    and getattr(v, "__module__", "") == jperf.__name__)
    got, ref = _perf_calls(tperf, tspecs), _perf_calls(jperf, jspecs)
    assert sorted(got) == public  # none left out
    for name in public:
        assert got[name] == ref[name], name
    for name, (_, fps, _) in tspecs.PAPER_TABLE7.items():
        assert tperf.fps(tspecs.WORKLOADS[name]) == pytest.approx(fps,
                                                                  rel=0.05)
    for name, fps in tspecs.PAPER_TABLE9.items():
        assert tperf.fps(tspecs.WORKLOADS[name]) == pytest.approx(fps,
                                                                  rel=0.05)


# -------------------------------------------------------------- pipeline

def _pipeline_fields(rep) -> dict:
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
           if f.name != "timings"}
    out["timings"] = [(t.job.arrival, t.job.n_tokens, t.job.tag, t.start,
                       t.finish, t.latency) for t in rep.timings]
    out["bubble_fraction"] = rep.bubble_fraction
    out["fill_latency_s"] = rep.fill_latency_s
    return out


@pytest.mark.parametrize("chips", [1, 2, 3])
@pytest.mark.parametrize("override", [False, True])
def test_simulate_matches_reference(chips, override):
    rng = np.random.default_rng(chips)
    arrivals = np.cumsum(rng.exponential(2e-4, 60))
    spec = [(float(a), int(n)) for a, n in
            zip(arrivals, rng.integers(1, 600, 60))]
    kw = {}
    if override:  # measured per-stage walls drive the schedule instead
        kw = dict(stage_time_fn=lambda n, d, k: 1e-6 * (n + 7 * k),
                  hop_time_fn=lambda n, d: 3e-7 * n)
    for d in (768, 1024):
        got = tpipe.simulate([tpipe.Job(a, n, i) for i, (a, n)
                              in enumerate(spec)], d, chips=chips, **kw)
        ref = jpipe.simulate([jpipe.Job(a, n, i) for i, (a, n)
                              in enumerate(spec)], d, chips=chips, **kw)
        assert _pipeline_fields(got) == _pipeline_fields(ref)
    assert _pipeline_fields(tpipe.simulate([], 768)) == _pipeline_fields(
        jpipe.simulate([], 768))


def _events():
    rng = np.random.default_rng(5)
    out = [("prefill", (0,), 16), ("prefill", (1,), 16)]
    for step in range(30):
        live = tuple(r for r in range(6) if r <= step // 4)
        out.append(("decode", live, 4))
        if step % 7 == 3:
            out.append(("prefill", (int(rng.integers(6, 9)),), 16))
    return out


def test_simulate_trace_matches_reference_and_publishes():
    for events in (_events(), [], [("prefill", (0,), 8)]):
        got = tpipe.simulate_trace(events, 64, lanes=4)
        ref = jpipe.simulate_trace(events, 64, lanes=4)
        assert got.request_latency == ref.request_latency
        assert (got.tokens_per_s, got.lane_utilization) == (
            ref.tokens_per_s, ref.lane_utilization)
        assert _pipeline_fields(got.pipeline) == _pipeline_fields(
            ref.pipeline)
        treg, jreg = MetricsRegistry(), JRegistry()
        got.publish(treg)
        ref.publish(jreg)
        assert treg.snapshot() == jreg.snapshot()


def test_engine_trace_report_matches_reference():
    """``Engine.trace_report`` on a tiny LM serve is the reference's
    ``simulate_trace`` of the same step events."""
    cfg = C.tiny(C.STARCODER2_7B)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    ecfg = EngineConfig(lanes=3, num_slots=4, page_len=24, prefill_len=8,
                        kv_layout="fused")
    eng = Engine(params, cfg, CTX, ecfg)
    for i, n in enumerate((5, 8, 3, 6)):
        eng.add_request(list(range(1, n + 1)), max_new=3 + i)
    eng.run()
    rep = eng.trace_report()
    assert isinstance(rep, tpipe.TraceReport)
    events = [e.legacy for e in eng.obs.steps]
    assert {k for k, _, _ in events} == {"prefill", "decode"}
    ref = jpipe.simulate_trace(events, cfg.d_model, ecfg.lanes)
    assert rep.request_latency == ref.request_latency
    assert rep.tokens_per_s == ref.tokens_per_s
    assert rep.lane_utilization == ref.lane_utilization
    assert _pipeline_fields(rep.pipeline) == _pipeline_fields(ref.pipeline)


# ---------------------------------------------------------- vision engine

def _reference_engine(cfg, eng: VisionEngine):
    """The reference's engine over the port engine's frame events. Its
    ``fws_report`` reads only those events and the config, so its
    parameters are a stand-in of the layer-stacked shape that
    ``split_chips`` slices."""
    stand_in = {"segments": [np.zeros((cfg.n_layers, 1), np.float32)],
                **dict.fromkeys(("patch", "cls", "pos", "final_ln", "head"),
                                None)}
    jcfg = jvision.vit.ViTConfig(**dataclasses.asdict(cfg))
    jeng = jvision.VisionEngine(stand_in, jcfg, None)
    for e in eng.obs.steps:
        jeng.obs.step_recorded(e.kind, e.rids, e.n_tokens, e.t_start,
                               e.t_end)
    return jeng


def _report_fields(rep) -> tuple:
    return (rep.fps, rep.frame_latency_s, rep.n_tokens, rep.d_model,
            rep.chips, rep.paper_fps, rep.fps_error,
            _pipeline_fields(rep.pipeline))


@pytest.mark.parametrize("workload", ["vit-b16", "vit-l32"])
def test_vision_engine_fws_matches_reference_and_table7(workload):
    """Streamed frames on the geometry-true tiny ViT: one ``frame`` event a
    frame at the workload's token count; the FWS report from that traffic
    equals the reference engine's, lies within 5% of Table 7 and, on two
    chips, takes 24 compute stages plus one hop for a frame."""
    cfg = C.geometry_tiny_vit(C.VISION_ARCHS[workload])
    params = vit.init_model(cfg, torch.Generator().manual_seed(0))
    eng = VisionEngine(params, cfg, CTX)
    frames = torch.randn((2, cfg.image_size, cfg.image_size, 3),
                         generator=torch.Generator().manual_seed(1))
    labels = eng.stream(frames)
    assert len(labels) == 2 and all(0 <= t < cfg.n_classes for t in labels)
    assert [e.kind for e in eng.obs.steps] == ["frame", "frame"]
    assert eng.trace == [cfg.seq_len] * 2
    assert cfg.seq_len == {"vit-b16": 197, "vit-l32": 145}[workload]
    assert len(eng._chain) == cfg.chips
    rep = eng.fws_report(workload=workload)
    ref = _reference_engine(cfg, eng).fws_report(workload=workload)
    assert _report_fields(rep) == _report_fields(ref)
    assert rep.chips == cfg.chips and rep.n_tokens == cfg.seq_len
    assert rep.fps == pytest.approx(tspecs.PAPER_TABLE7[workload][1],
                                    rel=0.05)
    w = tspecs.WORKLOADS[workload]
    t, hop = tperf.stage_time(w.seq, w.d), tperf.t_interchip(w.seq, w.d)
    assert rep.fps == pytest.approx(1.0 / t, rel=1e-6)
    if workload == "vit-l32":
        assert 0 < hop < t
        assert rep.frame_latency_s == pytest.approx(24 * t + hop, rel=1e-9)
    reg = MetricsRegistry()
    rep.publish(reg)
    assert reg.snapshot()["pipeline_paper_fps_error"]["series"][0][
        "value"] == rep.fps_error
    # the chain's hidden-state handoff gives the monolithic logits
    mono, _ = vit.forward(params, cfg, CTX, {"images": frames[:1]})
    assert torch.equal(eng.logits(frames[:1]), mono)


def test_fws_report_guards_and_unported_runner():
    cfg = C.tiny_vit(C.VIT_B16)
    params = vit.init_model(cfg, torch.Generator().manual_seed(0))
    eng = VisionEngine(params, cfg, CTX)
    with pytest.raises(ValueError, match="no frames"):
        eng.fws_report()
    eng.classify_frame(torch.zeros(cfg.image_size, cfg.image_size, 3))
    assert eng.trace == [cfg.seq_len]
    with pytest.raises(ValueError, match="measured stage traffic"):
        eng.fws_report(workload="vit-b16")  # 17 != 197 tokens
    assert eng.obs.registry.snapshot()["vision_frames_total"]["series"][0][
        "value"] == 1
    with pytest.raises(ValueError, match="pipelined runner"):
        eng.measured_report(None)  # no runner, as in the reference
    from repro_torch.distributed import pipeline_exec as pex

    runner = pex.build_vit_pipeline(
        params, cfg, CTX, stages=2, microbatches=1, mb_size=1,
        mesh=pex.make_pipeline_mesh(2, devices=[torch.device("cpu")] * 2))
    piped = VisionEngine(params, cfg, CTX, runner=runner)
    assert piped.runner is runner and piped.chips == 2
    frame = torch.zeros(cfg.image_size, cfg.image_size, 3)
    assert piped.classify_frame(frame) == eng.classify_frame(frame)


@pytest.mark.parametrize("name", ["vit-b32", "bert-base", "vit-l14"])
def test_synthetic_stream_report_matches_reference(name):
    w = tspecs.WORKLOADS[name]
    rep = synthetic_stream_report(w.seq, w.d, chips=w.chips)
    ref = jvision.synthetic_stream_report(w.seq, w.d, chips=w.chips)
    assert _report_fields(rep) == _report_fields(ref)
    assert rep.fps == pytest.approx(tspecs.PAPER_TABLE7[name][1], rel=0.05)


# --------------------------------------------------------------- launcher

@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
def test_launcher_serves_vision_on_cpu(backend):
    """``--arch vit-b16`` streams frames through the geometry-true tiny
    ViT under every backend; the FWS model's FPS, labelled as the model's,
    lands within 5% of Table 7."""
    out = tserve.main(["--arch", "vit-b16", "--backend", backend, "--device",
                       "cpu", "--frames", "2", "--log-level", "warning"])
    assert (out["model"], out["backend"], out["frames"]) == (
        "vit-b16", backend, 2)
    assert out["tokens_each"] == 197 and out["chips"] == 1
    assert out["fps_host"] > 0 and out["frame_ms_p50"] > 0
    assert all(0 <= t < 32 for t in out["top1"])
    fws = out["fws"]
    assert fws["paper_fps"] == 41269
    assert fws["fws_model_fps"] == pytest.approx(41269, rel=0.05)
    assert fws["err_pct"] < 5


def test_launcher_vit_l32_dual_chip_and_cuda_default():
    out = tserve.main(["--model", "vit-l32", "--backend", "mxfp4", "--device",
                       "cpu", "--frames", "1", "--layers", "4",
                       "--log-level", "warning"])
    assert (out["chips"], out["layers"], out["tokens_each"]) == (2, 4, 145)
    assert out["fws"]["fws_model_fps"] == pytest.approx(58275, rel=0.05)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.main(["--arch", "vit-b16", "--frames", "1"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vit.calibration_images(C.tiny_vit(C.VIT_B16))
