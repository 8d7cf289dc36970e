"""The port's load harness, SLO scoring and metrics export
(``repro_torch/serving/load.py``, ``obs/slo.py``, ``obs/export.py``) held
against the JAX package's on the CPU.

- Arrival processes, the arrivals spec and workload synthesis give the
  reference's results from the same seeded ``np.random.default_rng``.
- A trace written by either package loads in the other.
- ``evaluate_slo`` on the same finished spans gives the reference's dict,
  ``ok=None`` for a check with no samples included.
- One sequence of registry operations renders byte-equal Prometheus text
  in both packages, and ``parse_prometheus`` round-trips it.
- On the tiny float engine a wall-clock replay gives the tokens of an
  all-at-once run (lane isolation), and ``load_report`` gives the
  reference's ``load_report`` of the same engine.
- The launcher's ``--arrivals burst:...`` runs on the CPU and writes the
  JSON snapshot and the Prometheus file beside it.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

from repro import obs as jobs  # noqa: E402
from repro.serving import load as jload  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers.common import RunCtx  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402
from repro_torch.serving import load as tload  # noqa: E402

CFG = C.tiny(C.STARCODER2_7B)


def _spec(mod, **kw):
    base = dict(vocab_size=64, prompt_len=(2, 6), out_len=(1, 4), n_system=2,
                system_len=4, p_shared=0.6, max_prompt=8)
    return mod.WorkloadSpec(**(base | kw))


# ------------------------------------------------------------- arrivals

@pytest.mark.parametrize("seed", [0, 5])
def test_arrivals_and_synthesis_equal_reference(seed):
    """The same seeded generator gives the same arrival times and the same
    (prompt, max_new) draws, in the same order of RNG calls."""
    jrng, trng = (np.random.default_rng(seed) for _ in range(2))
    np.testing.assert_array_equal(
        tload.poisson_arrivals(20.0, 50, trng),
        jload.poisson_arrivals(20.0, 50, jrng))
    for kw in ({}, {"p_shared": 1.0, "max_prompt": None}, {"n_system": 0}):
        assert (tload.synth_requests(_spec(tload, **kw), 30, trng)
                == jload.synth_requests(_spec(jload, **kw), 30, jrng))
    np.testing.assert_array_equal(tload.poisson_arrivals(3.0, 4, trng),
                                  jload.poisson_arrivals(3.0, 4, jrng))
    np.testing.assert_array_equal(tload.burst_arrivals(7, 3, 0.5),
                                  jload.burst_arrivals(7, 3, 0.5))
    with pytest.raises(ValueError):
        tload.poisson_arrivals(0.0, 3, trng)


def test_parse_arrivals_equals_reference():
    for spec in ("poisson:25", "trace:/x/t.json", "burst:8:0.1", "burst:8"):
        assert tload.parse_arrivals(spec) == jload.parse_arrivals(spec)
    for bad in ("uniform:3", "trace:", "trace"):
        with pytest.raises(ValueError):
            tload.parse_arrivals(bad)


def test_traces_cross_between_packages(tmp_path):
    """A trace saved by the reference loads in the port as the same
    records, and the reverse."""
    rng = np.random.default_rng(1)
    reqs = tload.synth_requests(_spec(tload), 6, rng)
    times = tload.poisson_arrivals(100.0, 6, rng)
    ttrace, jtrace = tload.make_trace(times, reqs), jload.make_trace(times,
                                                                     reqs)
    jload.save_trace(str(tmp_path / "j.json"), jtrace)
    tload.save_trace(str(tmp_path / "t.json"), ttrace)
    assert tload.load_trace(str(tmp_path / "j.json")) == ttrace
    assert jload.load_trace(str(tmp_path / "t.json")) == jtrace
    assert ((tmp_path / "j.json").read_text()
            == (tmp_path / "t.json").read_text())


# ------------------------------------------------------------------ SLO

def _spans(mod) -> list:
    """Finished spans: two with decode intervals, one first token only,
    one evicted before its first token."""
    obs = mod.Obs(clock=iter(np.arange(0.0, 100.0, 0.125).tolist()).__next__)
    for rid in range(4):
        obs.request_enqueued(rid)
    for rid in (0, 1, 2):
        obs.request_admitted(rid)
        obs.token_emitted(rid)
    for _ in range(3):
        obs.token_emitted(0)
    obs.token_emitted(1)
    for rid, why in ((0, "max_new"), (1, "stop"), (2, "max_new"),
                     (3, "page_exhausted")):
        obs.request_finished(rid, why)
    return obs.finished


@pytest.mark.parametrize("targets", [
    dict(ttft_p50_s=0.5, ttft_p99_s=1.0, token_p50_s=0.2, token_p99_s=0.3),
    dict(ttft_p99_s=0.1, token_p99_s=10.0),
    dict(token_p50_s=0.25),
    dict(),
])
def test_evaluate_slo_equals_reference(targets):
    got = tobs.evaluate_slo(_spans(tobs), tobs.SLOTargets(**targets))
    want = jobs.evaluate_slo(_spans(jobs), jobs.SLOTargets(**targets))
    assert got == want


def test_evaluate_slo_check_without_samples_is_none():
    """No decode intervals: the token check reports ok=None and does not
    fail the verdict, in both packages."""
    targets = dict(ttft_p99_s=60.0, token_p99_s=0.001)
    spans = [s for s in _spans(tobs) if not s.token_intervals_s]
    jspans = [s for s in _spans(jobs) if not s.token_intervals_s]
    got = tobs.evaluate_slo(spans, tobs.SLOTargets(**targets))
    assert got == jobs.evaluate_slo(jspans, jobs.SLOTargets(**targets))
    assert got["checks"]["token_p99_s"]["ok"] is None
    assert got["checks"]["ttft_p99_s"]["ok"] is True and got["pass"] is True


# --------------------------------------------------------------- export

def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("reqs_total", "requests", labels={"kind": 'a"b\\c'}).inc(3)
    reg.counter("reqs_total", "requests", labels={"kind": "x\ny"}).inc()
    reg.gauge("depth", "queue depth").set(7.5)
    reg.gauge("sqnr_db", "zero signal").set(float("nan"))
    reg.gauge("top", "unbounded").set(float("inf"))
    h = reg.histogram("lat_seconds", "latency", labels={"kind": "decode"})
    for v in (1e-4, 3e-3, 0.2, 5.0, 1e3):
        h.observe(v)
    reg.histogram("occ", "occupancy", buckets=mod.RATIO_BUCKETS).observe(0.5)
    return reg


def test_prometheus_text_equals_reference_and_round_trips(tmp_path):
    treg, jreg = _fill(tobs), _fill(jobs)
    text = tobs.to_prometheus(treg)
    assert text == jobs.to_prometheus(jreg)
    samples = tobs.parse_prometheus(text)
    jsamples = jobs.parse_prometheus(text)
    assert samples.keys() == jsamples.keys()
    for key, v in samples.items():
        assert v == jsamples[key] or (np.isnan(v) and np.isnan(jsamples[key]))
    assert samples[("reqs_total", (("kind", 'a"b\\c'),))] == 3.0
    assert samples[("reqs_total", (("kind", "x\ny"),))] == 1.0
    assert samples[("lat_seconds_count", (("kind", "decode"),))] == 5.0
    assert samples[("lat_seconds_bucket", (("kind", "decode"),
                                           ("le", "+Inf")))] == 5.0
    assert tobs.to_json(treg, {"x": float("nan")}) == jobs.to_json(
        jreg, {"x": float("nan")})
    jp, pp = tobs.write_metrics(treg, str(tmp_path / "m.json"))
    assert pp == str(tmp_path / "m.prom")
    assert (tmp_path / "m.prom").read_text() == text
    snap = json.loads((tmp_path / "m.json").read_text())
    assert jp == str(tmp_path / "m.json")
    assert snap["metrics"]["depth"]["series"][0]["value"] == 7.5


# --------------------------------------------------------------- replay

def test_replay_matches_batch_run_and_reports():
    """Wall-clock admission cannot change a request's tokens (lane
    isolation), and the report is the reference's ``load_report`` of the
    same engine (keys, percentiles, prefix stats and SLO verdict)."""
    params = lm.init_model(CFG, torch.Generator().manual_seed(0))
    ctx = RunCtx(dense_attn_max=256)
    ecfg = EngineConfig(lanes=2, num_slots=4, page_len=24, prefill_len=8,
                        policy="chunked", chunk_len=4, prefix_cache=True,
                        kv_layout="fused")
    spec = tload.WorkloadSpec(vocab_size=CFG.vocab_size, prompt_len=(2, 6),
                              out_len=(2, 4), n_system=1, system_len=6,
                              p_shared=0.75, max_prompt=16)
    reqs = tload.synth_requests(spec, 6, np.random.default_rng(3))
    trace = tload.make_trace(tload.burst_arrivals(6, 2, 0.01), reqs)

    eng = Engine(params, CFG, ctx, ecfg, obs=tobs.Obs(enabled=True))
    res = tload.replay(eng, trace, speed=4.0)
    assert sorted(res["out"]) == list(range(6))
    ref = Engine(params, CFG, ctx, ecfg, obs=tobs.Obs(enabled=False))
    for p, m in reqs:
        ref.add_request(list(p), max_new=m)
    ref_out = ref.run()
    assert res["out"] == {rid: ref_out[rid] for rid in res["out"]}

    targets = dict(ttft_p99_s=60.0, token_p99_s=60.0)
    rep = tload.load_report(eng, tobs.SLOTargets(**targets), res["wall_s"])
    assert rep == jload.load_report(eng, jobs.SLOTargets(**targets),
                                    res["wall_s"])
    assert rep["n_requests"] == 6
    assert rep["tokens_generated"] == sum(len(v) for v in ref_out.values())
    assert rep["steps"]["prefill"] > 0 and rep["steps"]["decode"] > 0
    assert rep["prefix"]["hits"] > 0
    assert all(c["ok"] is True for c in rep["slo"]["checks"].values())


def test_launcher_arrivals_writes_metrics(tmp_path):
    """``--arrivals burst:4:0.05`` through the launcher on the CPU: a
    throwaway warm-up request, the replay, the SLO verdict, and the JSON
    snapshot with the Prometheus text beside it, whose counters are the
    snapshot's (the warm-up request counted in both, as the reference's
    launcher counts it)."""
    path = tmp_path / "metrics.json"
    out = tserve.main(
        ["--backend", "cim", "--device", "cpu", "--arrivals", "burst:4:0.05",
         "--requests", "6", "--chunk-len", "4", "--prefix-cache", "--policy",
         "chunked", "--metrics-out", str(path), "--slo-ttft-ms", "60000",
         "--log-level", "warning"])
    rep = out["report"]
    assert rep["n_requests"] == 6 and len(out["out"]) == 6
    assert rep["steps"]["prefill"] > 0 and out["slo"]["pass"] is True
    assert out["graphs"] == {}  # the CPU runs every step eagerly
    snap = json.loads(path.read_text())
    assert set(snap) == {"metrics", "requests", "slo"}
    assert snap["requests"]["n_requests"] == 6
    prom = tobs.parse_prometheus((tmp_path / "metrics.prom").read_text())
    for name, fam in snap["metrics"].items():
        if fam["type"] == "counter":
            for series in fam["series"]:
                key = (name, tuple(sorted(series["labels"].items())))
                assert prom[key] == series["value"]
    # obs.reset() after the warm-up clears spans, not the registry
    assert prom[("serve_requests_total", ())] == 7.0
