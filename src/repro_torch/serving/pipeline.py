"""Discrete-event model of the paper's §5.3 twelve-stage FWS pipeline
(a copy of ``repro.serving.pipeline``, over the port's own copy of
``hwmodel``).

MXFormer statically partitions the model's twelve transformer blocks over
twelve chip blocks; a scheduled batch (a prefill of N prompt tokens, or
one decode step over B active lanes = B tokens) streams through the
stages in order. Each stage holds a job for
``perf.stage_time(n_tokens, d_model)`` = max(T_analog, T_digital): the
analog CTT arrays consume one token per BITPLANES*MUX*PASSES = 20 analog
cycles while the two 32x64 systolic arrays run the tile-quantized
attention matmuls, and the slower side bounds the stage.

The simulator is a plain in-order, non-preemptive event model: job j
enters stage k at ``max(job j leaves stage k-1, stage k free)``. Once all
stages are occupied one job drains per ``stage_time`` — the steady-state
throughput must match ``perf.steady_state_fps`` and, for the paper's
encoder workloads, the Table 7 FPS figures (checked within 5% in
tests/test_serving.py and tests/test_vision.py; the port's copy is held
to the reference in tests/test_torch_vision.py).

Multi-chip deployments (``chips > 1``: vit-l32 / bert-large split their
24 blocks 12+12 over two chips) chain ``chips`` copies of the
``n_stages`` compute stages with one inter-chip hop stage between
consecutive chips (``perf.t_interchip``: the [N, d] bf16 activation tile
crossing the link). The hop deepens the pipeline — more fill latency —
but never bounds steady-state throughput for the paper's shapes.

``simulate_trace`` maps the serving engine's (kind, rids, n_tokens) event
trace onto the pipeline and attributes per-request latency: a request is
live from the entry of its prefill job to the drain of the last job that
carried one of its tokens.
"""

from __future__ import annotations

import dataclasses

from repro_torch.hwmodel import perf

N_STAGES = 12  # transformer blocks per die (hwmodel.specs.SystemSpec)


@dataclasses.dataclass(frozen=True)
class Job:
    arrival: float  # seconds; jobs are served FIFO in arrival order
    n_tokens: int
    tag: object = None


@dataclasses.dataclass(frozen=True)
class JobTiming:
    job: Job
    start: float  # entry into stage 0
    finish: float  # drain out of the last stage

    @property
    def latency(self) -> float:
        return self.finish - self.job.arrival


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    timings: list
    makespan: float
    stage_utilization: float  # busy fraction of one stage over makespan
    analog_utilization: float  # analog busy fraction *within* busy time
    digital_utilization: float
    fps: float  # jobs drained / makespan
    steady_state_fps: float  # tail-window throughput (pipeline full)

    @property
    def bubble_fraction(self) -> float:
        """Idle (bubble) fraction of a compute stage over the makespan —
        the complement of ``stage_utilization``: fill/drain ramps and
        host-side admission gaps show up here."""
        return max(0.0, 1.0 - self.stage_utilization)

    @property
    def fill_latency_s(self) -> float:
        """Time for the first job to traverse the empty pipeline (stage
        depth x stage time + hops) — the pipeline-fill cost every burst
        pays once."""
        if not self.timings:
            return 0.0
        t0 = self.timings[0]
        return t0.finish - t0.start

    def publish(self, registry, prefix: str = "pipeline") -> None:
        """Export stage occupancy / bubble / fill-latency gauges into a
        ``repro_torch.obs.MetricsRegistry``."""
        g = registry.gauge
        g(f"{prefix}_stage_occupancy",
          "busy fraction of one FWS compute stage").set(
            self.stage_utilization)
        g(f"{prefix}_bubble_fraction",
          "idle (bubble) fraction of one FWS compute stage").set(
            self.bubble_fraction)
        g(f"{prefix}_analog_utilization",
          "analog busy fraction within stage busy time").set(
            self.analog_utilization)
        g(f"{prefix}_digital_utilization",
          "digital busy fraction within stage busy time").set(
            self.digital_utilization)
        g(f"{prefix}_fill_latency_seconds",
          "first job through the empty pipeline").set(self.fill_latency_s)
        g(f"{prefix}_steady_state_fps",
          "tail-window drain rate with the pipeline full").set(
            self.steady_state_fps)
        g(f"{prefix}_makespan_seconds", "simulated makespan").set(
            self.makespan)


def simulate(jobs: list, d_model: int, n_stages: int = N_STAGES,
             warmup: int | None = None, chips: int = 1,
             stage_time_fn=None, hop_time_fn=None) -> PipelineReport:
    """Run ``jobs`` (FIFO by list order) through the pipeline.

    With ``chips > 1`` the stage chain is ``chips`` copies of the
    ``n_stages`` compute stages separated by one inter-chip hop stage each
    (``perf.t_interchip``); utilization accounting covers the compute
    stages only (the hop is link occupancy, not array occupancy).

    ``stage_time_fn(n_tokens, d_model, stage_index) -> seconds`` overrides
    the CTT hardware model's per-stage service time — this is how the real
    multi-device executor's *measured* per-stage walls drive the
    discrete-event model for cross-validation (the CPU host cannot agree
    with the hardware model in absolute time, but the schedule must; see
    ``benchmarks/run.py::pipeline_multidevice``). ``hop_time_fn(n_tokens,
    d_model) -> seconds`` likewise overrides ``perf.t_interchip``. The
    analog/digital utilization split is a hardware-model quantity and
    reports 0 under an override.
    """
    if not jobs:
        return PipelineReport([], 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    total_stages = chips * n_stages + (chips - 1)
    hop_at = set(
        c * (n_stages + 1) + n_stages for c in range(chips - 1)
    )  # stage indices occupied by the inter-chip link
    free_at = [0.0] * total_stages
    timings = []
    busy = 0.0
    t_analog_busy = 0.0
    t_digital_busy = 0.0
    n_compute = chips * n_stages
    for job in jobs:
        if stage_time_fn is None:
            stage_times = [perf.stage_time(job.n_tokens, d_model)] * n_compute
        else:
            stage_times = [
                float(stage_time_fn(job.n_tokens, d_model, k))
                for k in range(n_compute)
            ]
        if chips > 1:
            t_hop = (hop_time_fn or perf.t_interchip)(job.n_tokens, d_model)
        else:
            t_hop = 0.0
        t = max(job.arrival, free_at[0])
        start = t
        ci = 0
        for k in range(total_stages):
            if k in hop_at:
                t_k = t_hop
            else:
                t_k = stage_times[ci]
                ci += 1
            t = max(t, free_at[k])
            free_at[k] = t + t_k
            t = t + t_k
        timings.append(JobTiming(job, start, t))
        busy += sum(stage_times) / n_compute  # mean per compute stage
        if stage_time_fn is None:
            t_analog_busy += perf.t_analog(job.n_tokens)
            t_digital_busy += perf.t_digital(job.n_tokens, d_model)
    makespan = max(x.finish for x in timings)
    # steady state: drain spacing once the pipeline is full
    warmup = total_stages if warmup is None else warmup
    warmup = min(warmup, len(timings) - 1)
    tail = timings[warmup:]
    span = tail[-1].finish - timings[warmup - 1].finish if warmup else None
    ss_fps = len(tail) / span if span else len(timings) / makespan
    return PipelineReport(
        timings=timings,
        makespan=makespan,
        stage_utilization=busy / makespan if makespan else 0.0,
        analog_utilization=t_analog_busy / busy if busy else 0.0,
        digital_utilization=t_digital_busy / busy if busy else 0.0,
        fps=len(timings) / makespan if makespan else 0.0,
        steady_state_fps=ss_fps,
    )


@dataclasses.dataclass(frozen=True)
class TraceReport:
    pipeline: PipelineReport
    request_latency: dict  # rid -> seconds (prefill entry -> last token out)
    tokens_per_s: float  # generated tokens drained / makespan
    lane_utilization: float  # live lanes / (lanes * decode steps)

    def publish(self, registry, prefix: str = "pipeline") -> None:
        """Export the pipeline gauges plus trace-level throughput and the
        simulated per-request latency histogram into a registry."""
        self.pipeline.publish(registry, prefix=prefix)
        registry.gauge(
            f"{prefix}_tokens_per_s",
            "generated tokens drained per simulated second",
        ).set(self.tokens_per_s)
        registry.gauge(
            f"{prefix}_lane_utilization",
            "live lanes / (lanes * decode steps)",
        ).set(self.lane_utilization)
        h = registry.histogram(
            f"{prefix}_sim_request_latency_seconds",
            "simulated request latency (prefill entry -> last token out)",
        )
        for v in self.request_latency.values():
            h.observe(v)


def simulate_trace(events: list, d_model: int, lanes: int,
                   n_stages: int = N_STAGES) -> TraceReport:
    """Map an engine event trace onto the pipeline.

    ``events``: list of (kind, rids, n_tokens) tuples or typed
    ``repro_torch.obs.StepEvent`` records — kind 'prefill' (one request's
    padded prompt) or 'decode' (one token for each rid; for the
    static-batching reference n_tokens may exceed len(rids): dead lanes
    still occupy the hardware). Jobs all arrive at t=0 back-to-back — the
    host scheduler is assumed to keep the pipeline fed.
    """
    events = [
        (e.kind, e.rids, e.n_tokens) if hasattr(e, "kind") else e
        for e in events
    ]
    jobs = [Job(0.0, n, (kind, rids)) for kind, rids, n in events]
    rep = simulate(jobs, d_model, n_stages)
    first_in: dict = {}
    last_out: dict = {}
    n_generated = 0
    live = 0
    decode_steps = 0
    for timing in rep.timings:
        kind, rids = timing.job.tag
        for rid in rids:
            first_in.setdefault(rid, timing.start)
            last_out[rid] = timing.finish
        if kind == "prefill":
            n_generated += 1  # prefill emits the first token
        else:
            n_generated += len(rids)
            live += len(rids)
            decode_steps += 1
    latency = {rid: last_out[rid] - first_in[rid] for rid in first_in}
    return TraceReport(
        pipeline=rep,
        request_latency=latency,
        tokens_per_s=n_generated / rep.makespan if rep.makespan else 0.0,
        lane_utilization=(
            live / (lanes * decode_steps) if decode_steps else 1.0
        ),
    )
