"""Span-based request tracer + typed engine lifecycle events.

The serving engines emit typed events through an :class:`Obs` handle —
``enqueue -> admitted -> prefill/first-token -> per-decode-step ->
finish/evict`` for LM requests, one ``frame`` span per streamed image
for the vision engine — and the tracer turns them into per-request
metrics (TTFT, queue wait, per-token latency, end-to-end latency) plus
registry counters/gauges/histograms.

The old ad-hoc ``(kind, rids, n_tokens)`` tuple list survives as a
*derived view* (:meth:`Obs.legacy_trace`) so ``pipeline.simulate_trace``
and every existing consumer keep working unchanged.

``Obs(enabled=False)`` keeps the step-event record (the pre-PR trace
equivalent, needed by the pipeline model) but skips all per-request
span tracking and registry updates — the measured-overhead baseline.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.obs import registry as reg_mod


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One scheduled unit of engine work (a prefill, a decode step over
    the live lanes, or a streamed vision frame)."""

    kind: str  # prefill | decode | frame
    rids: tuple
    n_tokens: int
    t_start: float
    t_end: float

    @property
    def legacy(self) -> tuple:
        return (self.kind, self.rids, self.n_tokens)

    @property
    def wall_s(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass
class RequestMetrics:
    """Per-request span record, finalized at finish/evict."""

    rid: int
    n_prompt: int = 0
    t_enqueue: float = 0.0
    t_admitted: float | None = None
    t_first_token: float | None = None
    t_finish: float | None = None
    finish_reason: str | None = None
    token_times: list = dataclasses.field(default_factory=list)

    @property
    def n_generated(self) -> int:
        return len(self.token_times)

    @property
    def queue_wait_s(self) -> float | None:
        if self.t_admitted is None:
            return None
        return self.t_admitted - self.t_enqueue

    @property
    def ttft_s(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_enqueue

    @property
    def e2e_s(self) -> float | None:
        if self.t_finish is None:
            return None
        return self.t_finish - self.t_enqueue

    @property
    def token_intervals_s(self) -> list:
        """Inter-token gaps after the first token (decode cadence)."""
        t = self.token_times
        return [b - a for a, b in zip(t, t[1:])]


class Obs:
    """Telemetry handle threaded through the serving stack.

    Carries the metrics registry, the step-event record, per-request
    spans, and the kernel-profiling switch. Engines accept one at
    construction; ``None`` means "create a private enabled one", so
    telemetry is on by default without any caller changes.
    """

    def __init__(self, registry: reg_mod.MetricsRegistry | None = None,
                 enabled: bool = True, profile: bool = False,
                 clock=time.perf_counter):
        self.registry = registry or reg_mod.MetricsRegistry()
        self.enabled = enabled
        # profile=True also records each eager kernel call's wall time
        # after a device synchronize (obs/profile.py); off by default, it
        # serializes dispatch
        self.profile = profile
        self.clock = clock
        self.steps: list[StepEvent] = []
        self.live: dict[int, RequestMetrics] = {}
        self.finished: list[RequestMetrics] = []

    # -------------------------------------------------- request lifecycle

    def request_enqueued(self, rid: int, n_prompt: int = 0,
                         t: float | None = None) -> None:
        if not self.enabled:
            return
        self.live[rid] = RequestMetrics(
            rid=rid, n_prompt=n_prompt,
            t_enqueue=self.clock() if t is None else t,
        )
        self.registry.counter(
            "serve_requests_total", "requests submitted to the engine"
        ).inc()

    def request_admitted(self, rid: int, t: float | None = None) -> None:
        if not self.enabled:
            return
        r = self.live.get(rid)
        if r is None or r.t_admitted is not None:
            return
        r.t_admitted = self.clock() if t is None else t
        self.registry.histogram(
            "serve_queue_wait_seconds", "enqueue -> admission wait"
        ).observe(r.queue_wait_s)

    def token_emitted(self, rid: int, t: float | None = None) -> None:
        if not self.enabled:
            return
        r = self.live.get(rid)
        if r is None:
            return
        t = self.clock() if t is None else t
        if r.t_first_token is None:
            r.t_first_token = t
            self.registry.histogram(
                "serve_ttft_seconds", "enqueue -> first token (host wall)"
            ).observe(r.ttft_s)
        else:
            self.registry.histogram(
                "serve_token_latency_seconds",
                "inter-token decode gap (host wall)",
            ).observe(t - r.token_times[-1])
        r.token_times.append(t)
        self.registry.counter(
            "serve_tokens_generated_total", "tokens emitted"
        ).inc()

    def request_finished(self, rid: int, reason: str = "max_new",
                         t: float | None = None) -> None:
        if not self.enabled:
            return
        r = self.live.pop(rid, None)
        if r is None:
            return
        r.t_finish = self.clock() if t is None else t
        r.finish_reason = reason
        self.finished.append(r)
        self.registry.counter(
            "serve_requests_finished_total", "completed requests by reason",
            labels={"reason": reason},
        ).inc()
        if reason == "page_exhausted":
            self.registry.counter(
                "serve_evictions_total",
                "requests evicted on KV-page exhaustion",
            ).inc()
        self.registry.histogram(
            "serve_request_latency_seconds", "enqueue -> finish (host wall)"
        ).observe(r.e2e_s)

    # ------------------------------------------------------- engine steps

    def step_recorded(self, kind: str, rids: tuple, n_tokens: int,
                      t_start: float, t_end: float,
                      lanes: int | None = None) -> None:
        """Record one scheduled step. Always kept (it is the pipeline
        model's input); registry updates only when enabled."""
        self.steps.append(StepEvent(kind, tuple(rids), n_tokens,
                                    t_start, t_end))
        if not self.enabled:
            return
        self.registry.counter(
            "serve_steps_total", "scheduled engine steps by kind",
            labels={"kind": kind},
        ).inc()
        self.registry.histogram(
            "serve_step_wall_seconds", "host wall per scheduled step",
            labels={"kind": kind},
        ).observe(t_end - t_start)
        if kind == "decode" and lanes:
            self.registry.histogram(
                "serve_decode_occupancy",
                "live lanes / total lanes per decode step",
                buckets=reg_mod.RATIO_BUCKETS,
            ).observe(len(rids) / lanes)

    def lanes_state(self, queued: int, active: int, free_slots: int) -> None:
        if not self.enabled:
            return
        self.registry.gauge("serve_queue_depth", "waiting requests").set(queued)
        self.registry.gauge("serve_active_lanes", "lanes decoding live work").set(active)
        self.registry.gauge("serve_free_slots", "free KV pool slots").set(free_slots)

    # ------------------------------------------------------ derived views

    def legacy_trace(self) -> list:
        """The pre-PR ``(kind, rids, n_tokens)`` tuple list, derived."""
        return [e.legacy for e in self.steps]

    def reset(self) -> None:
        """Drop recorded steps and finished spans (e.g. after a jit
        warmup run) — registered metric values are left alone."""
        self.steps.clear()
        self.finished.clear()
        self.live.clear()

    def request_summary(self) -> dict:
        """Percentile summary over finished requests (host wall)."""

        def pct(samples):
            if not samples:
                return None
            s = sorted(samples)

            def at(q):
                return s[min(int(q * len(s)), len(s) - 1)]

            return {"p50": at(0.5), "p90": at(0.9), "p99": at(0.99),
                    "mean": sum(s) / len(s), "n": len(s)}

        reqs = self.finished
        intervals = [iv for r in reqs for iv in r.token_intervals_s]
        return {
            "n_requests": len(reqs),
            "n_tokens": sum(r.n_generated for r in reqs),
            "ttft_s": pct([r.ttft_s for r in reqs if r.ttft_s is not None]),
            "queue_wait_s": pct(
                [r.queue_wait_s for r in reqs if r.queue_wait_s is not None]
            ),
            "token_latency_s": pct(intervals),
            "e2e_s": pct([r.e2e_s for r in reqs if r.e2e_s is not None]),
            "finish_reasons": _count_by(
                r.finish_reason for r in reqs
            ),
        }


def _count_by(items) -> dict:
    out: dict = {}
    for x in items:
        out[x] = out.get(x, 0) + 1
    return out
