"""Trace-driven load harness for the continuous-batching engine.

Production traffic is not a staggered for-loop: arrivals are bursty
(Poisson or recorded traces), prompt and output lengths are mixed, and
most prompts open with one of a handful of shared system prompts. This
module synthesizes exactly that workload and replays it through the real
:class:`~repro_torch.serving.engine.Engine` on the host wall clock, so the
request-span tracer (``repro_torch.obs``) measures TTFT / queue-wait /
per-token latency under genuine queueing pressure and
``evaluate_slo`` scores the run.

Pieces:
  * arrival processes — :func:`poisson_arrivals` (exponential
    inter-arrival gaps at a given requests/s rate) and scripted traces
    (:func:`load_trace` / :func:`save_trace`, JSON on disk) share the
    :class:`LoadRequest` record;
  * workload synthesis — :func:`synth_requests` draws prompt/output
    lengths from ranges and prefixes a fraction of prompts with shared
    system prompts (what gives the prefix cache something to hit);
  * replay — :func:`replay` submits each request when the host clock
    passes its arrival time (``speed`` compresses recorded time) and
    steps the engine in between;
  * reporting — :func:`load_report` folds the engine's telemetry into
    one dict (p50/p99 TTFT, per-token latency, prefix-cache hit rate,
    eviction counts, SLO verdict).

A copy of ``repro.serving.load``: the same seed gives the same trace
(the numpy RNG calls are the reference's, in its order).
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from repro_torch.obs import SLOTargets, evaluate_slo


@dataclasses.dataclass(frozen=True)
class LoadRequest:
    t: float  # arrival time, seconds from trace start
    prompt: tuple[int, ...]
    max_new: int


# ------------------------------------------------------------- arrivals

def poisson_arrivals(rate_rps: float, n: int, rng) -> np.ndarray:
    """``n`` arrival times with exponential inter-arrival gaps at
    ``rate_rps`` requests/second (a Poisson process)."""
    if rate_rps <= 0:
        raise ValueError("rate must be > 0")
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def burst_arrivals(n: int, burst: int, gap_s: float) -> np.ndarray:
    """Deterministic scripted process: bursts of ``burst`` simultaneous
    arrivals every ``gap_s`` seconds — the adversarial case for admission
    (queue spikes) and the friendly case for the prefix cache (a burst
    shares its system prompt)."""
    return np.asarray([(i // burst) * gap_s for i in range(n)])


def parse_arrivals(spec: str):
    """CLI arrival spec: ``poisson:RATE`` | ``trace:FILE`` |
    ``burst:N:GAP_S``. Returns ``(kind, value)``."""
    kind, _, val = spec.partition(":")
    if kind == "poisson":
        return "poisson", float(val)
    if kind == "trace":
        if not val:
            raise ValueError("trace arrivals need a file: trace:FILE")
        return "trace", val
    if kind == "burst":
        n, _, gap = val.partition(":")
        return "burst", (int(n), float(gap or "0.05"))
    raise ValueError(f"unknown arrivals spec {spec!r} "
                     "(poisson:RATE | trace:FILE | burst:N:GAP_S)")


# ------------------------------------------------------------- workload

@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Mixed prompt/output-length + shared-system-prompt distribution."""

    vocab_size: int
    prompt_len: tuple[int, int] = (2, 16)  # inclusive user-suffix range
    out_len: tuple[int, int] = (2, 8)  # inclusive max_new range
    n_system: int = 2  # distinct shared system prompts
    system_len: int = 8  # tokens per system prompt
    p_shared: float = 0.75  # fraction of prompts opening with one
    max_prompt: int | None = None  # cap (engine page/prefill budget)


def synth_requests(spec: WorkloadSpec, n: int, rng) -> list[tuple[list, int]]:
    """Draw ``n`` (prompt, max_new) pairs from the workload spec."""
    systems = [
        rng.integers(0, spec.vocab_size, size=spec.system_len).tolist()
        for _ in range(spec.n_system)
    ]
    out = []
    for _ in range(n):
        body = rng.integers(
            0, spec.vocab_size,
            size=int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1)),
        ).tolist()
        prompt = body
        if systems and rng.random() < spec.p_shared:
            prompt = systems[int(rng.integers(len(systems)))] + body
        if spec.max_prompt is not None:
            prompt = prompt[:spec.max_prompt]
        out.append(
            (prompt, int(rng.integers(spec.out_len[0], spec.out_len[1] + 1)))
        )
    return out


def make_trace(arrival_times, requests) -> list[LoadRequest]:
    return [
        LoadRequest(t=float(t), prompt=tuple(p), max_new=m)
        for t, (p, m) in zip(arrival_times, requests)
    ]


def save_trace(path: str, trace: list[LoadRequest]) -> None:
    with open(path, "w") as f:
        json.dump({"requests": [
            {"t": r.t, "prompt": list(r.prompt), "max_new": r.max_new}
            for r in trace
        ]}, f)


def load_trace(path: str) -> list[LoadRequest]:
    with open(path) as f:
        doc = json.load(f)
    return [
        LoadRequest(t=float(r["t"]), prompt=tuple(int(t) for t in r["prompt"]),
                    max_new=int(r["max_new"]))
        for r in doc["requests"]
    ]


# --------------------------------------------------------------- replay

def replay(engine, trace: list[LoadRequest], speed: float = 1.0,
           max_steps: int = 1_000_000) -> dict:
    """Wall-clock replay: submit each request when the host clock passes
    ``t / speed``, stepping the engine in between (idle gaps sleep in
    sub-millisecond slices so arrival timing stays honest). Returns
    ``{rid: out tokens}`` plus replay wall time."""
    trace = sorted(trace, key=lambda r: r.t)
    rids: list[int] = []
    t0 = time.perf_counter()
    i, steps = 0, 0
    while i < len(trace) or engine.sched.has_work:
        now = (time.perf_counter() - t0) * speed
        while i < len(trace) and trace[i].t <= now:
            rids.append(engine.add_request(list(trace[i].prompt),
                                           max_new=trace[i].max_new))
            i += 1
        if engine.sched.has_work:
            engine.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"replay did not drain in {max_steps} "
                                   "steps")
        elif i < len(trace):
            wait = trace[i].t / speed - (time.perf_counter() - t0)
            time.sleep(min(max(wait, 0.0), 5e-4))
    return {
        "out": {rid: list(engine.requests[rid].out) for rid in rids},
        "wall_s": time.perf_counter() - t0,
        "steps": steps,
    }


# ------------------------------------------------------------ reporting

def load_report(engine, targets: SLOTargets | None = None,
                wall_s: float | None = None) -> dict:
    """Fold one replayed run into one dict (the reference's "load"
    schema): request-latency percentiles, step mix, prefix-cache stats,
    eviction counts, and (when targets are given) the SLO verdict."""
    obs = engine.obs
    summ = obs.request_summary()
    kinds = [e.kind for e in obs.steps]
    reasons = summ.get("finish_reasons", {})
    # obs-derived counts so a warm-up run (the steps' graph captures)
    # followed by obs.reset() doesn't leak into the report
    n_tok = summ.get("n_tokens", 0)
    rep = {
        "n_requests": summ.get("n_requests", 0),
        "tokens_generated": n_tok,
        "steps": {"prefill": kinds.count("prefill"),
                  "decode": kinds.count("decode")},
        "ttft_s": summ.get("ttft_s"),
        "token_latency_s": summ.get("token_latency_s"),
        "queue_wait_s": summ.get("queue_wait_s"),
        "e2e_s": summ.get("e2e_s"),
        "finish_reasons": reasons,
        "page_evictions": reasons.get("page_exhausted", 0),
        "slot_utilization": engine.slot_utilization,
        "prefix": engine.prefix_stats(),
    }
    if wall_s is not None:
        rep["wall_s"] = wall_s
        rep["tokens_per_s_wall"] = n_tok / wall_s if wall_s > 0 else 0.0
    if targets is not None:
        rep["slo"] = evaluate_slo(obs.finished, targets)
    return rep
