"""SLO evaluation over finished-request telemetry.

``SLOTargets`` names configurable latency objectives (TTFT and
per-token, p50 and p99, in seconds; ``None`` disables a check) and
``evaluate_slo`` scores a set of :class:`RequestMetrics` spans against
them: per-check observed-vs-target pass/fail, per-request/per-interval
violation counts against the p99 targets, and an overall verdict (a copy
of ``repro.obs.slo``). The load harness (``serving/load.py``) folds the
verdict into its report.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    ttft_p50_s: float | None = None
    ttft_p99_s: float | None = None
    token_p50_s: float | None = None
    token_p99_s: float | None = None

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def _pct(samples: list, q: float) -> float | None:
    if not samples:
        return None
    s = sorted(samples)
    return s[min(int(q * len(s)), len(s) - 1)]


def evaluate_slo(requests, targets: SLOTargets) -> dict:
    """Score finished requests against the targets.

    Returns ``{targets, observed, checks, violations, pass}``; a check
    with no samples reports ``ok=None`` and does not fail the verdict.
    """
    ttft = [r.ttft_s for r in requests if r.ttft_s is not None]
    tokens = [iv for r in requests for iv in r.token_intervals_s]
    observed = {
        "ttft_p50_s": _pct(ttft, 0.5),
        "ttft_p99_s": _pct(ttft, 0.99),
        "token_p50_s": _pct(tokens, 0.5),
        "token_p99_s": _pct(tokens, 0.99),
    }
    checks = {}
    for key, target in targets.asdict().items():
        if target is None:
            continue
        got = observed[key]
        checks[key] = {
            "target_s": target,
            "observed_s": got,
            "ok": None if got is None else got <= target,
        }
    violations = {}
    if targets.ttft_p99_s is not None:
        violations["ttft_over_p99_target"] = sum(
            1 for v in ttft if v > targets.ttft_p99_s
        )
    if targets.token_p99_s is not None:
        violations["tokens_over_p99_target"] = sum(
            1 for v in tokens if v > targets.token_p99_s
        )
    return {
        "targets": targets.asdict(),
        "observed": observed,
        "checks": checks,
        "violations": violations,
        "pass": all(c["ok"] is not False for c in checks.values()),
    }
