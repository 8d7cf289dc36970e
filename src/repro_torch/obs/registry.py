"""Host-side metrics registry: counters, gauges, fixed-bucket histograms.

Pure Python, no new dependencies — the serving stack runs on the host
between jitted steps, so its telemetry is ordinary Python bookkeeping.
Metric families follow Prometheus conventions (a family = name + type +
help, holding one series per label set) so the text-exposition exporter
(``repro_torch.obs.export``) is a direct mapping.

Histograms use fixed bucket boundaries (cumulative-free storage: one
count per bucket plus sum/count/min/max) and extract p50/p90/p99 by
linear interpolation inside the winning bucket — the standard
``histogram_quantile`` estimator, bounded by the recorded min/max so
tiny sample counts don't report a bucket edge nobody observed.
"""

from __future__ import annotations

import bisect
import math
import threading

# latency histograms default to a geometric ladder from 1us to ~67s —
# wide enough for host wall times on CPU smoke boxes and simulated
# pipeline latencies alike
LATENCY_BUCKETS_S = tuple(1e-6 * 2.0**i for i in range(27))
# fractions (occupancy, utilization): linear 0..1
RATIO_BUCKETS = tuple(round(0.05 * i, 2) for i in range(1, 21))
# shared block exponents (E8M0, unbiased): unit ladder wide enough for
# bf16-scale model activations/weights; the +Inf bucket catches hotter
# blocks, everything colder piles into the first bucket
EXP_BUCKETS = tuple(float(e) for e in range(-24, 17))


class Counter:
    """Monotonic counter."""

    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self._value += v

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value."""

    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    def dec(self, v: float = 1.0) -> None:
        self._value -= v

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with quantile extraction.

    ``buckets`` are the finite upper bounds (ascending); an implicit
    +Inf bucket catches the tail. ``quantile(q)`` interpolates linearly
    within the winning bucket, clamped to the observed [min, max].
    """

    __slots__ = ("buckets", "counts", "sum", "count", "min", "max")

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("buckets must be ascending and non-empty")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def merge_counts(self, counts, sum, count, vmin, vmax) -> None:
        """Bulk-merge pre-bucketed counts computed elsewhere (the fidelity
        probes histogram whole tensors on device with the same boundaries
        and fold the result in with one call instead of one ``observe``
        per element). ``counts`` must already include the +Inf bucket."""
        if len(counts) != len(self.counts):
            raise ValueError(
                f"bucket count mismatch: got {len(counts)}, "
                f"have {len(self.counts)}"
            )
        count = int(count)
        if not count:
            return
        for i, c in enumerate(counts):
            self.counts[i] += int(c)
        self.sum += float(sum)
        self.count += count
        self.min = min(self.min, float(vmin))
        self.max = max(self.max, float(vmax))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Prometheus-style histogram_quantile, clamped to [min, max]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} not in [0, 1]")
        if not self.count:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                frac = (rank - (cum - c)) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
        return self.max

    def percentiles(self) -> dict:
        return {f"p{int(q * 100)}": self.quantile(q)
                for q in (0.5, 0.9, 0.99)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One metric name: shared type/help, one child per label set."""

    __slots__ = ("name", "kind", "help", "buckets", "children")

    def __init__(self, name: str, kind: str, help: str = "",
                 buckets=LATENCY_BUCKETS_S):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.children: dict[tuple, object] = {}

    def labels(self, labels: dict | None = None):
        key = tuple(sorted((labels or {}).items()))
        child = self.children.get(key)
        if child is None:
            child = (Histogram(self.buckets) if self.kind == "histogram"
                     else _KINDS[self.kind]())
            self.children[key] = child
        return child


class MetricsRegistry:
    """Get-or-create access to metric families.

    ``counter/gauge/histogram(name, help=..., labels=...)`` return the
    series for that label set directly, creating family and series on
    first touch; re-registering a name with a different type raises.
    """

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, kind: str, help: str, buckets) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            elif help and not fam.help:
                fam.help = help
            return fam

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._family(name, "counter", help, None).labels(labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._family(name, "gauge", help, None).labels(labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None,
                  buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self._family(name, "histogram", help, buckets).labels(labels)

    def families(self) -> list:
        return [self._families[k] for k in sorted(self._families)]

    def snapshot(self) -> dict:
        """JSON-able dump: {name: {type, help, series: [...]}} with
        histogram series carrying buckets, sum/count, and p50/p90/p99."""
        out = {}
        for fam in self.families():
            series = []
            for key, child in sorted(fam.children.items()):
                entry: dict = {"labels": dict(key)}
                if fam.kind == "histogram":
                    entry.update(
                        count=child.count,
                        sum=child.sum,
                        min=child.min if child.count else None,
                        max=child.max if child.count else None,
                        buckets=[
                            {"le": le, "count": c}
                            for le, c in zip(
                                list(fam.buckets) + ["+Inf"], child.counts
                            )
                        ],
                        **child.percentiles(),
                    )
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[fam.name] = {
                "type": fam.kind, "help": fam.help, "series": series
            }
        return out
