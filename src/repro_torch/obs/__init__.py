"""Serving telemetry (pure Python host-side): the metrics registry, the
:class:`Obs` lifecycle tracer, structured logging, the kernel profiling
hook, the Prometheus / JSON exporters and SLO scoring — the parts of
``repro.obs`` the engine, the load harness and the launcher use."""

from repro_torch.obs.export import (  # noqa: F401
    parse_prometheus,
    to_json,
    to_prometheus,
    write_metrics,
)
from repro_torch.obs.log import get_logger, kv  # noqa: F401
from repro_torch.obs.profile import profiled_call  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    LATENCY_BUCKETS_S,
    RATIO_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.slo import SLOTargets, evaluate_slo  # noqa: F401
from repro_torch.obs.tracing import Obs, RequestMetrics, StepEvent  # noqa: F401
