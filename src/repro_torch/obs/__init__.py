"""Serving telemetry (host-side): the metrics registry, the :class:`Obs`
lifecycle tracer, structured logging, the kernel profiling hook, the
Prometheus / JSON exporters, SLO scoring and numerical-fidelity
observability (:mod:`repro_torch.obs.fidelity`: per-layer SQNR tracing,
the :class:`FidelityProbe`'s MXFP4 / ADC health metrics and the
calibration-drift check), as ``repro.obs`` exports them."""

from repro_torch.obs.export import (  # noqa: F401
    parse_prometheus,
    to_json,
    to_prometheus,
    write_metrics,
)
from repro_torch.obs.fidelity import (  # noqa: F401
    FidelityProbe,
    run_fidelity_pass,
    scale_adc_fs,
    sqnr_db,
    sqnr_trace,
)
from repro_torch.obs.log import get_logger, kv  # noqa: F401
from repro_torch.obs.profile import profiled_call  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    EXP_BUCKETS,
    LATENCY_BUCKETS_S,
    RATIO_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.slo import SLOTargets, evaluate_slo  # noqa: F401
from repro_torch.obs.tracing import Obs, RequestMetrics, StepEvent  # noqa: F401
