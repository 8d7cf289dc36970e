"""Continuous-batching serving on the fused paged KV pool, single-stream
frame serving for the ViT workloads, and the FWS pipeline model."""

from repro_torch.serving.engine import Engine, EngineConfig  # noqa: F401
from repro_torch.serving.pipeline import (  # noqa: F401
    Job,
    PipelineReport,
    TraceReport,
    simulate,
    simulate_trace,
)
from repro_torch.serving.prefix import PrefixCache  # noqa: F401
from repro_torch.serving.vision import (  # noqa: F401
    VisionEngine,
    VisionReport,
    synthetic_stream_report,
)
