"""Continuous-batching serving on the fused paged KV pool."""

from repro_torch.serving.engine import Engine, EngineConfig  # noqa: F401
from repro_torch.serving.prefix import PrefixCache  # noqa: F401
