"""Kernel profiling hook: every kernel wrapper routes its dispatch through
:func:`profiled_call`.

- On a CUDA machine the call runs inside an NVTX range ``repro/<name>``,
  which ``torch.profiler`` and NVTX-aware tools show on the timeline.
- With an enabled :class:`~repro_torch.obs.tracing.Obs` the dispatch is
  counted (``kernel_calls_total{kernel=}``).
"""

from __future__ import annotations

import contextlib

import torch


def profiled_call(name: str, obs, fn):
    """Run ``fn()`` under a named range; see the module docstring."""
    rng = (torch.cuda.nvtx.range(f"repro/{name}")
           if torch.cuda.is_available() else contextlib.nullcontext())
    with rng:
        out = fn()
    if obs is not None and obs.enabled:
        obs.registry.counter("kernel_calls_total",
                             "kernel wrapper dispatches",
                             labels={"kernel": name}).inc()
    return out
