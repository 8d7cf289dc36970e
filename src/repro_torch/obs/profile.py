"""Kernel profiling hook: every kernel wrapper routes its dispatch through
:func:`profiled_call` (counterpart of ``repro.obs.profile``).

- On a CUDA machine the call runs inside an NVTX range ``repro/<name>``,
  which ``torch.profiler`` and NVTX-aware tools show on the timeline.
- With an enabled :class:`~repro_torch.obs.tracing.Obs` the dispatch is
  counted (``kernel_calls_total{kernel=,mode=}``). A call made while a
  CUDA graph is being captured, the reference's traced call, counts as
  ``mode="traced"`` and never synchronizes; each replay of the graph adds
  what its capture counted (``serving/graphs.py``). Other calls count as
  ``mode="eager"``.
- With ``obs.profile=True`` (the launcher's ``--profile``; off by
  default) an eager call also synchronizes the device and records its
  wall time, dispatch to done, in the ``kernel_wall_seconds{kernel=}``
  histogram.
"""

from __future__ import annotations

import contextlib
import time

import torch


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def profiled_call(name: str, obs, fn):
    """Run ``fn()`` under a named range; see the module docstring."""
    cuda = torch.cuda.is_available()
    rng = (torch.cuda.nvtx.range(f"repro/{name}") if cuda
           else contextlib.nullcontext())
    if obs is None or not obs.enabled:
        with rng:
            return fn()
    t0 = time.perf_counter()
    with rng:
        out = fn()
    traced = capturing()
    obs.registry.counter(
        "kernel_calls_total", "kernel wrapper dispatches",
        labels={"kernel": name, "mode": "traced" if traced else "eager"},
    ).inc()
    if obs.profile and not traced:
        if cuda:
            torch.cuda.synchronize()
        obs.registry.histogram(
            "kernel_wall_seconds",
            "eager kernel wall time (dispatch -> ready; --profile only)",
            labels={"kernel": name},
        ).observe(time.perf_counter() - t0)
    return out
