"""CUDA graphs of the engines' fixed-shape steps: the port's counterpart
of the reference's ``jax.jit`` of a step (``src/repro/serving/engine.py``
jits the prefill, decode, chunk and clone steps,
``src/repro/serving/vision.py`` each chip's frame step).

A :class:`StepGraph` owns one step's static input (a device tensor the
caller writes before each call) and its static output (the tensor the
captured step wrote, or None for a step that only writes in place; the
next replay overwrites it). Each graph has a private memory pool. The
first call warms the step up eagerly on a side stream, PyTorch's
``torch.cuda.graph`` recipe, which triggers every lazy one-time setup
before the capture: the kernel libraries and their typed launch
functions, CUDA's lazy module loads, ``cim_linear``'s ``splitk``
workspace and ``guard_rows``, ``mxfp4_matmul``'s ``mma`` arrival
counters, the MXFP4 pair table and code tables and the RoPE
frequencies. Then it captures the step; every call is one
``graph.replay()``.

Launch counters. The kernel wrappers count in Python, and a graph's
Python runs once, at capture. :func:`read_counts` takes every counter the
step's Python moves (each wrapper's ``launches`` and ``route_launches``,
and an ``Obs``'s ``kernel_calls_total``); the capture records how far
they moved (:func:`counts_delta`), sets them back to where they stood
before the warm-up, and every replay adds that delta (:func:`add_counts`).
So the counts read as if the step had run eagerly once a call; the
warm-up and capture launches are set-up and are not counted.

Nothing falls back: a capture or replay that fails raises. A step on the
CPU has nothing to capture, and the engines run it as it is.
"""

from __future__ import annotations

import time

import torch

KERNEL_CALLS = "kernel_calls_total"  # the Obs family profiled_call moves
WARMUP = 2  # eager runs of the step before its capture


def _wrappers() -> dict:
    """Every kernel wrapper by kernel name (each has ``launches``; the
    matmul and attention wrappers also ``route_launches``)."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pops

    return {"cim_linear": cim_ops.cim_linear,
            "paged_decode_mx": pops.paged_flash_decode_mx,
            "mxfp4_matmul": mm_ops.mxfp4_matmul,
            "paged_decode": pops.paged_flash_decode,
            "flash_attention": fa_ops.flash_attention}


def _obs_children(obs) -> dict:
    """``{label key: Counter}`` of ``obs``'s kernel-call family (empty
    without an enabled ``obs``)."""
    if obs is None or not obs.enabled:
        return {}
    fam = next((f for f in obs.registry.families()
                if f.name == KERNEL_CALLS), None)
    return dict(fam.children) if fam is not None else {}


def read_counts(obs=None) -> dict:
    """Every launch counter a step's Python moves, flat:
    ``("launches", kernel)``, ``("route", kernel, route)`` and, with an
    enabled ``obs``, ``("obs", labels)`` for ``kernel_calls_total``."""
    out: dict = {}
    for name, fn in _wrappers().items():
        out[("launches", name)] = fn.launches
        for route, n in getattr(fn, "route_launches", {}).items():
            out[("route", name, route)] = n
    for key, child in _obs_children(obs).items():
        out[("obs", key)] = child.value
    return out


def counts_delta(before: dict, after: dict) -> dict:
    """How far each counter moved from ``before`` to ``after`` (the
    counters that did not move are left out)."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add_counts(delta: dict, obs=None) -> None:
    """Move each counter of :func:`read_counts` by ``delta``."""
    wrappers = _wrappers()
    for key, n in delta.items():
        if key[0] == "launches":
            wrappers[key[1]].launches += n
        elif key[0] == "route":
            wrappers[key[1]].route_launches[key[2]] += n
        else:
            obs.registry.counter(KERNEL_CALLS, labels=dict(key[1])).inc(n)


def set_counts(values: dict, obs=None) -> None:
    """Set each counter of :func:`read_counts` back to ``values``; a
    counter that did not exist in ``values`` goes back to 0."""
    wrappers = _wrappers()
    now = read_counts(obs)
    for key in now:
        v = values.get(key, 0)
        if key[0] == "launches":
            wrappers[key[1]].launches = v
        elif key[0] == "route":
            wrappers[key[1]].route_launches[key[2]] = v
        else:  # a registry counter only goes up: reset it in place
            _obs_children(obs)[key[1]]._value = v


def _shared_scratch() -> tuple:
    """The kernels' per-device scratch a captured step may point at:
    ``cim_linear``'s workspaces and guard counters and ``mxfp4_matmul``'s
    arrival counters. A wrapper that grows one replaces the tensor, and a
    graph that still holds the old pointer must keep it alive."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops

    return (tuple(cim_ops._workspaces.values()),
            tuple(cim_ops._guard_rows.values()),
            tuple(mm_ops._arrivals.values()))


class StepGraph:
    """One fixed-shape step captured as a CUDA graph.

    ``step(static_in)`` computes the step's output tensor from the static
    input (a CUDA tensor the caller owns and writes before each call),
    launching on the current stream, with no host sync and no copy from
    the host. After :meth:`capture` the static output holds the warm-up's
    result for the input then in ``static_in``."""

    def __init__(self, step, static_in: torch.Tensor, obs=None):
        if static_in.device.type != "cuda":
            raise ValueError("StepGraph captures CUDA steps only; a CPU step "
                             "runs as it is")
        self.step = step
        self.static_in = static_in
        self.obs = obs
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static_out: torch.Tensor | None = None
        self.delta: dict = {}  # launch counts a replay adds
        self.capture_s: float | None = None  # warm-up and capture wall
        self.pool_bytes: int | None = None  # memory the capture reserved
        self._scratch: tuple = ()

    @torch.no_grad()
    def capture(self) -> None:
        """Warm the step up on a side stream, capture it, and set the
        launch counters back to where they stood (see the module
        docstring). Raises if the capture fails or if the warm-up runs
        and the capture launched different kernels."""
        dev = self.static_in.device
        t0 = time.perf_counter()
        before = read_counts(self.obs)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                warm_out = self.step(self.static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = read_counts(self.obs)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.step(self.static_in)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        delta = counts_delta(warm, read_counts(self.obs))
        if counts_delta(before, warm) != {k: WARMUP * n
                                          for k, n in delta.items()}:
            raise RuntimeError(
                f"the step's warm-up launched {counts_delta(before, warm)}, "
                f"its capture {delta}: not one fixed step")
        set_counts(before, self.obs)
        if out is not None:
            out.copy_(warm_out)  # what a replay on this input gives
        self.graph, self.static_out, self.delta = graph, out, delta
        self._scratch = _shared_scratch()
        self.capture_s = time.perf_counter() - t0

    def __call__(self) -> torch.Tensor | None:
        """Replay the step on what ``static_in`` holds (capturing it
        first); returns the static output, valid until the next call."""
        if self.graph is None:
            self.capture()
        self.graph.replay()
        add_counts(self.delta, self.obs)
        return self.static_out
