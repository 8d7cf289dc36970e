"""Single-stream image serving for the encoder (ViT) workloads
(counterpart of ``repro.serving.vision``).

A :class:`VisionEngine` streams frames one at a time through a chain of
fixed-shape steps (an encoder has no KV cache and no decode step),
records each frame's stage traffic (token count = patch grid + CLS) as a
``frame`` step event, and maps that traffic onto the FWS pipeline model
of ``serving/pipeline.py``. On CUDA each chip's step is a CUDA graph
(``serving/graphs.py``), as the reference jits each chip, captured once
for each input shape; ``cuda_graphs=False`` runs the chain eagerly, and
``impl="ref"`` runs only so.

Dual-chip workloads (vit-l32: 24 blocks split 12+12, paper §5.3) run the
trunk as a chip chain on the one device: ``vit.split_chips`` slices the
layers with ``stage_partition``, each chip is one step, and the bf16
hidden state handed from one step to the next is the inter-chip hop that
``pipeline.simulate(chips=2)`` bills as an extra link stage. Captured,
one chip's static output is the next chip's static input.

Two kinds of figure come out, and they are not the same thing:

- ``fws_report``'s FPS and latencies are the analytical model of the
  MXFormer chip (``hwmodel``) driven by the measured token traffic,
  checked against the paper's Table 7 row (``paper_fps``). They say
  nothing about the speed of the device the engine ran on.
- The engine's own speed is the host wall clock of its frames (each
  frame ends in a host read of its top-1 class): the ``frame`` events'
  ``wall_s``, and the launcher's ``fps_host``.

The stage-parallel runner on a device mesh (``runner``,
``measured_report``) is not ported (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.hwmodel import specs as S
from repro_torch.models import vit
from repro_torch.obs import Obs
from repro_torch.serving import pipeline as pipe_mod
from repro_torch.serving.graphs import StepGraph

_NOT_PORTED = ("the stage-parallel pipelined runner needs distributed/"
               "pipeline_exec.py, not ported yet (ROADMAP.md Queue 1 item 9)")


@dataclasses.dataclass(frozen=True)
class VisionReport:
    pipeline: pipe_mod.PipelineReport
    fps: float  # steady-state frames/s of the FWS pipeline model
    frame_latency_s: float  # one frame through the full (multi-chip) pipe
    n_tokens: int  # measured stage traffic per frame
    d_model: int  # hardware width the pipeline was billed at
    chips: int
    paper_fps: float | None = None  # Table 7 row, when cross-validating

    @property
    def fps_error(self) -> float | None:
        if not self.paper_fps:
            return None
        return abs(self.fps - self.paper_fps) / self.paper_fps

    def publish(self, registry, prefix: str = "pipeline") -> None:
        """Export the FWS pipeline gauges plus the frame latency (and the
        paper cross-check, when present) into a registry."""
        self.pipeline.publish(registry, prefix=prefix)
        registry.gauge(
            f"{prefix}_frame_latency_seconds",
            "one frame through the full (multi-chip) pipeline",
        ).set(self.frame_latency_s)
        if self.paper_fps:
            registry.gauge(
                f"{prefix}_paper_fps_error",
                "relative error vs the paper's Table 7 row",
            ).set(self.fps_error)


def _chip_step(cfg, ctx, n_layers, first, last, chip_params, x):
    return vit.forward_chip(chip_params, cfg, ctx, x, n_layers, first, last)


def _whole_step(cfg, ctx, params, images):
    return vit.forward(params, cfg, ctx, {"images": images})[0]


class VisionEngine:
    """Fixed-shape single-stream frame engine over the backend registry:
    works under any linear backend (float, mxfp4, cim) with whatever
    converted parameters and ``RunCtx`` the caller built. Frames run on
    the device the parameters are on."""

    def __init__(self, params, cfg: vit.ViTConfig, ctx,
                 chips: int | None = None, obs: Obs | None = None,
                 runner=None, cuda_graphs: bool = True):
        if runner is not None:
            raise NotImplementedError(_NOT_PORTED)
        self.params = params
        self.cfg = cfg
        self.ctx = ctx
        self.chips = chips or cfg.chips
        self.obs = obs if obs is not None else Obs()
        self.device = params["pos"].device
        self._next_fid = 0
        if self.chips == 1:
            self._chain = [functools.partial(_whole_step, cfg, ctx, params)]
        else:
            self._chain = []
            chip_trees = vit.split_chips(params, cfg, self.chips)
            for ci, (chip_params, n_layers) in enumerate(chip_trees):
                self._chain.append(functools.partial(
                    _chip_step, cfg, ctx, n_layers, ci == 0,
                    ci == self.chips - 1, chip_params))
        # {(input shape, dtype): one captured StepGraph a chip}
        self.graphs: dict | None = None
        if cuda_graphs and self.device.type == "cuda":
            if ctx.impl == "ref":
                raise ValueError("impl='ref' runs eagerly: pass "
                                 "cuda_graphs=False")
            self.graphs = {}

    def _captured_chain(self, x: torch.Tensor) -> list:
        """The chain's graphs for ``x``'s shape, captured on first use:
        chip 0's static input takes ``x``; each later chip's static input
        is the previous chip's static output (the inter-chip hop)."""
        key = (tuple(x.shape), x.dtype)
        chain = self.graphs.get(key)
        if chain is None:
            inp, chain = x.clone(), []
            for step in self._chain:
                g = StepGraph(step, inp, obs=self.ctx.obs)
                g.capture()  # its static output holds this input's result
                chain.append(g)
                inp = g.static_out
            self.graphs[key] = chain
        return chain

    # --------------------------------------------------------- execution

    @torch.no_grad()
    def logits(self, images) -> torch.Tensor:
        """[B, H, W, C] through the chip chain -> logits [B, n_classes];
        the hidden state handed from one step to the next is the
        inter-chip hop."""
        x = torch.as_tensor(images, device=self.device)
        if self.graphs is None:
            for step in self._chain:
                x = step(x)
            return x
        chain = self._captured_chain(x)
        chain[0].static_in.copy_(x)
        for g in chain:
            out = g()
        return out.clone()  # the static output is the next frame's

    def classify_frame(self, image) -> int:
        """One frame [H, W, C] through the chip chain; returns the top-1
        class (a host read, which ends the frame) and records the frame's
        stage traffic as a ``frame`` step event."""
        t0 = self.obs.clock()
        logits = self.logits(torch.as_tensor(image)[None])
        top1 = int(torch.argmax(logits[0].float()))
        fid = self._next_fid
        self._next_fid += 1
        self.obs.step_recorded("frame", (fid,), self.cfg.seq_len,
                               t0, self.obs.clock())
        if self.obs.enabled:
            self.obs.registry.counter(
                "vision_frames_total", "frames streamed").inc()
        return top1

    @property
    def trace(self) -> list:
        """n_tokens per streamed frame (the measured stage traffic),
        rebuilt from the ``frame`` events."""
        return [e.n_tokens for e in self.obs.steps if e.kind == "frame"]

    def stream(self, frames) -> list[int]:
        """Stream frames ([N, H, W, C] or an iterable of [H, W, C]) one at
        a time through the chip chain (single-stream serving, the Table 7
        operating mode)."""
        return [self.classify_frame(f) for f in frames]

    def measured_report(self, frames, reps: int = 3):
        raise NotImplementedError(_NOT_PORTED)

    # ----------------------------------------------------------- reports

    def fws_report(self, workload: str | None = None,
                   min_frames: int = 240) -> VisionReport:
        """Map the measured per-frame stage traffic onto the FWS pipeline
        model. ``workload`` names a ``hwmodel.specs.WORKLOADS`` entry to
        cross-validate against: the pipeline is billed at that workload's
        hardware shape (d_model, chips), and the measured token count must
        match the workload's. The trace is tiled up to ``min_frames`` jobs
        so that the pipeline reaches steady state."""
        if not self.trace:
            raise ValueError("no frames streamed yet")
        d_model, chips, paper_fps = self.cfg.d_model, self.chips, None
        if workload is not None:
            w = S.WORKLOADS[workload]
            if w.seq != self.cfg.seq_len:
                raise ValueError(
                    f"measured stage traffic ({self.cfg.seq_len} tokens) "
                    f"!= workload {workload!r} ({w.seq} tokens)")
            d_model, chips = w.d, w.chips
            if workload in S.PAPER_TABLE7:
                paper_fps = S.PAPER_TABLE7[workload][1]
            elif workload in S.PAPER_TABLE9:
                paper_fps = S.PAPER_TABLE9[workload]
        trace = list(self.trace)
        while len(trace) < min_frames:
            trace.extend(self.trace)
        rep = pipe_mod.simulate([pipe_mod.Job(0.0, n) for n in trace],
                                d_model, chips=chips)
        return VisionReport(pipeline=rep, fps=rep.steady_state_fps,
                            frame_latency_s=rep.timings[0].latency,
                            n_tokens=self.trace[0], d_model=d_model,
                            chips=chips, paper_fps=paper_fps)


def synthetic_stream_report(n_tokens: int, d_model: int, chips: int = 1,
                            n_frames: int = 240,
                            paper_fps: float | None = None) -> VisionReport:
    """FWS pipeline report for traffic-shaped streams with no model run:
    only the (N, d, chips) shape matters."""
    rep = pipe_mod.simulate(
        [pipe_mod.Job(0.0, n_tokens) for _ in range(n_frames)],
        d_model, chips=chips)
    return VisionReport(pipeline=rep, fps=rep.steady_state_fps,
                        frame_latency_s=rep.timings[0].latency,
                        n_tokens=n_tokens, d_model=d_model, chips=chips,
                        paper_fps=paper_fps)
