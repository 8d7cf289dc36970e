"""Stage-parallel FWS pipeline execution over a (replica, stage) grid of
devices (counterpart of the reference's
``repro.distributed.pipeline_exec``).

``serving/pipeline.py`` models the paper's fully-weight-stationary
pipeline (§5.3) as discrete events; this module runs it:

- ``stage_partition`` cuts the layer stack into contiguous stages, equal
  by default or cost-balanced (``mode="balanced"``, costs from
  ``blockwise.serve_layer_costs``). Each grid place's layer dicts are
  moved to its device **once**, at construction, and never again (the
  FWS premise); :meth:`StagePipeline.trunk_resident` checks that every
  trunk tensor is still on its place's device at the address recorded
  then.
- Microbatches stream stage to stage on the reference's GPipe schedule:
  ``T = microbatches + stages - 1`` fill / steady / drain slots, stage
  ``s`` taking microbatch ``t - s`` at slot ``t``, each replica on its
  row of the grid. The hop from stage ``s`` to ``s + 1`` is a copy of the
  stage's output activation into the next stage's input buffer on the
  next stage's device (the reference's ``ppermute``); every hop adds its
  bytes to a ``CollectiveStats`` under the reference's name for it,
  ``collective-permute``, and a hop given a trunk tensor raises.
- On CUDA every grid place runs on its own ``torch.cuda.Stream``, forked
  from the caller's stream at the start of a step and joined back at its
  end; CUDA events order each hop after the stage that produced it. A
  grid may repeat a device (``make_pipeline_mesh(devices=...)``): its
  stages then share the card, each on its own stream and its own kernel
  scratch (``kernels.scratch_slot``). On one card the whole step, all T
  slots on all streams, is captured once as one CUDA graph
  (``serving/graphs.py::StepGraph``, the counterpart of the reference's
  one jitted ``shard_map`` step); ``cuda_graphs=False`` runs the same
  schedule eagerly. A grid over several cards runs eagerly (one graph
  does not span cards here). On the CPU the step runs eagerly, in
  schedule order.

A stage runs ``lm.run_segment`` over its own slice of layers with the
whole segment's capture paths (``segments/0/L<lo + j>``) and the
positions (and, for an LM, ``arange_positions``) that ``lm.forward``
gives its layers. Unequal cuts need no padding or mask: a stage with
fewer layers runs fewer (the reference pads and masks only because its
stage body is one ``scan`` shape). The embedding front runs before the
step on the first grid place's device and the final norm and head after
it on the last stage's, as in the reference.

Only models of one homogeneous attention segment (dense LMs, ViTs) are
taken, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Callable

import torch

from repro_torch import kernels
from repro_torch.distributed import blockwise
from repro_torch.distributed.roofline import CollectiveStats
from repro_torch.distributed.sharding import stage_partition
from repro_torch.layers.backends import layer_paths
from repro_torch.layers.common import RunCtx, norm_apply
from repro_torch.models import lm

__all__ = [
    "PipelineMesh",
    "StagePipeline",
    "ReplicaRouter",
    "MeasuredReport",
    "make_pipeline_mesh",
    "build_lm_pipeline",
    "build_vit_pipeline",
]

HOP = "collective-permute"  # the reference's name of the activation hop


def _device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class PipelineMesh:
    """A (replica, stage) grid of devices: ``devices[r][s]`` runs stage
    ``s`` of pipeline replica ``r``."""

    devices: tuple
    axis_names = ("replica", "stage")

    @property
    def shape(self) -> dict:
        return {"replica": len(self.devices), "stage": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


def make_pipeline_mesh(stages: int, replicas: int = 1,
                       devices=None) -> PipelineMesh:
    """(replica, stage) grid over the first ``replicas * stages`` visible
    CUDA devices, one device a grid place; with fewer it raises. An
    explicit ``devices`` list (at least ``replicas * stages`` long) may
    repeat a device: the grid places on it then share the card, each on
    its own stream (on the CPU: ``[torch.device("cpu")] * n``)."""
    n = stages * replicas
    if stages < 1 or replicas < 1:
        raise ValueError(f"need stages >= 1 and replicas >= 1, got "
                         f"{replicas}x{stages}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(
                f"pipeline mesh needs {replicas}x{stages} = {n} devices, "
                f"have {have} CUDA device(s) (hint: devices=[...] may "
                f"repeat a device, each grid place then on its own stream)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"pipeline mesh needs {replicas}x{stages} = {n} "
                         f"devices, devices= gives {len(devices)}")
    if len({d.type for d in devices[:n]}) != 1:
        raise ValueError("a pipeline mesh is all CPU or all CUDA")
    return PipelineMesh(tuple(tuple(devices[r * stages:(r + 1) * stages])
                              for r in range(replicas)))


def _place(tree, dev):
    """``tree``'s tensors on ``dev`` (a tensor already there is kept)."""
    if isinstance(tree, dict):
        return {k: _place(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place(v, dev) for v in tree]
    if torch.is_tensor(tree):
        return tree.to(dev)
    return tree


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


def _pad_rows(tree, cap: int):
    """Pad every tensor's leading (batch) axis to ``cap`` rows by
    repeating the last row: the ragged final microbatch's filler."""
    def f(a):
        n = a.shape[0]
        if n == cap:
            return a
        return torch.cat([a, a[-1:].expand(cap - n, *a.shape[1:])])

    return {k: f(v) for k, v in tree.items()}


def _rows(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


def _sync(devices) -> None:
    for dev in {d for row in devices for d in row if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


@dataclasses.dataclass(frozen=True)
class MeasuredReport:
    """Pipeline health measured from runs on the device grid (the
    measured counterpart of ``serving.pipeline.PipelineReport``)."""

    name: str
    n_stages: int
    n_replicas: int
    microbatches: int  # per replica
    mb_size: int
    step_wall_s: float  # one forward: embed, the step, head (min over reps)
    stage_walls_s: tuple  # one microbatch through each stage, isolated
    throughput_items_per_s: float  # rows per step wall (fill included)
    steady_items_per_s: float  # drain rate implied by the bottleneck stage
    bubble_fraction: float  # mean stage idle fraction over the step wall
    fill_latency_s: float  # first microbatch through all stages (estimate)

    @property
    def stage_occupancy(self) -> tuple:
        """Busy fraction of each stage over the step wall."""
        if not self.step_wall_s:
            return tuple(0.0 for _ in self.stage_walls_s)
        return tuple(min(1.0, self.microbatches * w / self.step_wall_s)
                     for w in self.stage_walls_s)

    def publish(self, registry, prefix: str = "pipeline_measured") -> None:
        """Export the measured gauges next to the simulated ``pipeline_*``
        family (the reference's names and stage labels)."""
        g = registry.gauge
        for i, (w, occ) in enumerate(zip(self.stage_walls_s,
                                         self.stage_occupancy)):
            g(f"{prefix}_stage_wall_seconds",
              "one microbatch through this stage (measured, isolated)",
              labels={"stage": str(i)}).set(w)
            g(f"{prefix}_stage_occupancy",
              "measured busy fraction of this stage over the step wall",
              labels={"stage": str(i)}).set(occ)
        g(f"{prefix}_bubble_fraction",
          "measured mean stage idle fraction over the step wall").set(
            self.bubble_fraction)
        g(f"{prefix}_fill_latency_seconds",
          "measured first-microbatch traversal of the stage chain").set(
            self.fill_latency_s)
        g(f"{prefix}_step_wall_seconds",
          "one fill+steady+drain pipeline step").set(self.step_wall_s)
        g(f"{prefix}_throughput_items_per_s",
          "rows per step wall, fill included").set(
            self.throughput_items_per_s)
        g(f"{prefix}_steady_state_fps",
          "drain rate implied by the measured bottleneck stage").set(
            self.steady_items_per_s)
        g(f"{prefix}_stages", "pipeline depth").set(float(self.n_stages))
        g(f"{prefix}_replicas", "data-parallel pipeline replicas").set(
            float(self.n_replicas))


class StagePipeline:
    """Stage-parallel executor: resident per-stage weights, overlapping
    microbatches, one step a forward (on one card: one CUDA graph).

    Built by :func:`build_lm_pipeline` / :func:`build_vit_pipeline`.
    ``stage_fn(layers, paths, x)`` runs one stage's layers (capture
    ``paths``) over one microbatch ``x`` [mb, seq, d]; ``embed_fn(front,
    batch)`` and ``head_fn(back, y)`` run before and after the step."""

    def __init__(self, *, mesh: PipelineMesh, bounds, trunk: list, front,
                 back, embed_fn: Callable, stage_fn: Callable,
                 head_fn: Callable, microbatches: int, mb_size: int,
                 name: str = "model", cuda_graphs: bool = True,
                 obs=None):
        if tuple(getattr(mesh, "axis_names", ())) != ("replica", "stage"):
            raise ValueError(f"need a (replica, stage) mesh, got "
                             f"{getattr(mesh, 'axis_names', mesh)}")
        self.mesh = mesh
        self.bounds = [tuple(b) for b in bounds]
        self.name = name
        self.n_stages = mesh.shape["stage"]
        self.n_replicas = mesh.shape["replica"]
        if len(self.bounds) != self.n_stages:
            raise ValueError(f"{len(self.bounds)} stage cuts for a "
                             f"{self.n_stages}-stage mesh")
        self.microbatches = int(microbatches)
        self.mb_size = int(mb_size)
        if self.microbatches < 1 or self.mb_size < 1:
            raise ValueError("need microbatches >= 1 and mb_size >= 1")
        self.lengths = [hi - lo for lo, hi in self.bounds]
        paths = layer_paths("segments/0", len(trunk))
        self._paths = [paths[lo:hi] for lo, hi in self.bounds]
        # resident placement: done once, never repeated (FWS premise); a
        # grid place on a device that already holds the layers keeps them
        self.trunk = [[_place(trunk[lo:hi], dev)
                       for (lo, hi), dev in zip(self.bounds, row)]
                      for row in mesh.devices]
        self._ptrs = [[[t.data_ptr() for t in _tensors(stage)]
                       for stage in row] for row in self.trunk]
        self._trunk_storage = {t.untyped_storage().data_ptr()
                               for row in self.trunk for stage in row
                               for t in _tensors(stage)}
        self.front = _place(front, mesh.devices[0][0])
        self.back = _place(back, mesh.devices[0][-1])
        self._embed, self._head, self._stage_fn = embed_fn, head_fn, stage_fn
        self.obs = obs
        on_cuda = mesh.devices[0][0].type == "cuda"
        self.streams = ([[torch.cuda.Stream(dev) for dev in row]
                         for row in mesh.devices] if on_cuda else None)
        # {(input shape, dtype): (captured step, its hops)}
        self.graphs: dict | None = None
        if cuda_graphs and on_cuda:
            if len({d for row in mesh.devices for d in row}) > 1:
                raise ValueError("a captured pipeline step runs on one "
                                 "card: pass cuda_graphs=False for a grid "
                                 "over several")
            self.graphs = {}
        self._step_hops: CollectiveStats | None = None
        self._last_report: MeasuredReport | None = None

    # --------------------------------------------------------- execution

    @property
    def capacity(self) -> int:
        """Rows one step processes: replicas x microbatches x mb_size."""
        return self.n_replicas * self.microbatches * self.mb_size

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def trunk_bytes(self) -> int:
        """Bytes of one copy of the trunk (the first replica's stages)."""
        return sum(t.numel() * t.element_size()
                   for stage in self.trunk[0] for t in _tensors(stage))

    @contextlib.contextmanager
    def _at(self, r: int, s: int):
        """Grid place (r, s): its device, stream and kernel scratch."""
        if self.streams is None:
            yield
            return
        dev = self.mesh.devices[r][s]
        with torch.cuda.device(dev), torch.cuda.stream(self.streams[r][s]), \
                kernels.scratch_slot(("pipeline stage", r, s)):
            yield

    def _hop(self, y: torch.Tensor, buf: torch.Tensor | None, dev,
             hops: CollectiveStats) -> torch.Tensor:
        """Copy a stage's output activation into the next stage's input
        buffer on ``dev`` (allocated at the first hop of a step, on the
        next stage's stream) and bill its bytes."""
        if y.untyped_storage().data_ptr() in self._trunk_storage:
            raise RuntimeError("a trunk tensor reached a stage hop: weights "
                               "never move")
        if buf is None:
            buf = torch.empty(y.shape, dtype=y.dtype, device=dev)
        buf.copy_(y)
        hops.add(HOP, y.numel() * y.element_size())
        return buf

    def _trunk_step(self, xg: torch.Tensor) -> torch.Tensor:
        """One GPipe step over the grid: ``xg`` [R * M, mb, seq, d] (the
        embedded microbatches, replica-major) -> the last stages' outputs,
        same shape, on the last stage's device. Every tensor a stage
        stream reads or writes stays referenced until the streams have
        joined the caller's stream, so the allocator reuses none of them
        under a stream still working on it."""
        S, R, M = self.n_stages, self.n_replicas, self.microbatches
        devs = self.mesh.devices
        out = torch.empty(xg.shape, dtype=xg.dtype, device=devs[0][-1])
        if self.streams is not None:
            for r in range(R):
                for s in range(S):
                    self.streams[r][s].wait_stream(
                        torch.cuda.current_stream(devs[r][s]))
        hops = CollectiveStats()
        keep, ready, bufs = [], {}, {}
        for t in range(M + S - 1):  # fill / steady / drain
            for r in range(R):
                for s in range(S):
                    m = t - s
                    if not 0 <= m < M:
                        continue
                    with self._at(r, s):
                        if s == 0:
                            x = xg[r * M + m].to(devs[r][s])
                        else:
                            y, ev = ready.pop((r, s - 1, m))
                            if ev is not None:
                                torch.cuda.current_stream().wait_event(ev)
                            x = bufs[r, s] = self._hop(
                                y, bufs.get((r, s)), devs[r][s], hops)
                        y = self._stage_fn(self.trunk[r][s], self._paths[s],
                                           x)
                        keep.append(y)
                        if s == S - 1:
                            out[r * M + m].copy_(y)
                            continue
                        ev = None
                        if self.streams is not None:
                            ev = torch.cuda.Event()
                            ev.record()
                        ready[r, s, m] = (y, ev)
        if self.streams is not None:
            for r in range(R):
                for s in range(S):
                    torch.cuda.current_stream(devs[0][-1]).wait_stream(
                        self.streams[r][s])
        self._step_hops = hops
        return out

    def _run_trunk(self, xg: torch.Tensor) -> torch.Tensor:
        """The step on ``xg``: eager, or the captured graph for its shape
        (captured at its first use)."""
        if self.graphs is None:
            return self._trunk_step(xg)
        from repro_torch.serving.graphs import StepGraph

        key = (tuple(xg.shape), xg.dtype)
        if key not in self.graphs:
            g = StepGraph(self._trunk_step, xg.clone(), obs=self.obs)
            g.capture()
            self.graphs[key] = (g, self._step_hops)
        g, hops = self.graphs[key]
        g.static_in.copy_(xg)
        out = g()
        self._step_hops = hops
        return out

    def _embed_grid(self, batch: dict) -> torch.Tensor:
        dev = self.mesh.devices[0][0]
        x = self._embed(self.front, {k: v.to(dev) for k, v in batch.items()})
        g = self.n_replicas * self.microbatches
        return x.reshape(g, self.mb_size, *x.shape[1:])

    @torch.no_grad()
    def forward_raw(self, batch: dict) -> torch.Tensor:
        """Exactly ``capacity`` rows -> outputs for every row."""
        buf = self._run_trunk(self._embed_grid(batch))
        return self._head(self.back, buf.reshape(self.capacity,
                                                 *buf.shape[2:]))

    def forward(self, batch: dict) -> torch.Tensor:
        """Any 1..capacity rows: pads the ragged final microbatch (row
        repeats), runs one pipeline step, slices the real rows back."""
        n = _rows(batch)
        if not 1 <= n <= self.capacity:
            raise ValueError(f"batch of {n} rows exceeds pipeline capacity "
                             f"{self.capacity}")
        return self.forward_raw(_pad_rows(batch, self.capacity))[:n]

    def timed_forward(self, batch: dict):
        _sync(self.mesh.devices)
        t0 = time.perf_counter()
        out = self.forward(batch)
        _sync(self.mesh.devices)
        return out, time.perf_counter() - t0

    # ------------------------------------------------------ transfer guard

    def collectives(self, batch: dict) -> CollectiveStats:
        """Run one step on ``batch`` and return its hops' CollectiveStats.
        The FWS invariant: only ``collective-permute`` (the activation
        hop), activation-sized, far below :attr:`trunk_bytes`."""
        self.forward(batch)
        hops = self._step_hops
        return CollectiveStats(wire_bytes=hops.wire_bytes,
                               by_kind={k: list(v)
                                        for k, v in hops.by_kind.items()},
                               count=hops.count)

    def trunk_resident(self) -> bool:
        """Every trunk tensor is on its grid place's device at the address
        it was given at construction (nothing re-placed it)."""
        for r, row in enumerate(self.trunk):
            for s, stage in enumerate(row):
                dev = self.mesh.devices[r][s]
                ts = list(_tensors(stage))
                if [t.data_ptr() for t in ts] != self._ptrs[r][s] or any(
                        t.device != dev for t in ts):
                    return False
        return True

    # -------------------------------------------------------- measurement

    @torch.no_grad()
    def measure_stage_walls(self, batch: dict, reps: int = 3) -> list:
        """Wall time of one microbatch through each stage in isolation,
        chaining each stage's true input activations; on one card each
        stage is captured alone first (the reference jits each stage)."""
        from repro_torch.serving.graphs import StepGraph

        x = self._embed_grid(_pad_rows(batch, self.capacity))[0]
        walls = []
        for i in range(self.n_stages):
            x = x.to(self.mesh.devices[0][i])
            fn = functools.partial(self._stage_fn, self.trunk[0][i],
                                   self._paths[i])
            if self.graphs is not None:
                call = StepGraph(fn, x.clone(), obs=self.obs)
                call.capture()
            else:
                call = functools.partial(fn, x)
                call()  # warm
            best = float("inf")
            for _ in range(reps):
                _sync(self.mesh.devices)
                t0 = time.perf_counter()
                y = call()
                _sync(self.mesh.devices)
                best = min(best, time.perf_counter() - t0)
            walls.append(best)
            x = y.clone()
        return walls

    @torch.no_grad()
    def measure_step_wall(self, batch: dict, reps: int = 3) -> float:
        """Min wall of the step alone (embed, head and the host-side pad
        and slice excluded): the T-slot GPipe schedule that the
        ``serving.pipeline`` model predicts."""
        xg = self._embed_grid(_pad_rows(batch, self.capacity))
        self._run_trunk(xg)
        best = float("inf")
        for _ in range(reps):
            _sync(self.mesh.devices)
            t0 = time.perf_counter()
            self._run_trunk(xg)
            _sync(self.mesh.devices)
            best = min(best, time.perf_counter() - t0)
        return best

    def measure(self, batch: dict, reps: int = 3) -> MeasuredReport:
        """Measured pipeline health for one representative batch: forward
        wall (min over ``reps``), isolated stage walls, and the occupancy,
        bubble and fill figures they imply (the reference's formulas)."""
        self.forward(batch)  # warm (and capture)
        best = min(self.timed_forward(batch)[1] for _ in range(reps))
        stage_walls = self.measure_stage_walls(batch, reps=reps)
        t_stage = max(stage_walls)
        m = self.microbatches
        occ = [min(1.0, m * w / best) for w in stage_walls] if best else []
        bubble = max(0.0, 1.0 - sum(occ) / len(occ)) if occ else 0.0
        rep = MeasuredReport(
            name=self.name, n_stages=self.n_stages,
            n_replicas=self.n_replicas, microbatches=m,
            mb_size=self.mb_size, step_wall_s=best,
            stage_walls_s=tuple(stage_walls),
            throughput_items_per_s=self.capacity / best if best else 0.0,
            steady_items_per_s=(self.n_replicas * self.mb_size / t_stage
                                if t_stage else 0.0),
            bubble_fraction=bubble, fill_latency_s=sum(stage_walls))
        self._last_report = rep
        return rep

    def publish(self, registry, prefix: str = "pipeline_measured") -> None:
        if self._last_report is None:
            raise ValueError("call measure() before publish()")
        self._last_report.publish(registry, prefix=prefix)


class ReplicaRouter:
    """Round-robin front door over the pipeline's replicas: each submitted
    batch claims the next replica slot (at most ``microbatches *
    mb_size`` rows); :meth:`flush` packs full replica groups into single
    pipeline steps and returns each ticket's output rows."""

    def __init__(self, runner: StagePipeline):
        self.runner = runner
        self._pending: list = []  # (ticket, batch, n_rows)
        self._next_ticket = 0
        self.dispatched = [0] * runner.n_replicas  # batches per replica

    @property
    def slot_rows(self) -> int:
        return self.runner.microbatches * self.runner.mb_size

    def submit(self, batch: dict) -> int:
        n = _rows(batch)
        if not 1 <= n <= self.slot_rows:
            raise ValueError(f"batch of {n} rows exceeds replica slot "
                             f"({self.slot_rows})")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, batch, n))
        return ticket

    def flush(self) -> dict:
        """Run all pending batches; returns {ticket: output rows}."""
        out: dict = {}
        r = self.runner.n_replicas
        pending, self._pending = self._pending, []
        for g0 in range(0, len(pending), r):
            group = pending[g0:g0 + r]
            slots = [_pad_rows(b, self.slot_rows) for _, b, _ in group]
            while len(slots) < r:  # idle replicas replay slot 0
                slots.append(slots[0])
            packed = {k: torch.cat([s[k] for s in slots]) for k in slots[0]}
            ys = self.runner.forward_raw(packed)
            for si, (ticket, _, n) in enumerate(group):
                out[ticket] = ys[si * self.slot_rows:si * self.slot_rows + n]
                self.dispatched[si] += 1
        return out


# ---------------------------------------------------------------- builders

def _resolve_bounds(cfg, stages: int, mode: str, costs, seq_len: int):
    if mode == "balanced" and costs is None:
        costs = blockwise.serve_layer_costs(cfg, seq_len)
    return stage_partition(cfg.n_layers, stages, mode=mode, costs=costs)


def _stage(cfg, ctx: RunCtx, seg: lm.Segment, layers: list, paths: list,
           x: torch.Tensor) -> torch.Tensor:
    """One stage: ``layers`` over the microbatch ``x`` at positions [0,
    seq) on every row, as ``lm.forward`` / ``vit.encode`` run them."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    y, _ = lm.run_segment(ctx, cfg, seg, layers, x, positions,
                          path="segments/0", paths=paths)
    return y


def _lm_embed(ctx, cfg, front, batch):
    return lm.embed_inputs(ctx, cfg, front, batch)


def _lm_head(ctx, cfg, back, x):
    return lm._head(ctx, cfg, back, norm_apply(cfg.norm, back["final_ln"], x))


def _finish(cfg, ctx, seg, *, mesh, stages, replicas, bounds, trunk, front,
            back, embed_fn, head_fn, microbatches, mb_size, name,
            stage_ctx, cuda_graphs):
    return StagePipeline(
        mesh=mesh or make_pipeline_mesh(stages, replicas), bounds=bounds,
        trunk=trunk, front=front, back=back, embed_fn=embed_fn,
        stage_fn=functools.partial(_stage, cfg, stage_ctx, seg),
        head_fn=head_fn, microbatches=microbatches, mb_size=mb_size,
        name=name, cuda_graphs=cuda_graphs, obs=ctx.obs)


def build_lm_pipeline(params, cfg, ctx: RunCtx, *, stages: int,
                      replicas: int = 1, microbatches: int = 2,
                      mb_size: int = 1, seq_len: int = 512,
                      mesh: PipelineMesh | None = None, mode: str = "equal",
                      costs=None, cuda_graphs: bool = True) -> StagePipeline:
    """Stage-parallel pipelined forward of a dense LM (the prefill /
    scoring path; decode stays on the engine). Float, packed-MXFP4 and
    CIM-converted trees alike; ``ctx`` picks the backend as for
    ``lm.forward``. ``mesh`` defaults to one CUDA device a grid place."""
    segs = lm.build_segments(cfg)
    if len(segs) != 1 or segs[0].kind != "attn":
        raise NotImplementedError(
            "stage-parallel pipeline needs a single homogeneous attention "
            f"trunk; {cfg.name} has segments "
            f"{[(s.kind, s.n) for s in segs]}")
    front = {"embed": params["embed"]}
    back = {"final_ln": params["final_ln"]}
    if cfg.tie_embeddings:
        back["embed"] = params["embed"]
    else:
        back["lm_head"] = params["lm_head"]
    return _finish(
        cfg, ctx, segs[0], mesh=mesh, stages=stages, replicas=replicas,
        bounds=_resolve_bounds(cfg, stages, mode, costs, seq_len),
        trunk=params["segments"][0], front=front, back=back,
        embed_fn=functools.partial(_lm_embed, ctx, cfg),
        head_fn=functools.partial(_lm_head, ctx, cfg),
        microbatches=microbatches, mb_size=mb_size, name=cfg.name,
        stage_ctx=dataclasses.replace(ctx, arange_positions=True),
        cuda_graphs=cuda_graphs)


def _vit_embed(ctx, cfg, front, batch):
    from repro_torch.models import vit

    return vit.embed_images(ctx, cfg, front, batch["images"])


def _vit_head(ctx, cfg, back, x):
    from repro_torch.models import vit

    return vit.head(ctx, cfg, back, x)


def build_vit_pipeline(params, cfg, ctx: RunCtx, *, stages: int,
                       replicas: int = 1, microbatches: int = 2,
                       mb_size: int = 1, mesh: PipelineMesh | None = None,
                       mode: str = "equal", costs=None,
                       cuda_graphs: bool = True) -> StagePipeline:
    """Stage-parallel pipelined ViT forward: images in, class logits out;
    the executable form of the paper's multi-chip FWS deployment (vit-l32:
    24 blocks over two stages) that ``serving/vision.py``'s chip chain
    runs in sequence."""
    from repro_torch.models import vit

    front = {k: params[k] for k in ("patch", "cls", "pos")}
    back = {"final_ln": params["final_ln"], "head": params["head"]}
    return _finish(
        cfg, ctx, vit.build_segments(cfg)[0], mesh=mesh, stages=stages,
        replicas=replicas,
        bounds=_resolve_bounds(cfg, stages, mode, costs, cfg.seq_len),
        trunk=params["segments"][0], front=front, back=back,
        embed_fn=functools.partial(_vit_embed, ctx, cfg),
        head_fn=functools.partial(_vit_head, ctx, cfg),
        microbatches=microbatches, mb_size=mb_size, name=cfg.name,
        stage_ctx=ctx, cuda_graphs=cuda_graphs)
