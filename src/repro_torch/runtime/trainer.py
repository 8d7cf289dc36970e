"""Fault-tolerant training runtime (the reference's
``repro.runtime.trainer``), on one device or over the ranks of a mesh.

- Resume from the latest checkpoint, with the data keyed by step, so a
  killed and restarted run equals an uninterrupted one.
- Async checkpoints every ``ckpt_every`` steps (atomic commit,
  keep-last-k) and a final blocking save.
- Preemption: SIGTERM sets a flag; the loop stops after the step in
  flight and saves.
- Straggler monitor: per-step wall times; a step slower than
  ``straggler_factor`` times the running median is logged as an event.
- Restore onto any device or mesh: the checkpoint holds global host
  arrays (``checkpoint.ckpt``).
- Sharded (a bundle of ``launch.steps.make_train_step`` on a mesh over a
  process group, with or without a model axis): every rank runs the step
  on its blocks and its data rank's rows of each batch, restores its
  blocks, and takes part in each save; rank 0
  writes the checkpoints and the log; a SIGTERM on any rank stops every
  rank after the same step (one all-reduce of the flag a step).
"""

from __future__ import annotations

import dataclasses
import json
import signal
import statistics
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import Shape
from repro_torch.data.pipeline import Pipeline
from repro_torch.distributed.collectives import MeshComm
from repro_torch.distributed.mesh import data_rank, data_size
from repro_torch.layers.common import RunCtx
from repro_torch.models import lm
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "repro_ckpt"
    keep: int = 3
    straggler_factor: float = 3.0
    log_path: str | None = None
    seed: int = 0


class HeartbeatMonitor:
    def __init__(self, factor: float):
        self.factor = factor
        self.times: list[float] = []
        self.slow_steps: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> None:
        if len(self.times) >= 5:
            med = statistics.median(self.times[-50:])
            if dt > self.factor * med:
                self.slow_steps.append((step, dt))
        self.times.append(dt)


def loss_and_grads(params, cfg, ctx: RunCtx, batch: dict,
                   count: torch.Tensor | None = None):
    """(loss, gradients as a list in ``adamw.leaves`` order) of
    ``lm.lm_loss`` at ``params`` (normalised by ``count`` where given);
    a leaf the loss does not read gets a zero gradient, as under
    ``jax.value_and_grad``. Tensors that do not require grad are made to;
    one computed from a parameter (the step-boundary quantization of
    ``launch.steps``) keeps its graph, and the gradient stops at it."""
    flat = adamw.leaves(params)
    with torch.enable_grad():
        for p in flat:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = lm.lm_loss(params, cfg, ctx, batch, count=count)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, gs)]


class Trainer:
    """Trains ``cfg`` on the synthetic stream of ``shape``. ``step_fn``
    (params, opt_state, batch) -> (params, opt_state, metrics) defaults to
    ``lm_loss`` under ``ctx`` (default: the reference's, ``quant="none"``
    with ``dense_attn_max=256``) and :func:`adamw.apply`. ``params``
    default to ``lm.init_model`` from ``tcfg.seed`` on ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``); converted
    reference params may be passed instead. A checkpoint in
    ``tcfg.ckpt_dir`` wins over both.

    ``bundle`` (a ``launch.steps.StepBundle`` of the train step) gives
    the step function, parameters and moments; on a mesh over a process
    group they are this rank's blocks, and the trainer runs sharded (the
    module's docstring)."""

    def __init__(self, cfg, shape: Shape, tcfg: TrainerConfig, step_fn=None,
                 params=None, opt_state=None,
                 opt_cfg: adamw.AdamWConfig | None = None, ctx=None,
                 device=None, bundle=None):
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        self.mesh = self.shardings = None
        self.microbatches = 1
        if bundle is not None:
            step_fn, (params, opt_state) = bundle.fn, bundle.args[:2]
            self.microbatches = bundle.microbatches
            if bundle.mesh is not None and bundle.mesh.distributed:
                self.mesh = bundle.mesh
                self.shardings = {"params": bundle.shardings[0],
                                  "opt": bundle.shardings[1]}
                self._comm = MeshComm(self.mesh)
            device = adamw.leaves(params)[0].device
        self.rank = self.mesh.rank if self.mesh is not None else 0
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.monitor = HeartbeatMonitor(tcfg.straggler_factor)
        self._preempted = False
        self.ctx = ctx or RunCtx(quant="none", dense_attn_max=256)
        if step_fn is None:
            def step_fn(params, opt_state, batch):
                loss, grads = loss_and_grads(params, self.cfg, self.ctx,
                                             batch)
                grads = iter(grads)
                params, opt_state, met = adamw.apply(
                    self.opt_cfg, params,
                    adamw.tree_map(params, lambda _: next(grads)),
                    opt_state, lm.ref_ndim_tree(self.cfg, params))
                met["loss"] = loss
                return params, opt_state, met
        self.step_fn = step_fn

        if params is None:
            gen = torch.Generator(self.device).manual_seed(tcfg.seed)
            params = lm.init_model(cfg, gen)
        if opt_state is None:
            opt_state = adamw.init(params)
        self.params, self.opt_state = params, opt_state
        self.start_step = 0

        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(
                latest, {"params": self.params, "opt": self.opt_state},
                shardings=self.shardings, mesh=self.mesh)
            self.params, self.opt_state = state["params"], state["opt"]
            self.start_step = latest
        self.metrics_log: list[dict] = []

    def _handle_preempt(self, *_):
        self._preempted = True

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def _save(self, step: int, blocking: bool = False) -> None:
        self.ckpt.save(step, self._state(), blocking=blocking,
                       shardings=self.shardings, mesh=self.mesh)

    def _stop(self) -> bool:
        """Preempted here or, when sharded, on any rank."""
        if self.mesh is None:
            return self._preempted
        flag = torch.tensor([float(self._preempted)], device=self.device)
        self._comm.all_reduce(flag)
        return bool(flag.item() > 0)

    def run(self) -> dict:
        old_term = signal.signal(signal.SIGTERM, self._handle_preempt)
        ranks = data_size(self.mesh) if self.mesh is not None else 1
        pipe = Pipeline(self.cfg, self.shape, self.tcfg.seed,
                        start_step=self.start_step, device=self.device,
                        rank=data_rank(self.mesh) if ranks > 1 else 0,
                        ranks=ranks, microbatches=self.microbatches)
        step = self.start_step
        try:
            while step < self.tcfg.total_steps and not self._stop():
                got_step, batch = pipe.get()
                if got_step != step:
                    raise RuntimeError(f"data for step {got_step} at step "
                                       f"{step}")
                t0 = time.time()
                self.params, self.opt_state, met = self.step_fn(
                    self.params, self.opt_state, batch)
                met = {k: float(v) for k, v in met.items()}
                dt = time.time() - t0
                self.monitor.record(step, dt)
                step += 1
                met.update(step=step, wall_s=dt)
                self.metrics_log.append(met)
                if self.tcfg.log_path and self.rank == 0:
                    with open(self.tcfg.log_path, "a") as f:
                        f.write(json.dumps(met) + "\n")
                if step % self.tcfg.ckpt_every == 0:
                    self.ckpt.wait()
                    self._save(step)
            # final / preemption save
            self.ckpt.wait()
            self._save(step, blocking=True)
        finally:
            pipe.close()
            signal.signal(signal.SIGTERM, old_term)
        preempted = self._preempted or (step < self.tcfg.total_steps)
        return {"final_step": step, "preempted": preempted,
                "slow_steps": self.monitor.slow_steps,
                "losses": [m["loss"] for m in self.metrics_log]}
