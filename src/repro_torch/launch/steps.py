"""The one-device train step (the reference's ``repro.launch.steps``
``pick_microbatches`` and ``make_train_step``).

Under ``quant="mxfp4_ste"`` the step runs the ``mxfp4_ste_prequant``
backend: the weights are fake-quantized once a step, at its boundary
(``layers.common.quantize_weights_tree``, exact: they are constant within
the step), and the gradients come back through that quantization as
``jax.vjp(quantize_weights_tree)`` gives them in the reference: the STE's
identity, cast to the f32 parameters. Gradients accumulate in f32 over
``k`` microbatches and are divided by ``k``; then ``optim.adamw.apply``
updates the parameters in place.

The reference's ``zero1`` / ``fsdp`` shardings and its serving step
constructors (``make_prefill_step``, ``make_decode_step``,
``make_paged_decode_step``) are GSPMD / jit constructions for its pod
meshes; the port serves through ``serving.Engine`` and trains on one
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs import Shape
from repro_torch.layers.common import RunCtx, quantize_weights_tree
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import loss_and_grads


@dataclasses.dataclass(frozen=True)
class StepBundle:
    fn: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    ctx: RunCtx
    microbatches: int


def pick_microbatches(shape: Shape, target_tokens: int = 8192,
                      data_size: int = 1) -> int:
    """Gradient-accumulation factor: halve the microbatch until its tokens
    per device are at most ``target_tokens`` (activation memory) or it
    cannot be halved evenly over the ``data_size`` data-parallel devices
    (one here)."""
    k = 1
    while (shape.seq * shape.batch // (data_size * k) > target_tokens
           and (shape.batch // (2 * k)) % data_size == 0
           and shape.batch // (2 * k) >= data_size):
        k *= 2
    return k


def _split(batch: dict, k: int) -> list[dict]:
    """k microbatches of ``batch`` along its leading axis, in order."""
    return [{name: t.reshape((k, t.shape[0] // k) + t.shape[1:])[i]
             for name, t in batch.items()} for i in range(k)]


def make_train_step(cfg, shape: Shape,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    quant: str = "mxfp4_ste", microbatches: int | None = None,
                    device=None, dense_attn_max: int = 2048) -> StepBundle:
    """The train step for ``cfg`` at ``shape`` on one device (default
    ``cuda``; ``device`` only checks that it is there: the step runs where
    its tensors are). ``microbatches`` defaults to
    :func:`pick_microbatches`; ``dense_attn_max`` is the run context's
    (past it a prefill takes the online-softmax ``_flash_attn``, which is
    differentiable)."""
    resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    prequant = quant == "mxfp4_ste"
    if prequant:
        quant = "mxfp4_ste_prequant"
    ctx = RunCtx(quant=quant, dense_attn_max=dense_attn_max)
    k = microbatches or pick_microbatches(shape)
    if shape.batch % k:
        raise ValueError(f"batch {shape.batch} does not split into {k} "
                         "microbatches")

    def train_step(params, opt_state, batch):
        ndims = lm.ref_ndim_tree(cfg, params)
        flat = adamw.leaves(params)
        with torch.enable_grad():
            for p in flat:
                p.requires_grad_(True)
            cparams = (quantize_weights_tree(params, ndims) if prequant
                       else params)
            cflat = adamw.leaves(cparams)
            if k == 1:
                loss, grads = loss_and_grads(cparams, cfg, ctx, batch)
            else:
                acc = [torch.zeros(c.shape, dtype=torch.float32,
                                   device=c.device) for c in cflat]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=flat[0].device)
                for mb in _split(batch, k):
                    lm_b, gs = loss_and_grads(cparams, cfg, ctx, mb)
                    for a, g in zip(acc, gs):
                        a.add_(g.to(torch.float32))
                    loss = loss + lm_b
                grads = [a / k for a in acc]
                loss = loss / k
            # back through the step-boundary quant: the STE's identity
            grads = [g.to(c.dtype) for g, c in zip(grads, cflat)]
            if prequant:
                grads = torch.autograd.grad(cflat, flat, grad_outputs=grads)
        del cparams, cflat
        grads = iter(grads)
        params, opt_state, metrics = adamw.apply(
            opt_cfg, params, adamw.tree_map(params, lambda _: next(grads)),
            opt_state, ndims)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return StepBundle(fn=train_step, ctx=ctx, microbatches=k)

