"""Step builders: train, prefill and decode, with the sharding of their
arguments resolved from the logical-axis rules (counterpart of the
reference's ``repro.launch.steps``). Shared by the training launcher, the
dry-run and ``chip_smoke.py``.

Each builder returns a :class:`StepBundle`: the step function, its
arguments built on ``device`` (default ``cuda``; ``meta`` for the
dry-run, shapes and dtypes only; ``cpu`` in tests; never the CPU on its
own), the run context and the arguments' resolved specs on ``mesh``
(``launch.mesh``). The step runs on one device, where its arguments are:
the reference's GSPMD partitioning of it over the mesh is what the specs
describe and the dry-run counts, not what runs (``ROADMAP.md``).

Under ``quant="mxfp4_ste"`` the train step runs the
``mxfp4_ste_prequant`` backend: the weights are fake-quantized once a
step, at its boundary (``layers.common.quantize_weights_tree``, exact:
they are constant within the step), and the gradients come back through
that quantization as ``jax.vjp(quantize_weights_tree)`` gives them in the
reference: the STE's identity, cast to the f32 parameters. Gradients
accumulate in f32 over ``k`` microbatches and are divided by ``k``; then
``optim.adamw.apply`` updates the parameters in place. The prefill and
decode steps keep the reference's bodies: cache init, ``lm.forward`` /
``lm.decode_step``, the head, argmax.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import configs as C
from repro_torch import resolve_device
from repro_torch.configs import Shape
from repro_torch.distributed import sharding as shd
from repro_torch.layers.backends import _dequant_packed
from repro_torch.layers.common import (
    RunCtx,
    convert_params_mxfp4,
    convert_specs_mxfp4,
    quantize_weights_tree,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import loss_and_grads


@dataclasses.dataclass(frozen=True)
class StepBundle:
    fn: Callable  # the step: fn(*args)
    ctx: RunCtx
    args: tuple = ()  # the step's arguments on the bundle's device
    shardings: tuple = ()  # the args' resolved specs on the mesh
    microbatches: int = 1


def _device(device) -> torch.device:
    """``device``, default ``cuda`` (raising without it); ``meta`` as is."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def param_structs(cfg, serve_quant: bool = False, device="meta"):
    """(parameters, their logical specs): ``lm.init_model``'s tree on
    ``device`` (``meta``: no allocation, the reference's
    ``ShapeDtypeStruct`` tree), random from seed 0 elsewhere; with
    ``serve_quant`` converted to packed MXFP4 (``mxfp4_wonly``)."""
    dev = _device(device)
    gen = torch.Generator("cpu" if dev.type == "meta" else dev)
    params = lm.init_model(cfg, gen.manual_seed(0), device=dev)
    specs = lm.param_specs(cfg)
    if serve_quant:
        specs = convert_specs_mxfp4(specs, params)
        params = convert_params_mxfp4(params, free=True)
    return params, specs


def _inputs(cfg, shape: Shape, device) -> dict:
    """The step's inputs: ``configs.input_specs`` on ``meta``, else
    ``configs.concrete_inputs`` (seed 0)."""
    if device.type == "meta":
        return C.input_specs(cfg, shape)
    return C.concrete_inputs(cfg, shape, device=device)


_BATCH_AXES = {
    "ids": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "emb": ("batch", "seq", "embed"),
    "vis_emb": ("batch", "seq", "embed"),
    "positions": ("batch", "seq"),
    "pos": (),
}


def batch_shardings(batch: dict, mesh, ctx: shd.ShardingCtx) -> dict:
    """Each input's resolved spec (batch over the data axes where it
    divides)."""
    return shd.resolve_with_divisibility(
        {k: _BATCH_AXES[k][: v.ndim] for k, v in batch.items()}, batch, ctx,
        mesh)


def _data_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def pick_microbatches(mesh, shape: Shape | None = None,
                      target_tokens: int = 8192) -> int:
    """Gradient-accumulation factor: halve the global batch's microbatch
    until its tokens per data-parallel device are at most
    ``target_tokens`` (activation memory) or it cannot be halved evenly
    over the mesh's data axes. ``pick_microbatches(shape)`` is the
    one-device form."""
    if isinstance(mesh, Shape):  # pick_microbatches(shape): one device
        mesh, shape = None, mesh
    dsz = _data_size(mesh) if mesh is not None else 1
    k = 1
    while (shape.seq * shape.batch // (dsz * k) > target_tokens
           and (shape.batch // (2 * k)) % dsz == 0
           and shape.batch // (2 * k) >= dsz):
        k *= 2
    return k


def param_rules(rules: dict, mesh, fsdp: bool = True) -> dict:
    """Parameter *storage* rules: FSDP shards the (usually replicated)
    ``embed`` axis of every weight over the data axes."""
    r = dict(rules)
    if fsdp:
        r["embed"] = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return r


def _split(batch: dict, k: int) -> list[dict]:
    """k microbatches of ``batch`` along its leading axis, in order."""
    return [{name: t.reshape((k, t.shape[0] // k) + t.shape[1:])[i]
             for name, t in batch.items()} for i in range(k)]


def _train_fn(cfg, ctx: RunCtx, k: int, prequant: bool,
              opt_cfg: adamw.AdamWConfig) -> Callable:
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

    return train_step


def make_train_step(cfg, mesh, shape: Shape | None = None,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    quant: str = "mxfp4_ste", zero1: bool = True,
                    fsdp: bool = True, microbatches: int | None = None,
                    device=None, dense_attn_max: int = 2048) -> StepBundle:
    """The train step ``fn(params, opt_state, batch) -> (params,
    opt_state, metrics)`` for ``cfg`` at ``shape``. With a ``mesh`` the
    bundle holds the arguments on ``device`` and their specs (FSDP
    parameters, ZeRO-1 moments). ``make_train_step(cfg, shape, opt_cfg,
    ...)`` is the one-device form: no arguments are built, and
    ``device`` only checks that it is there. ``microbatches`` defaults to
    :func:`pick_microbatches`; ``dense_attn_max`` is the run context's
    (past it a prefill takes the online-softmax ``_flash_attn``, which is
    differentiable)."""
    if isinstance(mesh, Shape):  # (cfg, shape, opt_cfg): one device
        mesh, shape, opt_cfg = None, mesh, shape or opt_cfg
    dev = _device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    prequant = quant == "mxfp4_ste"
    if prequant:
        quant = "mxfp4_ste_prequant"
    ctx = RunCtx(quant=quant, dense_attn_max=dense_attn_max)
    k = microbatches or pick_microbatches(mesh, shape)
    if shape.batch % k:
        raise ValueError(f"batch {shape.batch} does not split into {k} "
                         "microbatches")
    fn = _train_fn(cfg, ctx, k, prequant, opt_cfg)
    if mesh is None:
        return StepBundle(fn=fn, ctx=ctx, microbatches=k)
    rules = shd.zero_rules(shd.make_rules(cfg, mesh, "train"), mesh,
                           enabled=zero1)
    sctx = shd.ShardingCtx(mesh=mesh, rules=rules)
    pctx = shd.ShardingCtx(mesh=mesh, rules=param_rules(rules, mesh, fsdp))
    params, specs = param_structs(cfg, device=dev)
    opt_state = adamw.init(params)
    batch = _inputs(cfg, shape, dev)
    p_shard = shd.resolve_with_divisibility(specs, params, pctx, mesh)
    m_shard = shd.resolve_with_divisibility(
        shd.opt_state_specs(specs, cfg, mesh, zero1=zero1), params, pctx,
        mesh)
    o_shard = adamw.OptState(step=(), m=m_shard, v=m_shard)
    return StepBundle(fn=fn, ctx=ctx, args=(params, opt_state, batch),
                      shardings=(p_shard, o_shard,
                                 batch_shardings(batch, mesh, sctx)),
                      microbatches=k)


def _head_logits(cfg, params, last_hidden):
    """The head on the last position (the reference's ``_head_logits``): a
    packed head dequantized and multiplied in bf16, not through the
    kernel, as the reference computes it."""
    if cfg.tie_embeddings:
        return torch.matmul(last_hidden,
                            params["embed"]["emb"].to(torch.bfloat16).T)
    hp = params["lm_head"]
    if "e_n" in hp:
        raise ValueError(
            "lm_head is cim_analog-converted; compute logits through "
            "models.lm.forward / linear_apply (backend-dispatched), not "
            "_head_logits")
    if "codes" in hp:
        return torch.matmul(last_hidden.to(torch.bfloat16),
                            _dequant_packed(hp["codes"], hp["exps"]))
    return torch.matmul(last_hidden, hp["w"].to(torch.bfloat16))


def _serve_params(cfg, mesh, quant: str, shd_ctx, device):
    params, specs = param_structs(cfg, serve_quant=quant == "mxfp4_wonly",
                                  device=device)
    return params, shd.resolve_with_divisibility(specs, params, shd_ctx,
                                                 mesh)


def make_prefill_step(cfg, mesh: Mesh, shape: Shape,
                      quant: str = "mxfp4_wonly", with_cache: bool = True,
                      device=None) -> StepBundle:
    """``fn(params, batch) -> (next ids [B], caches)``: a prefill of
    ``shape`` into fresh legacy caches (none for an encoder-only arch or
    without ``with_cache``), the head on the last position, argmax."""
    dev = _device(device)
    ctx = RunCtx(quant=quant)
    sctx = shd.make_ctx(cfg, mesh, "prefill")
    params, p_shard = _serve_params(cfg, mesh, quant, sctx, dev)
    batch = _inputs(cfg, shape, dev)
    with_c = with_cache and cfg.supports_decode

    @torch.no_grad()
    def prefill_step(params, batch):
        bdev = next(iter(batch.values())).device
        caches = (lm.init_cache(cfg, shape.batch, shape.seq, device=bdev)
                  if with_c else None)
        hidden, caches = lm.forward(params, cfg, ctx, batch, caches=caches,
                                    return_hidden=True)
        logits = _head_logits(cfg, params, hidden[:, -1])
        ids = torch.argmax(logits.to(torch.float32), dim=-1)
        return (ids, caches) if with_c else (ids, ())

    return StepBundle(fn=prefill_step, ctx=ctx, args=(params, batch),
                      shardings=(p_shard, batch_shardings(batch, mesh, sctx)))


def _cache_spec_tree(cfg) -> list:
    """Logical axes of every leaf of ``lm.init_cache``'s tree (one dict a
    layer; the reference's ``cache_specs`` without its ``layers`` axis)."""
    return [[dict(s) for _ in range(seg.n)]
            for s, seg in zip(lm.cache_specs(cfg), lm.build_segments(cfg))]


def make_decode_step(cfg, mesh: Mesh, shape: Shape,
                     quant: str = "mxfp4_wonly", device=None) -> StepBundle:
    """``fn(params, caches, ids, pos) -> (next ids int32 [B], caches)``:
    one decode step of ``shape.batch`` lanes over legacy caches of
    ``shape.seq`` (the bundle's ``pos`` is the last slot, so every slot
    is live)."""
    dev = _device(device)
    ctx = RunCtx(quant=quant)
    sctx = shd.make_ctx(cfg, mesh, "decode", batch_size=shape.batch)
    params, p_shard = _serve_params(cfg, mesh, quant, sctx, dev)
    caches = lm.init_cache(cfg, shape.batch, shape.seq, device=dev)
    c_shard = shd.resolve_with_divisibility(_cache_spec_tree(cfg), caches,
                                            sctx, mesh)
    inp = _inputs(cfg, shape, dev)
    if dev.type != "meta":
        inp["pos"].fill_(shape.seq - 1)
    ids_shard = shd.resolve_with_divisibility(("batch", "seq"), inp["ids"],
                                              sctx, mesh)

    @torch.no_grad()
    def serve_step(params, caches, ids, pos):
        logits, new_caches = lm.decode_step(params, cfg, ctx, ids, pos,
                                            caches)
        next_ids = torch.argmax(logits.to(torch.float32), dim=-1)
        return next_ids.to(torch.int32), new_caches

    return StepBundle(fn=serve_step, ctx=ctx,
                      args=(params, caches, inp["ids"], inp["pos"]),
                      shardings=(p_shard, c_shard, ids_shard, ()))


def make_step(cfg, mesh: Mesh, shape: Shape, **kw) -> StepBundle:
    if shape.kind == "train":
        return make_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape, **kw)
    return make_decode_step(cfg, mesh, shape, **kw)


def args_bytes(args, shardings, mesh) -> int:
    """Per-device bytes of a step's arguments under their resolved specs:
    each leaf's shard (``sharding.shard_shape``) at its element size."""
    if torch.is_tensor(args):
        n = 1
        for d in shd.shard_shape(shardings, args.shape, mesh):
            n *= d
        return n * args.element_size()
    if isinstance(args, dict):
        return sum(args_bytes(args[k], shardings[k], mesh) for k in args)
    return sum(args_bytes(a, s, mesh) for a, s in zip(args, shardings))
