"""Step builders: train, prefill, decode and paged decode, with the
sharding of their arguments resolved from the logical-axis rules
(counterpart of the reference's ``repro.launch.steps``). Shared by the
training launcher, the dry-run and ``chip_smoke.py``.

Each builder returns a :class:`StepBundle`: the step function, its
arguments built on ``device`` (default ``cuda``; ``meta`` for the
dry-run, shapes and dtypes only; ``cpu`` in tests; never the CPU on its
own), the run context and the arguments' resolved specs on ``mesh``
(``launch.mesh``): the reference's GSPMD partitioning, which the dry-run
counts. On a mesh without a process group every step runs on one
device, where its arguments are; on a mesh over a group each runs
sharded (below).

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

On a mesh over a process group (``make_local_mesh`` inside an
initialised ``torch.distributed`` group, one rank a device) the train
step runs sharded, the reference's one GSPMD program written out: the
same body (:func:`_train_fn`) over the collectives of
``distributed/collectives.py`` instead of their one-device identities.
On the data axes each rank holds its blocks of the f32 parameters
(FSDP: ``embed`` over the data axes) and of the moments (ZeRO-1) and
its rows of each microbatch (``data.pipeline.rank_rows``); a step
all-gathers the parameters over the data axes at its boundary,
normalises each microbatch's loss by that microbatch's global mask
count, reduce-scatters the f32 gradients into the moments' layout,
all-reduces the loss and runs AdamW on the blocks. On a model axis
larger than 1 the gather gives each rank its model shard (``heads``,
``qkv_fused`` / ``kv_fused``, ``mlp`` and ``vocab`` over ``model``) and
the layers run tensor-parallel over the model subgroup (``RunCtx.tp``,
``distributed/tensor_parallel.py``): column-parallel ``wq`` / ``wk`` /
``wv`` / ``w1`` / ``w3`` and head, one f32 reduction after ``wo`` and
one after ``w2``, a vocab-parallel embedding and loss. Families
``dense`` and ``vlm`` only: ``moe``, ``hybrid``, ``ssm``, ``audio``, a
model axis that does not divide the query heads (the reference's
sequence-parallel ``kv_seq``) or a dim the rules then leave whole raise
``NotImplementedError`` (``ROADMAP.md``).

The serving steps run sharded over a group too, the reference's prefill
and decode GSPMD programs written out over the same ``MeshComm``: the
arguments are the rank's blocks under the resolved specs
(:func:`shard_params` cuts a caller's served tree, packed or calibrated
``cim``), the weights' model shards run column- and row-parallel under
``RunCtx.tp`` (the serving backends' row-parallel forms: kernel C's f32
partials, kernel A's integer pass sums) and the head's argmax is
combined over the model ranks (:func:`argmax_ids`). The prefill runs the
rank's heads and keeps its block of the caches' sequence; the decode
gathers q, k and v (heads are whole at decode) and combines the softmax
over the ranks that hold the sequence (``distributed/seq_parallel.py``);
the paged step decodes a lane on the data rank that holds its pool row.
:func:`check_serve_axis` raises on what the serving model axis does not
cover. With ``model_forms`` a serving builder runs the model axis's
forms at model 1 too (every model collective a copy): the row-parallel
linears' kernel modes on one card, where they must give the one-device
step bitwise (``chip_smoke.py``). On one device, and on a mesh without a
group, the steps are as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch import resolve_device
from repro_torch.configs import Shape
from repro_torch.data.pipeline import rank_rows
from repro_torch.distributed import seq_parallel as spl
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import LocalComm, MeshComm
from repro_torch.distributed.mesh import (
    Mesh,
    data_rank,
    data_size,
    model_size,
)
from repro_torch.distributed.roofline import CollectiveStats
from repro_torch.layers.attention import tp_heads
from repro_torch.layers import backends as backends_lib
from repro_torch.layers.backends import _dequant_packed
from repro_torch.layers.common import (
    RunCtx,
    convert_params_mxfp4,
    convert_specs_cim,
    convert_specs_mxfp4,
    quantize_weights_tree,
)
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import loss_and_grads
from repro_torch.serving.kvcache import gather_rows, scatter_rows


@dataclasses.dataclass(frozen=True)
class StepBundle:
    fn: Callable  # the step: fn(*args)
    ctx: RunCtx
    args: tuple = ()  # the step's arguments on the bundle's device
    shardings: tuple = ()  # the args' resolved specs on the mesh
    microbatches: int = 1
    mesh: Mesh | None = None
    # the sharded train step's collectives, summed over its calls, and
    # those of each mesh axis (data, model, world)
    collectives: CollectiveStats | None = None
    axis_collectives: dict | None = None


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




def pick_microbatches(mesh, shape: Shape | None = None,
                      target_tokens: int = 8192) -> int:
    """Gradient-accumulation factor: halve the global batch's microbatch
    until its tokens per data-parallel device are at most
    ``target_tokens`` (activation memory) or it cannot be halved evenly
    over the mesh's data axes. ``pick_microbatches(shape)`` is the
    one-device form."""
    if isinstance(mesh, Shape):  # pick_microbatches(shape): one device
        mesh, shape = None, mesh
    dsz = data_size(mesh) if mesh is not None else 1
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


def _like(tree, flat: list):
    """``flat`` (in ``adamw.leaves`` order) in ``tree``'s layout."""
    it = iter(flat)
    return adamw.tree_map(tree, lambda _: next(it))


def _split(batch: dict, k: int) -> list[dict]:
    """k microbatches of ``batch`` along its leading axis, in order."""
    return [{name: t.reshape((k, t.shape[0] // k) + t.shape[1:])[i]
             for name, t in batch.items()} for i in range(k)]


def _train_fn(cfg, ctx: RunCtx, k: int, prequant: bool,
              opt_cfg: adamw.AdamWConfig, comm=None, p_specs=None,
              m_specs=None, shapes=None) -> Callable:
    """The train step ``fn(params, opt_state, batch)``. On one device
    (``comm`` None: ``LocalComm``, every collective the identity) the
    arguments are whole; over a ``MeshComm`` they are the rank's blocks
    of the parameters (``p_specs``) and moments (``m_specs``) of global
    ``shapes``, and its rows of each microbatch. In order:

    1. Every f32 parameter is gathered over the data axes: whole, or on a
       model axis the rank's model shard, which ``ctx.tp``'s layers run
       on (the prequant makes a copy at the boundary anyway, and
       quantizes each shard as the whole would be: ``quantize_weights_
       tree`` under ``tp``).
    2. Each microbatch's mask count is summed over the data ranks (one
       all-reduce); each rank's loss of a microbatch's rows is normalised
       by it (``lm.lm_loss(count=)``), so the ranks' losses and gradients
       sum to those of the reference's one loss over all of its rows (a
       mean of per-rank means is wrong wherever the counts differ).
    3. The gradients are accumulated in f32 over the k microbatches
       (k = 1 keeps the one set), reduced over the data ranks into the
       moments' layout (a reduce-scatter in f32), divided by k and cast
       to each quantized leaf's dtype; autograd takes them back through
       the step-boundary quantization (the STE's identity, cast to f32).
       A leaf replicated over ``model`` has the same gradient on every
       model rank (the layers' collectives make it so): it is not summed
       over them. The loss is summed over the data ranks (the model ranks
       hold the same one) and divided by k.
    4. AdamW updates the blocks in the moments' layout, the clipping's
       norm summed over every rank (a block replicated over an axis
       counted on one: ``sharding.owns``). Where the parameters' layout
       differs (FSDP's ``embed`` over ``pod`` x ``data``, ZeRO-1's over
       ``data`` only) the updated blocks are gathered and the parameter
       block taken from them; on a local ``(data, model)`` mesh the two
       layouts are one."""
    comm = comm or LocalComm()

    def train_step(params, opt_state, batch):
        blocks = adamw.leaves(params)
        ps = p_specs or [()] * len(blocks)
        ms = m_specs or ps
        # detached: a block that is its own model shard stays untouched
        full = [comm.gather_shard(p, s, shp).detach() for p, s, shp in zip(
            blocks, ps, shapes or [None] * len(blocks))]
        ndims = lm.ref_ndim_tree(cfg, params)
        mbs = [batch] if k == 1 else _split(batch, k)
        counts = comm.sum_data(torch.stack([lm.loss_count(mb)
                                            for mb in mbs]))
        with torch.enable_grad():
            for p in full:
                p.requires_grad_(True)
            ftree = _like(params, full)
            cparams = (quantize_weights_tree(ftree, ndims, tp=ctx.tp,
                                             specs=_like(params, ps))
                       if prequant else ftree)
            cflat = adamw.leaves(cparams)
            if k == 1:
                loss, acc = loss_and_grads(cparams, cfg, ctx, batch,
                                           count=counts[0])
            else:
                acc = None  # allocated after the first backward: lower peak
                loss = torch.zeros((), dtype=torch.float32,
                                   device=full[0].device)
                for j, mb in enumerate(mbs):
                    lm_b, gs = loss_and_grads(cparams, cfg, ctx, mb,
                                              count=counts[j])
                    if acc is None:
                        acc = [torch.zeros(c.shape, dtype=torch.float32,
                                           device=c.device) for c in cflat]
                    for a, g in zip(acc, gs):
                        a.add_(g.to(torch.float32))
                    loss = loss + lm_b
                    del gs
            grads = []
            for i, s in enumerate(ms):
                g = comm.reduce_leaf(acc[i], s)
                acc[i] = None
                grads.append((g / k if k > 1 else g).to(cflat[i].dtype))
            # back through the step-boundary quant: the STE's identity
            if prequant:
                grads = [comm.shard(g, s) for g, s in zip(torch.autograd.grad(
                    [comm.shard(c, s) for c, s in zip(cflat, ms)], full,
                    grad_outputs=grads), ms)]
        del cparams, cflat, ftree
        loss = comm.sum_data(loss)
        if k > 1:
            loss = loss / k
        same = [p == m for p, m in zip(ps, ms)]
        pm = [b if s else comm.shard(f.detach(), m)
              for b, f, s, m in zip(blocks, full, same, ms)]
        del full
        _, opt_state, metrics = adamw.apply(
            opt_cfg, _like(params, pm), _like(params, grads), opt_state,
            ndims, owned=[comm.owns(s) for s in ms],
            all_reduce=comm.all_reduce)
        with torch.no_grad():
            for i, s in enumerate(same):
                if not s:  # the updated blocks into the storage layout
                    whole = comm.gather_shard(pm[i], ms[i], shapes[i])
                    blocks[i].copy_(comm.shard(whole, ps[i]))
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def check_model_axis(cfg, mesh, quant: str = "mxfp4_ste_prequant") -> None:
    """Raise ``NotImplementedError`` (naming ``ROADMAP.md``) unless the
    sharded train step's tensor-parallel layers cover ``cfg`` on
    ``mesh``'s model axis (nothing to cover at model 1): families
    ``dense`` and ``vlm``, query heads, ``vocab``, ``d_ff``, the fused
    K/V dim and (``vlm``) ``d_model`` divisible by the model axis, the
    rank's query heads over their KV heads in equal groups
    (``layers.attention.tp_heads``), and a backend marked
    ``tensor_parallel`` (``float_bf16``, ``mxfp4_ste``'s prequant form)."""
    m = model_size(mesh)
    if m == 1:
        return
    where = f"on a {mesh.name} mesh (model axis {m})"
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) {where}: the sharded train step's "
            "tensor parallelism covers the dense and vlm families; moe "
            "(experts / expert_mlp), hybrid and ssm (state_heads) and audio "
            "on 'model' are not ported, see ROADMAP.md")
    if not backends_lib.get_backend(quant).tensor_parallel:
        raise NotImplementedError(
            f"quant {quant!r} {where}: the tensor-parallel linears run "
            "mxfp4_ste (prequant) or none; see ROADMAP.md")
    _check_heads(cfg, m)
    _check_dims(cfg, m, where)


def _check_heads(cfg, m: int) -> None:
    """Each model rank's query heads over their KV heads in equal groups
    (``layers.attention.tp_heads`` raises otherwise)."""
    for seg in lm.build_segments(cfg):
        for r in range(m):
            tp_heads(seg.attn, m, r)


def _check_dims(cfg, m: int, where: str, **more) -> dict:
    """Raise unless ``vocab``, ``d_ff``, the fused K/V dim (and ``vlm``'s
    ``d_model``), and ``more``, split over a model axis of ``m``; the
    dims by name."""
    dims = {"vocab_size": cfg.vocab_size, "d_ff": cfg.d_ff,
            "n_kv_heads * head_dim": cfg.n_kv_heads * cfg.hd, **more}
    if cfg.frontend != "none":
        dims["d_model"] = cfg.d_model
    for name, n in dims.items():
        if n % m:
            raise NotImplementedError(
                f"{cfg.name} {where}: {name} {n} does not split over it "
                "and would stay whole; see ROADMAP.md")
    return dims


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
    differentiable).

    On a mesh over a process group the step is the sharded one
    (:func:`_train_fn` over a ``MeshComm``) and the arguments are this
    rank's, on ``mesh.device``: its blocks of the parameters (drawn whole
    from seed 0, then cut) and of the moments, and its rows of the global
    batch. ``collectives`` records the step's collectives. On a model
    axis larger than 1 the run context's ``tp`` is the model subgroup's
    communicator; a layout the tensor-parallel layers do not cover
    raises ``NotImplementedError`` (:func:`check_model_axis`)."""
    if isinstance(mesh, Shape):  # (cfg, shape, opt_cfg): one device
        mesh, shape, opt_cfg = None, mesh, shape or opt_cfg
    sharded = mesh is not None and mesh.distributed
    prequant = quant == "mxfp4_ste"
    if prequant:
        quant = "mxfp4_ste_prequant"
    if sharded:
        check_model_axis(cfg, mesh, quant)
    dev = mesh.device if sharded else _device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
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
    batch = _inputs(cfg, shape, dev)
    p_shard = shd.resolve_with_divisibility(specs, params, pctx, mesh)
    m_shard = shd.resolve_with_divisibility(
        shd.opt_state_specs(specs, cfg, mesh, zero1=zero1), params, pctx,
        mesh)
    o_shard = adamw.OptState(step=(), m=m_shard, v=m_shard)
    b_shard = batch_shardings(batch, mesh, sctx)
    if not sharded:
        return StepBundle(fn=fn, ctx=ctx,
                          args=(params, adamw.init(params), batch),
                          shardings=(p_shard, o_shard, b_shard),
                          microbatches=k, mesh=mesh)
    p_specs = shd.spec_leaves(params, p_shard)
    m_specs = shd.spec_leaves(params, m_shard)
    shapes = [tuple(p.shape) for p in adamw.leaves(params)]
    params = _like(params, [shd.take_shard(p, s, mesh) for p, s in zip(
        adamw.leaves(params), p_specs)])

    def moments():
        return _like(params, [
            torch.zeros(shd.shard_shape(s, shp, mesh), dtype=torch.float32,
                        device=dev) for s, shp in zip(m_specs, shapes)])

    opt_state = adamw.OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev), m=moments(),
        v=moments())
    batch = rank_rows(batch, k, data_size(mesh), data_rank(mesh))
    comm = MeshComm(mesh)
    if model_size(mesh) > 1:
        ctx = dataclasses.replace(ctx, tp=comm.model)
    fn = _train_fn(cfg, ctx, k, prequant, opt_cfg, comm, p_specs, m_specs,
                   shapes)
    return StepBundle(fn=fn, ctx=ctx, args=(params, opt_state, batch),
                      shardings=(p_shard, o_shard, b_shard),
                      microbatches=k, mesh=mesh, collectives=comm.stats,
                      axis_collectives=comm.by_axis)


def _head_logits(cfg, params, last_hidden):
    """The head on the last position (the reference's ``_head_logits``): a
    packed head dequantized and multiplied in bf16, not through the
    kernel, as the reference computes it. Under a model axis each rank's
    head holds its vocab columns (a tied table its vocab rows): the
    logits are the rank's columns."""
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


def _prefill_logits(cfg, ctx, params, last_hidden):
    """The prefill's head on the last position: :func:`_head_logits`, or a
    ``cim_analog``-converted head through the backend-dispatched linear
    (``lm._head``: its analog read-out), as the decode step's head."""
    hp = params.get("lm_head")
    if hp is not None and "e_n" in hp:
        return lm._head(ctx, cfg, params, last_hidden[:, None])[:, 0]
    return _head_logits(cfg, params, last_hidden)


def argmax_ids(logits: torch.Tensor, tp=None) -> torch.Tensor:
    """``argmax`` of the last dim in f32 (int64). Under ``tp`` (the model
    axis) ``logits`` are the rank's vocab columns (rank r's block r): each
    rank's largest value and its first index, gathered over the model
    ranks in one all-gather; the largest value wins, a tie the lowest
    global index, as ``torch.argmax`` breaks it on one device."""
    lf = logits.to(torch.float32)
    ids = torch.argmax(lf, dim=-1)
    if tp is None:
        return ids
    val = torch.gather(lf, -1, ids[..., None])[..., 0]
    gid = ids + tp.rank * lf.shape[-1]
    pair = torch.stack([val.to(torch.float64), gid.to(torch.float64)], -1)
    every = tp.all_gather(pair[None], 0)  # [model, ..., 2]
    vals, idx = every[..., 0], every[..., 1]
    best = vals.amax(0)
    pick = torch.where(vals == best, idx, torch.full_like(idx, float("inf")))
    return pick.amin(0).to(torch.int64)


def _step_device(mesh, device, sharded: bool) -> torch.device:
    """A serving bundle's device: the rank's on a mesh over a group (or
    ``meta``, shapes only, for a caller that brings its own blocks), else
    ``device`` (:func:`_device`)."""
    if sharded and (device is None or torch.device(device).type != "meta"):
        return mesh.device
    return _device(device)


def _serve_params(cfg, mesh, quant: str, shd_ctx, device):
    params, specs = param_structs(cfg, serve_quant=quant == "mxfp4_wonly",
                                  device=device)
    return params, shd.resolve_with_divisibility(specs, params, shd_ctx,
                                                 mesh)


def serve_specs(cfg, params, mesh, mode: str,
                batch_size: int | None = None):
    """The resolved specs of a served tree ``params`` (float, packed or
    ``cim_analog``-converted: ``layers.common.convert_specs_cim``) under
    the serving rules of ``mode`` (``prefill`` / ``decode``) on ``mesh``.
    Raises ``NotImplementedError`` (naming ``ROADMAP.md``) where a
    converted linear's ``codes`` and ``exps`` would be cut differently: a
    K shard that is not a whole number of 32-blocks."""
    sctx = shd.make_ctx(cfg, mesh, mode, batch_size=batch_size)
    specs = shd.resolve_with_divisibility(
        convert_specs_cim(lm.param_specs(cfg), params), params, sctx, mesh)

    def check(node, spec, path):
        if isinstance(node, dict):
            if "codes" in node and spec["codes"] != spec["exps"]:
                raise NotImplementedError(
                    f"{path}: codes {spec['codes']} and exps {spec['exps']} "
                    f"on a {mesh.name} mesh: the K shard is not a whole "
                    "number of 32-blocks; see ROADMAP.md")
            for k, v in node.items():
                check(v, spec[k], f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                check(v, spec[i], f"{path}/{i}")

    check(params, specs, "params")
    return specs


def shard_params(cfg, mesh, params, mode: str,
                 batch_size: int | None = None):
    """A caller's served tree (float, packed or calibrated ``cim``) cut to
    this rank's blocks under the serving rules of ``mode``
    (:func:`serve_specs`, ``sharding.take_shard_tree``: kernel A's K-major
    codes stay K-major): (the blocks, their resolved specs). Over a
    process group every rank takes rank 0's calibration (each
    ``e_n`` / ``adc_fs`` broadcast from it), so the ranks' read-outs
    agree whatever each calibrated."""
    specs = serve_specs(cfg, params, mesh, mode, batch_size)
    blocks = shd.take_shard_tree(params, specs, mesh)
    if mesh.distributed:
        _broadcast_calibration(blocks)
    return blocks, specs


def _broadcast_calibration(tree) -> None:
    if isinstance(tree, dict):
        if "e_n" in tree:
            for name in ("e_n", "adc_fs"):
                dist.broadcast(tree[name].reshape(1), 0)
        for v in tree.values():
            _broadcast_calibration(v)
    elif isinstance(tree, list):
        for v in tree:
            _broadcast_calibration(v)


def check_serve_axis(cfg, mesh, quant: str, mode: str) -> None:
    """Raise ``NotImplementedError`` (naming ``ROADMAP.md``) unless the
    sharded serving steps cover ``cfg`` under ``quant`` on ``mesh``'s
    model axis (nothing to cover at model 1): families ``dense`` and
    ``vlm``; ``quant`` one of ``none``, ``mxfp4_wonly`` and ``cim``;
    ``vocab``, ``d_ff`` and the fused Q and K/V dims divisible by the
    model axis (and ``d_model`` for ``vlm``'s front end); at prefill the
    rank's query heads over their KV heads in equal groups
    (``layers.attention.tp_heads``; heads are whole at decode); and under
    ``mxfp4_wonly`` / ``cim`` the K shards of the row-parallel ``wo`` and
    ``w2`` whole 32-blocks (kernel C's and A's blocks)."""
    m = model_size(mesh)
    if m == 1:
        return
    where = f"on a {mesh.name} mesh (model axis {m})"
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) {where}: the sharded serving steps' "
            "model axis covers the dense and vlm families; moe, hybrid, ssm "
            "and audio on 'model' are not ported, see ROADMAP.md")
    name = backends_lib.get_backend(quant).name
    if name not in ("float_bf16", "mxfp4_wonly", "cim_analog"):
        raise NotImplementedError(
            f"quant {quant!r} {where}: the sharded serving steps run none, "
            "mxfp4_wonly or cim; see ROADMAP.md")
    if mode == "prefill":
        _check_heads(cfg, m)
    dims = _check_dims(cfg, m, where, **{"n_heads * head_dim":
                                         cfg.n_heads * cfg.hd})
    if name != "float_bf16":
        for dim in ("n_heads * head_dim", "d_ff"):
            if (dims[dim] // m) % 32:
                raise NotImplementedError(
                    f"{cfg.name} {where} under {quant}: the row-parallel K "
                    f"shard of {dims[dim] // m} ({dim} / {m}) is not a whole "
                    "number of 32-blocks; see ROADMAP.md")


def _axis_comm(comm: MeshComm, axes: tuple):
    """The collectives over the ranks of mesh ``axes`` (a resolved entry)."""
    names = set(axes)
    if names == {"model"}:
        return comm.model
    if names == {"data"}:
        return comm.data
    if names == {"data", "model"}:
        return comm.world
    raise NotImplementedError(f"a cache sequence over {axes}; see ROADMAP.md")


def _seq_shards(layout, mesh, comm: MeshComm, key: str = "k") -> tuple:
    """Each segment's :class:`~repro_torch.distributed.seq_parallel.
    SeqShard` from its first layer's resolved cache spec (the sequence on
    dim 1 of ``key``), or None where that axis is whole."""
    out = []
    for seg_spec in layout:
        spec = seg_spec[0][key]
        idx, n = shd.shard_index(spec, 1, mesh)
        out.append(None if n == 1 else spl.SeqShard(
            _axis_comm(comm, shd.dim_axes(spec[1])), n, idx))
    return tuple(out)


def _cache_layout(c_shard) -> list:
    """The resolved cache specs as the sharded steps hold the caches: the
    reference's, but the V mirror's 32-block exponents (``v_exps``,
    replicated there) cut as its codes are, each rank's blocks beside its
    codes (``distributed.seq_parallel``): the legacy ``v_codes``' key
    axis, or the fused pool's rows and slot-block axis as ``kv``'s."""
    out = []
    for seg in c_shard:
        layers = []
        for spec in seg:
            spec = dict(spec)
            if "v_exps" in spec and "v_codes" in spec:
                spec["v_exps"] = spec["v_codes"]
            elif "v_exps" in spec and "kv" in spec:
                spec["v_exps"] = tuple(spec["kv"][:2]) + (None, None)
            layers.append(spec)
        out.append(layers)
    return out


def _templates(tree, specs, mesh):
    """``meta`` tensors of the blocks' shapes of ``tree`` under ``specs``
    (a prefill's caches: only their shapes and dtypes are read)."""
    if isinstance(tree, dict):
        return {k: _templates(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_templates(v, specs[i], mesh) for i, v in enumerate(tree)]
    return torch.empty(shd.shard_shape(tuple(specs), tree.shape, mesh),
                       dtype=tree.dtype, device="meta")


def _mesh_ctx(ctx: RunCtx, mesh, comm: MeshComm, c_layout=None,
              key: str = "k", model_forms: bool = False) -> RunCtx:
    """The run context of a sharded serving step: the model axis's
    communicator (at model > 1, or with ``model_forms``) and each
    segment's cut cache sequence."""
    tp = comm.model if model_size(mesh) > 1 or model_forms else None
    seq = (_seq_shards(c_layout, mesh, comm, key)
           if c_layout is not None else None)
    if seq is not None and all(s is None for s in seq):
        seq = None
    return dataclasses.replace(ctx, tp=tp, seq_shards=seq)


def _sharded_bundle(**kw) -> StepBundle:
    comm = kw.pop("comm")
    return StepBundle(collectives=comm.stats, axis_collectives=comm.by_axis,
                      **kw)


def make_prefill_step(cfg, mesh: Mesh, shape: Shape,
                      quant: str = "mxfp4_wonly", with_cache: bool = True,
                      device=None, model_forms: bool = False) -> StepBundle:
    """``fn(params, batch) -> (next ids [B], caches)``: a prefill of
    ``shape`` into fresh legacy caches (none for an encoder-only arch or
    without ``with_cache``), the head on the last position, argmax.

    On a mesh over a process group (``mesh.distributed``) the step runs
    sharded under the prefill rules, the reference's GSPMD program
    written out: the arguments are the rank's blocks (its rows of the
    batch over the data axes where they divide, else every row; its model
    shards of the weights: ``qkv_fused``, ``mlp`` and ``vocab`` on
    ``model``), the attention runs on the rank's heads (``heads`` on
    ``model``), the caches come back as its blocks (every KV head, its
    block of the sequence: ``cache_seq`` on ``model``) and the ids as its
    rows, the argmax combined over the model ranks (:func:`argmax_ids`).
    ``collectives`` records the step's collectives."""
    sharded = mesh is not None and mesh.distributed
    if sharded:
        check_serve_axis(cfg, mesh, quant, "prefill")
    dev = _step_device(mesh, device, sharded)
    ctx = RunCtx(quant=quant)
    sctx = shd.make_ctx(cfg, mesh, "prefill")
    params, p_shard = _serve_params(cfg, mesh, quant, sctx, dev)
    batch = _inputs(cfg, shape, dev)
    b_shard = batch_shardings(batch, mesh, sctx)
    with_c = with_cache and cfg.supports_decode
    rows, c_layout, templates = shape.batch, None, None
    if sharded:
        comm = MeshComm(mesh)
        rows = shd.shard_shape(b_shard[next(iter(batch))],
                               (shape.batch,), mesh)[0]
        if with_c:
            meta = lm.init_cache(cfg, shape.batch, shape.seq, device="meta")
            c_layout = shd.resolve_with_divisibility(
                _cache_spec_tree(cfg), meta, sctx, mesh)
            templates = _templates(meta, c_layout, mesh)
        ctx = _mesh_ctx(ctx, mesh, comm, c_layout, model_forms=model_forms)
        params = shd.take_shard_tree(params, p_shard, mesh)
        batch = shd.take_shard_tree(batch, b_shard, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        bdev = next(iter(batch.values())).device
        caches = None
        if with_c:
            caches = (templates if templates is not None else
                      lm.init_cache(cfg, rows, shape.seq, device=bdev))
        hidden, caches = lm.forward(params, cfg, ctx, batch, caches=caches,
                                    return_hidden=True)
        logits = _prefill_logits(cfg, ctx, params, hidden[:, -1])
        ids = argmax_ids(logits, ctx.tp)
        return (ids, caches) if with_c else (ids, ())

    kw = dict(fn=prefill_step, ctx=ctx, args=(params, batch),
              shardings=(p_shard, b_shard), mesh=mesh)
    if not sharded:
        return StepBundle(**kw)
    return _sharded_bundle(comm=comm, **kw)


def _cache_spec_tree(cfg, mx_digital: bool = False,
                     fused: bool = False) -> list:
    """Logical axes of every leaf of ``lm.init_cache``'s tree (one dict a
    layer; the reference's ``cache_specs`` without its ``layers`` axis)."""
    return [[dict(s) for _ in range(seg.n)]
            for s, seg in zip(lm.cache_specs(cfg, mx_digital=mx_digital,
                                             fused=fused),
                              lm.build_segments(cfg))]


def _decode_logits(cfg, ctx, params, ids, pos, caches):
    """``lm.decode_step``'s logits and caches; under a model axis the
    hidden states, then the head (the rank's vocab columns)."""
    if ctx.tp is None:
        return lm.decode_step(params, cfg, ctx, ids, pos, caches)
    hidden, caches = lm.forward(params, cfg, ctx, {"ids": ids},
                                caches=caches, pos=pos, return_hidden=True)
    return lm._head(ctx, cfg, params, hidden)[:, -1], caches


def make_decode_step(cfg, mesh: Mesh, shape: Shape,
                     quant: str = "mxfp4_wonly", device=None,
                     model_forms: bool = False) -> StepBundle:
    """``fn(params, caches, ids, pos) -> (next ids int32 [B], caches)``:
    one decode step of ``shape.batch`` lanes over legacy caches of
    ``shape.seq`` (the bundle's ``pos`` is the last slot, so every slot
    is live).

    On a mesh over a process group the step runs sharded under the
    decode rules (the reference's flash-decoding): the caches are the
    rank's blocks (its rows over the data axes where the batch divides;
    the sequence on ``model``, or on ``(data, model)`` below 16 lanes
    when the batch does not fill the data axes; ``v_exps`` held beside
    ``v_codes``: ``distributed.seq_parallel``), the ids its rows; the
    weights' model shards run column- and row-parallel, q, k and v are
    gathered over the model ranks (heads are whole at decode), each rank
    scores its slots and the softmax is combined over the ranks that hold
    the sequence; the argmax is combined over the model ranks. ``pos``
    is replicated."""
    sharded = mesh is not None and mesh.distributed
    if sharded:
        check_serve_axis(cfg, mesh, quant, "decode")
    dev = _step_device(mesh, device, sharded)
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
    ids = inp["ids"]
    if sharded:
        comm = MeshComm(mesh)
        layout = _cache_layout(c_shard)
        ctx = _mesh_ctx(ctx, mesh, comm, layout, model_forms=model_forms)
        params = shd.take_shard_tree(params, p_shard, mesh)
        caches = shd.take_shard_tree(caches, layout, mesh)
        ids = shd.take_shard(ids, ids_shard, mesh)

    @torch.no_grad()
    def serve_step(params, caches, ids, pos):
        logits, new_caches = _decode_logits(cfg, ctx, params, ids, pos,
                                            caches)
        next_ids = argmax_ids(logits, ctx.tp)
        return next_ids.to(torch.int32), new_caches

    kw = dict(fn=serve_step, ctx=ctx, args=(params, caches, ids, inp["pos"]),
              shardings=(p_shard, c_shard, ids_shard, ()), mesh=mesh)
    if not sharded:
        return StepBundle(**kw)
    return _sharded_bundle(comm=comm, **kw)


def make_paged_decode_step(cfg, mesh: Mesh, shape: Shape, num_slots: int,
                           quant: str = "mxfp4_wonly",
                           kv_layout: str = "legacy",
                           device=None, model_forms: bool = False
                           ) -> StepBundle:
    """``fn(params, pool, rows, ids, pos) -> (next ids int32 [lanes],
    pool)``: one continuous-batching decode step over a slot-paged KV
    pool (the reference's ``make_paged_decode_step``). ``shape.batch`` is
    the number of decode lanes; the pool (``lm.init_cache``) holds
    ``num_slots`` request pages plus one scratch row a lane, of
    ``shape.seq`` positions, quantized-resident under ``cim`` (the
    hybrid's digital SDPA). ``rows`` (int [lanes]: a pool row a lane),
    ``ids`` (int [lanes, 1]) and ``pos`` (int [lanes]) are the step's
    inputs, as in the reference (int32 in the bundle).

    ``kv_layout="legacy"`` gathers the lanes' pages, runs
    ``lm.decode_step`` on them and scatters them back
    (``serving.kvcache.gather_rows`` / ``scatter_rows``, the engine's
    legacy step); ``"fused"`` decodes in place on the head-interleaved
    pages through the paged decode kernels (``RunCtx.paged_rows``, the
    engine's fused step). The pool is updated in place and returned.

    On a mesh over a process group the step runs sharded: the pool is
    the rank's blocks under the decode rules (its slot axis carries
    ``batch``). Where the pool's rows are cut over the data axes a lane
    is decoded by the data rank that holds its row (its ids, not its
    pages, move: the reference all-gathers the pages), on that rank's
    rows (a host read of ``rows`` picks them), and the next ids are
    summed over the data ranks (one all-reduce); where they are whole,
    every rank decodes every lane on its block of the sequence. ``rows``,
    ``ids`` and ``pos`` are replicated, the ids come back replicated.
    ``legacy`` runs the sharded decode of :func:`make_decode_step`;
    ``fused`` runs kernels B and D on the rank's rows: as they are where
    the sequence is whole, else in their partial mode on the rank's block
    of it, the blocks' (o, lse) combined over the ranks that hold the
    sequence (``distributed.seq_parallel.fused_decode``; heads whole, q, k
    and v gathered over the model ranks). Under the digital SDPA a block
    must be whole 32-slot blocks, or it raises ``NotImplementedError``
    (``ROADMAP.md``). With ``model_forms`` the fused decode takes the
    partial mode at one block, its combine over identity collectives."""
    if kv_layout not in ("legacy", "fused"):
        raise ValueError(f"unknown KV layout {kv_layout!r}")
    fused = kv_layout == "fused"
    lanes = shape.batch
    sharded = mesh is not None and mesh.distributed
    if sharded:
        check_serve_axis(cfg, mesh, quant, "decode")
    dev = _step_device(mesh, device, sharded)
    ctx = RunCtx(quant=quant)
    sctx = shd.make_ctx(cfg, mesh, "decode", batch_size=lanes)
    params, p_shard = _serve_params(cfg, mesh, quant, sctx, dev)
    mx_dig = ctx.hybrid_digital_sdpa  # quantized-resident pool for cim
    specs = lm.cache_specs(cfg, mx_digital=mx_dig, fused=fused)
    pool = lm.init_cache(cfg, num_slots + lanes, shape.seq,
                         mx_digital=mx_dig, fused=fused, device=dev)
    pool_shard = shd.resolve_with_divisibility(
        _cache_spec_tree(cfg, mx_dig, fused), pool, sctx, mesh)
    rows = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    ids = torch.zeros((lanes, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    kw = dict(shardings=(p_shard, pool_shard, (), (), ()), mesh=mesh)
    by_data, first_row, local_rows = False, 0, num_slots + lanes
    if sharded:
        comm = MeshComm(mesh)
        layout = _cache_layout(pool_shard)
        key = "kv" if fused else "k"
        ctx = _mesh_ctx(ctx, mesh, comm, layout, key, model_forms)
        first = layout[0][0][key]
        local_rows = shd.shard_shape(first, (local_rows,), mesh)[0]
        by_data = shd.shard_index(first, 0, mesh)[1] > 1  # rows over data
        first_row = data_rank(mesh) * local_rows
        if fused and mx_dig:
            for seg, shard in zip(pool, ctx.seq_shards or ()):
                if shard is not None:
                    spl.check_blocks(seg[0]["kv"].shape[1] // shard.n,
                                     "the digital SDPA's P quantization on "
                                     "the fused pool")
        params = shd.take_shard_tree(params, p_shard, mesh)
        pool = shd.take_shard_tree(pool, layout, mesh)

    @torch.no_grad()
    def paged_step(params, pool, rows, ids, pos):
        rows, ids, pos = rows.long(), ids.long(), pos.long()
        sel = None
        if by_data:  # the lanes whose pool row this data rank holds
            sel = torch.nonzero((rows >= first_row)
                                & (rows < first_row + local_rows))[:, 0]
            rows, ids, pos = rows[sel] - first_row, ids[sel], pos[sel]
        out = torch.zeros((lanes,), dtype=torch.int64, device=rows.device)
        if rows.numel():
            if fused:
                dctx = dataclasses.replace(ctx, paged_rows=rows)
                logits, _ = _decode_logits(cfg, dctx, params, ids, pos, pool)
            else:
                caches = gather_rows(pool, specs, rows)
                logits, caches = _decode_logits(cfg, ctx, params, ids, pos,
                                                caches)
                scatter_rows(pool, specs, rows, caches)
            got = argmax_ids(logits, ctx.tp)
            if sel is None:
                out = got
            else:
                out[sel] = got
        if by_data:
            comm.data.all_reduce(out)
        return out.to(torch.int32), pool

    kw.update(fn=paged_step, ctx=ctx, args=(params, pool, rows, ids, pos))
    if not sharded:
        return StepBundle(**kw)
    return _sharded_bundle(comm=comm, **kw)


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
