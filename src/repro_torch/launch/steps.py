"""Step builders: train, prefill, decode and paged decode, with the
sharding of their arguments resolved from the logical-axis rules
(counterpart of the reference's ``repro.launch.steps``). Shared by the
training launcher, the dry-run and ``chip_smoke.py``.

Each builder returns a :class:`StepBundle`: the step function, its
arguments built on ``device`` (default ``cuda``; ``meta`` for the
dry-run, shapes and dtypes only; ``cpu`` in tests; never the CPU on its
own), the run context and the arguments' resolved specs on ``mesh``
(``launch.mesh``). The prefill, decode and paged decode steps run on
one device, where their arguments are: the reference's GSPMD
partitioning of them over the mesh is what the specs describe and the
dry-run counts, not what runs (``ROADMAP.md``).

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
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import configs as C
from repro_torch import resolve_device
from repro_torch.configs import Shape
from repro_torch.data.pipeline import rank_rows
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
    for seg in lm.build_segments(cfg):
        for r in range(m):
            tp_heads(seg.attn, m, r)
    dims = {"vocab_size": cfg.vocab_size, "d_ff": cfg.d_ff,
            "n_kv_heads * head_dim": cfg.n_kv_heads * cfg.hd}
    if cfg.frontend != "none":
        dims["d_model"] = cfg.d_model
    for name, n in dims.items():
        if n % m:
            raise NotImplementedError(
                f"{cfg.name} {where}: {name} {n} does not split over it "
                "and would stay whole; see ROADMAP.md")


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


def make_paged_decode_step(cfg, mesh: Mesh, shape: Shape, num_slots: int,
                           quant: str = "mxfp4_wonly",
                           kv_layout: str = "legacy",
                           device=None) -> StepBundle:
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
    engine's fused step). The pool is updated in place and returned. The
    step runs on one device; ``shardings`` are the pool's specs resolved
    on ``mesh`` (its slot axis carries ``batch``)."""
    if kv_layout not in ("legacy", "fused"):
        raise ValueError(f"unknown KV layout {kv_layout!r}")
    fused = kv_layout == "fused"
    lanes = shape.batch
    dev = _device(device)
    ctx = RunCtx(quant=quant)
    sctx = shd.make_ctx(cfg, mesh, "decode", batch_size=lanes)
    params, p_shard = _serve_params(cfg, mesh, quant, sctx, dev)
    mx_dig = ctx.hybrid_digital_sdpa  # quantized-resident pool for cim
    specs = lm.cache_specs(cfg, mx_digital=mx_dig, fused=fused)
    pool = lm.init_cache(cfg, num_slots + lanes, shape.seq,
                         mx_digital=mx_dig, fused=fused, device=dev)
    pool_shard = shd.resolve_with_divisibility(
        [[dict(s) for _ in range(seg.n)]
         for s, seg in zip(specs, lm.build_segments(cfg))], pool, sctx, mesh)
    rows = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    ids = torch.zeros((lanes, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((lanes,), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def paged_step(params, pool, rows, ids, pos):
        rows, ids, pos = rows.long(), ids.long(), pos.long()
        if fused:
            dctx = dataclasses.replace(ctx, paged_rows=rows)
            logits, _ = lm.decode_step(params, cfg, dctx, ids, pos, pool)
        else:
            caches = gather_rows(pool, specs, rows)
            logits, caches = lm.decode_step(params, cfg, ctx, ids, pos,
                                            caches)
            scatter_rows(pool, specs, rows, caches)
        next_ids = torch.argmax(logits.to(torch.float32), dim=-1)
        return next_ids.to(torch.int32), pool

    return StepBundle(fn=paged_step, ctx=ctx,
                      args=(params, pool, rows, ids, pos),
                      shardings=(p_shard, pool_shard, (), (), ()),
                      mesh=mesh)


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
