"""The ranks' side of ``tests/test_torch_tp.py``: each function runs in a
spawned gloo rank (``torch_dist.spawn``), builds the sharded train step
with a model axis (tensor parallelism over ``heads``, ``mlp`` and
``vocab``) for the tiny dense and vlm configs on the CPU, and returns
global tensors (gathered over both axes) for the test to hold against
one-device runs. No JAX here: the ranks import the port only.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch import configs as C
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.layers.common import embed_apply, quantize_weights_tree
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig, loss_and_grads

import torch_fsdp_ranks as F

ARCHS = ("h2o-danube-1.8b", "starcoder2-7b", "gemma3-1b", "nemotron-4-15b",
         "qwen2-vl-7b")
# the configs also held against the reference's own train step
REF_ARCHS = ("h2o-danube-1.8b", "gemma3-1b", "qwen2-vl-7b")
SHAPE = F.SHAPE  # [4, 32]
DENSE = F.DENSE  # S = 32 takes the online-softmax prefill
# Adam's first update follows g at eps 1 (at eps 1e-8 it is lr sign(g)),
# so each leaf's move can be held to the one-device move
ADAM = F.REF_ADAM


def config(arch: str, d_ff: int | None = None):
    cfg = C.tiny(C.ARCHS[arch])
    return cfg if d_ff is None else dataclasses.replace(cfg, d_ff=d_ff)


def bundle(cfg, mesh, k: int = 1, dense: int = DENSE, adam=ADAM, init=None,
           batch=None):
    """The sharded bundle (arguments cut to this rank's blocks from the
    global ``init`` / numpy ``batch`` where given)."""
    return F.bundle(mesh, k=k, init=init, batch=batch, dense=dense,
                    adam=adam, cfg=cfg)


def one_step(cfg, mesh, **kw) -> dict:
    b, params, opt_state, rows = bundle(cfg, mesh, **kw)
    params, opt_state, met = b.fn(params, opt_state, rows)
    out = F.state(mesh, b.shardings, params, opt_state, met)
    out["collectives"] = {a: {k: list(v) for k, v in st.by_kind.items()}
                          for a, st in b.axis_collectives.items() if st.count}
    return out


def grads(cfg, mesh) -> dict:
    """This rank's gradients of the step's loss at seed 0's init (its
    model shards; data size 1), and the specs of the leaves."""
    b, params, _, rows = bundle(cfg, mesh)
    specs = shd.spec_leaves(params, b.shardings[0])
    q = quantize_weights_tree(params, lm.ref_ndim_tree(cfg, params),
                              tp=b.ctx.tp, specs=b.shardings[0])
    _, gs = loss_and_grads(q, cfg, b.ctx, rows)
    return {"grads": [g.detach() for g in gs], "specs": specs}


def quantized(cfg, mesh) -> list:
    """This rank's step-boundary fake-quant of its model shards of seed
    0's init (data size 1: the blocks are the model shards)."""
    b, params, _, _ = bundle(cfg, mesh)
    q = quantize_weights_tree(params, lm.ref_ndim_tree(cfg, params),
                              tp=b.ctx.tp, specs=b.shardings[0])
    return [t.detach() for t in adamw.leaves(q)]


def embedded(cfg, mesh) -> torch.Tensor:
    """The vocab-parallel lookup of the batch's ids from this rank's rows
    of seed 0's table."""
    b, params, _, rows = bundle(cfg, mesh)
    with torch.no_grad():
        return embed_apply(params["embed"], rows["ids"], tp=b.ctx.tp)


def _trainer(cfg, mesh, d: str, total: int) -> Trainer:
    b = steps.make_train_step(cfg, mesh, SHAPE, F.opt(), device="cpu",
                              dense_attn_max=DENSE)
    return Trainer(cfg, SHAPE, TrainerConfig(total_steps=total, ckpt_every=2,
                                             ckpt_dir=d, seed=3), bundle=b)


def _trainer_state(t: Trainer) -> dict:
    return F.state(t.mesh, (t.shardings["params"], t.shardings["opt"]),
                   t.params, t.opt_state)


def world2(rank: int, world: int, tmp: str, ref: dict) -> dict:
    """Every world-2 check on a (1, 2) mesh (see the test module); each
    rank returns its own part where the test compares ranks. ``ref``
    maps each of ``REF_ARCHS`` to the reference's init (converted) and
    its numpy batch."""
    mesh = make_local_mesh(1, 2, device="cpu")
    out = {"steps": {}, "grads": {}}
    for arch in ARCHS:
        cfg = config(arch)
        out["steps"][arch] = one_step(cfg, mesh)
        out["grads"][arch] = grads(cfg, mesh)
    # the step-boundary quant's two branches: w2's K shard of 48 (d_ff 96)
    # is not a whole number of 32-blocks, of 64 (d_ff 128) it is
    cfg = config("h2o-danube-1.8b")
    out["quant"] = {ff: quantized(config("h2o-danube-1.8b", ff), mesh)
                    for ff in (96, 128)}
    out["embed"] = embedded(cfg, mesh)
    # the reference builder's context: dense attention to 2048
    out["reference"] = {
        arch: one_step(config(arch), mesh, init=init, batch=batch,
                       dense=2048) for arch, (init, batch) in ref.items()}
    # the trainer: 4 steps against 2, killed, and 2 more after a restart
    full = _trainer(cfg, mesh, os.path.join(tmp, "ta"), 4)
    out["trainer_full"] = full.run()["final_step"]
    _trainer(cfg, mesh, os.path.join(tmp, "tb"), 2).run()
    resumed = _trainer(cfg, mesh, os.path.join(tmp, "tb"), 4)
    out["trainer_start"] = resumed.start_step
    resumed.run()
    out["kill_restart"] = (_trainer_state(full), _trainer_state(resumed))
    return out


def restored(cfg, mesh, ckpt: str) -> dict:
    """The (2, 2) checkpoint restored onto ``mesh``'s ranks, gathered."""
    b = steps.make_train_step(cfg, mesh, SHAPE, F.opt(**ADAM), device="cpu",
                              dense_attn_max=DENSE)
    params, opt_state, _ = b.args
    got = CheckpointManager(ckpt).restore(
        1, {"params": params, "opt": opt_state},
        shardings={"params": b.shardings[0], "opt": b.shardings[1]},
        mesh=mesh)
    return F.state(mesh, b.shardings, got["params"], got["opt"])


def world4(rank: int, world: int, tmp: str, store1: str) -> dict | None:
    """(2, 2) then (1, 4) for every arch; a checkpoint saved at (2, 2)
    and restored at (4, 1), (1, 4) and then on one rank (rank 0 alone),
    with the (1, 1) step on a group of one; the launcher's pod mesh."""
    from torch_dist import regroup

    out: dict = {"22": {}, "14": {}}
    ckpt = os.path.join(tmp, "ckpt22")
    danube = config("h2o-danube-1.8b")
    mesh = make_local_mesh(2, 2, device="cpu")  # every rank: its subgroups
    row = make_local_mesh(1, 4, device="cpu")
    for arch in ARCHS:
        cfg = config(arch)
        b, params, opt_state, rows = bundle(cfg, mesh)
        params, opt_state, met = b.fn(params, opt_state, rows)
        out["22"][arch] = F.state(mesh, b.shardings, params, opt_state, met)
        if arch == "h2o-danube-1.8b":
            CheckpointManager(ckpt).save(
                1, {"params": params, "opt": opt_state}, blocking=True,
                shardings={"params": b.shardings[0],
                           "opt": b.shardings[1]}, mesh=mesh)
        out["14"][arch] = one_step(cfg, row)
    out["restore41"] = restored(danube, make_local_mesh(4, 1, device="cpu"),
                                ckpt)
    out["restore14"] = restored(danube, row, ckpt)
    try:
        train_launcher.main(["--mesh", "single", "--tiny", "--device", "cpu",
                             "--steps", "1", "--ckpt",
                             os.path.join(tmp, "launcher")])
        out["launcher"] = None
    except ValueError as e:
        out["launcher"] = str(e)
    if rank:
        return None
    regroup(store1, 0, 1)
    one = make_local_mesh(1, 1, device="cpu")
    out["restore1"] = restored(danube, one, ckpt)
    out["11"] = {arch: one_step(config(arch), one)
                 for arch in ("h2o-danube-1.8b", "gemma3-1b")}
    return out
