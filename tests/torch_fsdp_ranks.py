"""The ranks' side of ``tests/test_torch_fsdp.py``: each function runs in
a spawned gloo rank (``torch_dist.spawn``), builds the sharded train step
of tiny h2o-danube-1.8b on the CPU and returns what rank 0 gathered
(global tensors, so the test compares them with one-device runs). No
JAX here: the ranks import the port only.
"""

from __future__ import annotations

import os
import signal

import torch

from repro_torch import configs as C
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.data.pipeline import rank_rows
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import MeshComm
from repro_torch.launch import steps
from repro_torch.distributed.mesh import data_rank, data_size
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CFG = C.tiny(C.H2O_DANUBE_1_8B)
SHAPE = C.Shape(32, 4, "train")
DENSE = 16  # dense_attn_max: S=32 takes the online-softmax prefill
CLIP_OFF = 1e9  # clip_norm far above any gradient norm here
LR = 1e-2
# against the reference: Adam's first update is g / (|g| + eps); at eps 1
# it follows g, so the two steps' moves can be compared (at eps 1e-8 it is
# lr * sign(g), which flips wherever g is near 0)
REF_ADAM = dict(lr=1.0, eps=1.0, warmup_steps=0)


def opt(clip: float = 1.0, **kw) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(**{"lr": LR, "warmup_steps": 0,
                                "clip_norm": clip, **kw})


def bundle(mesh, k: int = 1, clip: float = 1.0, init=None, batch=None,
           dense: int = DENSE, adam: dict | None = None, cfg=CFG):
    """The sharded bundle of ``cfg`` on ``mesh``; ``init`` (a global
    parameter tree, keyed as the port's) replaces its seed-0 parameters
    and ``batch`` (a global numpy batch) its inputs, each cut to this
    rank's part (its rows: the data axes'); ``adam`` overrides the AdamW
    settings."""
    b = steps.make_train_step(cfg, mesh, SHAPE, opt(clip, **(adam or {})),
                              microbatches=k, device="cpu",
                              dense_attn_max=dense)
    params, opt_state, rows = b.args
    if init is not None:
        specs = shd.spec_leaves(params, b.shardings[0])
        whole = adamw.leaves(_aligned(params, init))
        params = steps._like(params, [shd.take_shard(t, s, mesh)
                                      for t, s in zip(whole, specs)])
    if batch is not None:
        rows = {n: torch.from_numpy(v) for n, v in rank_rows(
            batch, k, data_size(mesh), data_rank(mesh)).items()}
    return b, params, opt_state, rows


def _aligned(template, tree):
    """``tree``'s leaves in ``template``'s key order."""
    if isinstance(template, dict):
        return {k: _aligned(v, tree[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_aligned(v, tree[i]) for i, v in enumerate(template)]
    return tree


def gathered(mesh, tree, specs) -> list:
    """Every leaf of a rank's ``tree`` of blocks, whole: over the data
    axes and ``model`` (every rank calls it; not recorded in any step's
    collectives)."""
    comm = MeshComm(mesh)
    return [comm.gather_leaf(t, s, shd.global_shape(s, t.shape, mesh))
            .clone() for t, s in zip(adamw.leaves(tree),
                                     shd.spec_leaves(tree, specs))]


def state(mesh, shardings, params, opt_state, met=None) -> dict:
    """The whole parameters and moments (and the metrics) of a rank's
    blocks under ``shardings`` (the bundle's first two)."""
    p_shard, o_shard = shardings[:2]
    out = {"params": gathered(mesh, params, p_shard),
           "m": gathered(mesh, opt_state.m, o_shard.m),
           "v": gathered(mesh, opt_state.v, o_shard.v)}
    if met is not None:
        out["met"] = {k: v.clone() for k, v in met.items()}
    return out


def one_step(mesh, **kw) -> dict:
    b, params, opt_state, rows = bundle(mesh, **kw)
    params, opt_state, met = b.fn(params, opt_state, rows)
    out = state(mesh, b.shardings, params, opt_state, met)
    out["collectives"] = {k: list(v)
                          for k, v in b.collectives.by_kind.items()}
    return out


def _trainer(mesh, d: str, total: int) -> Trainer:
    b = steps.make_train_step(CFG, mesh, SHAPE, opt(), device="cpu",
                              dense_attn_max=DENSE)
    return Trainer(CFG, SHAPE, TrainerConfig(total_steps=total, ckpt_every=2,
                                             ckpt_dir=d, seed=3), bundle=b)


def _trainer_state(t: Trainer) -> dict:
    return state(t.mesh, (t.shardings["params"], t.shardings["opt"]),
                 t.params, t.opt_state)


def world2(rank: int, world: int, tmp: str, ref_init, ref_batch,
           ragged_mask) -> dict | None:
    """Every world-2 check in one group (see the test module)."""
    mesh = make_local_mesh(world, 1, device="cpu")
    out = {"clip_off": one_step(mesh, clip=CLIP_OFF),
           "clip": one_step(mesh),
           # the reference builder's context: dense attention to 2048
           "reference": one_step(mesh, init=ref_init, batch=ref_batch,
                                 dense=2048, adam=REF_ADAM)}
    batch = {n: t.numpy() for n, t in C.concrete_inputs(
        CFG, SHAPE, device="cpu").items()}
    batch["loss_mask"] = ragged_mask
    out["ragged"] = one_step(mesh, k=2, clip=CLIP_OFF, batch=batch)
    # FSDP over pod x data, ZeRO-1 over data: the parameters cut over
    # pod, the moments whole on each rank
    pod = Mesh(("pod", "data", "model"), (2, 1, 1), mesh.devices,
               rank=rank)
    out["pod"] = one_step(pod, clip=CLIP_OFF)
    try:  # a family the model axis does not cover (experts on 'model')
        steps.make_train_step(C.tiny(C.ARCHS["mixtral-8x22b"]),
                              make_local_mesh(1, 2, device="cpu"), SHAPE,
                              device="cpu")
        out["model_axis"] = "built"
    except NotImplementedError as e:
        out["model_axis"] = str(e)
    # a mesh that is not the world, and no GPU without device="cpu"
    for name, kw in (("world_size", dict(data=4, device="cpu")),
                     ("no_gpu", dict(data=2))):
        try:
            make_local_mesh(**kw)
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = (type(e).__name__, str(e))
    # a checkpoint of one step's state, for the restores at 1 and 4 ranks
    b, params, opt_state, rows = bundle(mesh)
    params, opt_state, _ = b.fn(params, opt_state, rows)
    shardings = {"params": b.shardings[0], "opt": b.shardings[1]}
    CheckpointManager(os.path.join(tmp, "ckpt2")).save(
        1, {"params": params, "opt": opt_state}, blocking=True,
        shardings=shardings, mesh=mesh)
    out["saved"] = state(mesh, b.shardings, params, opt_state)
    # the trainer: 6 steps against 3, killed, and 3 more after a restart
    full = _trainer(mesh, os.path.join(tmp, "ta"), 6)
    out["trainer_full"] = full.run()["final_step"]
    _trainer(mesh, os.path.join(tmp, "tb"), 3).run()
    resumed = _trainer(mesh, os.path.join(tmp, "tb"), 6)
    out["trainer_start"] = resumed.start_step
    resumed.run()
    out["kill_restart"] = (_trainer_state(full), _trainer_state(resumed))
    # SIGTERM on rank 1 only, after step 2: both ranks stop there
    t = _trainer(mesh, os.path.join(tmp, "tc"), 6)
    fn = t.step_fn

    def preempt(p, s, rows):
        res = fn(p, s, rows)
        if rank == 1 and int(res[1].step) == 2:
            signal.raise_signal(signal.SIGTERM)
        return res

    t.step_fn = preempt
    r = t.run()
    out["sigterm"] = (r["final_step"], r["preempted"],
                      t.ckpt.latest_step())
    return out if rank == 0 else None


def restored(mesh, ckpt: str) -> dict:
    """The world-2 checkpoint restored onto ``mesh``'s ranks, gathered."""
    b = steps.make_train_step(CFG, mesh, SHAPE, opt(), device="cpu",
                              dense_attn_max=DENSE)
    params, opt_state, _ = b.args
    got = CheckpointManager(ckpt).restore(
        1, {"params": params, "opt": opt_state},
        shardings={"params": b.shardings[0], "opt": b.shardings[1]},
        mesh=mesh)
    return state(mesh, b.shardings, got["params"], got["opt"])


def world4(rank: int, world: int, tmp: str, store1: str) -> dict | None:
    """The world-4 step and restore, then world 1 (rank 0 alone)."""
    from torch_dist import regroup

    mesh = make_local_mesh(world, 1, device="cpu")
    # FSDP over pod x data (2 x 2), ZeRO-1 over data: the moments' blocks
    # are not in rank order, so their collectives take the general path
    pod = Mesh(("pod", "data", "model"), (2, 2, 1), mesh.devices,
               rank=rank)
    out = {"step": one_step(mesh), "pod": one_step(pod),
           "restore4": restored(mesh, os.path.join(tmp, "ckpt2"))}
    if rank:
        return None
    regroup(store1, 0, 1)
    one = make_local_mesh(1, 1, device="cpu")
    out["step1"] = one_step(one)
    out["restore1"] = restored(one, os.path.join(tmp, "ckpt2"))
    return out
