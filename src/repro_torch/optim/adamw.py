"""AdamW with global-norm clipping and a warmup-cosine schedule, the
reference's ``repro.optim.adamw`` in float32.

The state is a plain tree (``OptState``: step, m, v) of the parameters'
layout, so it checkpoints like them. :func:`apply` updates the
parameters and both moments in place, under ``torch.no_grad()``, and
returns them: at full width the state is three copies of the f32
parameters, and the update needs no fourth. The values are the
reference's, leaf by leaf, with one exception stated at
:func:`global_norm`.

The sharded train step (``launch.steps`` on a mesh over a process group)
runs :func:`apply` on each rank's blocks in the moments' layout: the
update is element-wise, so a block updates as the whole would; only the
clipping's global norm spans the ranks (``owned``, ``all_reduce``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # [] int32
    m: dict
    v: dict


def tree_map(tree, fn):
    """``fn`` of each tensor of a tree of dicts and lists, in its layout."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(v, fn) for v in tree]
    return fn(tree)


def leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in the tree's own order
    (dict insertion order)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (f32 []): linear warmup, then cosine decay
    to ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init(params) -> OptState:
    """Step 0 and zero moments (f32) of the parameters' layout, on their
    devices."""
    dev = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(params, zeros), v=tree_map(params, zeros))


def global_norm(tree, owned=None, all_reduce=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32. The leaves are
    summed in the tree's order, one leaf per layer; the reference sums its
    layer-stacked leaves in sorted-key order, so the two agree to f32
    rounding, not bitwise.

    Over a sharded tree (each rank holding blocks of the leaves) every
    rank sums the squares of the blocks it counts (``owned``, one bool a
    leaf: a block replicated on several ranks, over the data axes or over
    ``model``, counts on one of them, ``distributed.sharding.owns``) and
    ``all_reduce`` sums the ranks' totals in place over every rank, one
    collective for the whole tree."""
    total = None
    flat = leaves(tree)
    for x, own in zip(flat, owned if owned is not None else [True] * len(
            flat)):
        if not own:
            continue
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    if all_reduce is not None:
        all_reduce(total)
    return torch.sqrt(total)


def apply(cfg: AdamWConfig, params, grads, state: OptState, ndims=None,
          owned=None, all_reduce=None) -> tuple[dict, OptState, dict]:
    """One AdamW step: returns (params, new state, metrics ``grad_norm``
    and ``lr``). ``params``, ``state.m`` and ``state.v`` are updated in
    place and returned; ``grads`` may be any float dtype. Weight decay
    applies to leaves of two or more dims *in the reference's tree*:
    ``ndims`` is that tree of ints (``models.lm.ref_ndim_tree``; None
    reads each leaf's own ndim, for a tree without stacked segments).
    On a rank's blocks, ``owned`` and ``all_reduce`` make the clipping's
    norm global (:func:`global_norm`)."""
    gnorm = global_norm(grads, owned, all_reduce)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    bc1 = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))
    flat_n = (leaves(ndims) if ndims is not None
              else [p.ndim for p in leaves(params)])
    with torch.no_grad():
        for p, g, m, v, nd in zip(leaves(params), leaves(grads),
                                  leaves(state.m), leaves(state.v), flat_n):
            g = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = p.to(torch.float32)
            if nd >= 2:
                upd = upd + cfg.weight_decay * pf
            p.copy_(pf - lr * upd)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}
