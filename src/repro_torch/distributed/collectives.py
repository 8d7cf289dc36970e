"""The sharded train step's collectives over ``torch.distributed``: the
port's counterpart of what XLA's GSPMD partitioner inserts into the
reference's step (``repro.launch.steps.make_train_step``), on the data
axes.

:class:`MeshComm` runs over the whole process group of a mesh made by
``distributed.mesh.make_local_mesh`` inside that group (one rank a device):

- :meth:`MeshComm.all_gather` and :meth:`MeshComm.reduce_scatter` along
  any dim. ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` cut
  dim 0 only, so a leaf cut on another dim (``wo``, ``w2``:
  ``('qkv_fused' | 'mlp', 'embed')``) has that dim moved to the front
  and made contiguous first, and moved back after;
- :meth:`MeshComm.all_reduce` (a sum, in place);
- :meth:`MeshComm.gather_leaf` / :meth:`MeshComm.reduce_leaf` (in f32):
  a leaf under its resolved spec. Where one dim is cut over the data
  axes, block r on rank r, it is the one collective along that dim, at
  world 1 too (a copy there); a spec that cuts nothing is the rank's
  own tensor (gather) or an all-reduce (reduce); any other layout
  gathers every rank's block (``sharding.assemble``) or all-reduces and
  keeps the rank's block.

:class:`LocalComm` has the same methods for one device without a group:
every leaf whole, every collective the identity. The train step
(``launch.steps``) runs one body over either.

Every call is recorded in a ``roofline.CollectiveStats`` under the
reference's kind names, its wire bytes a device from the ring model
(``roofline.ring_wire_bytes``). Barriers (:meth:`MeshComm.barrier`) are
not recorded: they are not the step's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.roofline import CollectiveStats
from repro_torch.distributed.mesh import DATA_AXES


def _all_gather_single(out, x):
    # the newer name where this torch has it (the older one warns there)
    fn = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    fn(out, x)


def _reduce_scatter_single(out, x):
    fn = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    fn(out, x)


class MeshComm:
    """Collectives over ``mesh``'s process group (the default group: the
    mesh spans the world), recorded in ``stats``."""

    def __init__(self, mesh, stats: CollectiveStats | None = None):
        if not mesh.distributed:
            raise ValueError("MeshComm needs a mesh over a process group "
                             "(distributed.mesh.make_local_mesh inside one)")
        self.mesh = mesh
        self.world = mesh.size
        self.stats = stats if stats is not None else CollectiveStats()

    def _record(self, kind: str, t: torch.Tensor) -> None:
        self.stats.add(kind, t.numel() * t.element_size(), self.world)

    # ------------------------------------------------------- along a dim

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order,
        contiguous."""
        front = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.world * front.shape[0],) + front.shape[1:],
                          dtype=x.dtype, device=x.device)
        _all_gather_single(out, front)
        self._record("all-gather", out)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum over ranks of ``x``, this rank's block along ``dim``
        (blocks in rank order), contiguous."""
        front = x.movedim(dim, 0).contiguous()
        if front.shape[0] % self.world:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.world} ranks")
        out = torch.empty((front.shape[0] // self.world,) + front.shape[1:],
                          dtype=x.dtype, device=x.device)
        _reduce_scatter_single(out, front)
        self._record("reduce-scatter", out)
        return out.movedim(0, dim).contiguous()

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, in place in ``x`` (returned)."""
        dist.all_reduce(x)
        self._record("all-reduce", x)
        return x

    def barrier(self) -> None:
        """Every rank has reached this point (not recorded)."""
        dist.all_reduce(torch.zeros(1, device=self.mesh.device))

    # ------------------------------------------------------- under a spec

    def rank_dim(self, spec: tuple, ndim: int) -> int | None:
        """The dim a leaf of ``ndim`` dims under ``spec`` is cut on over
        the data axes, every rank in rank order (block r on rank r), or
        None. At world 1 that is the dim the spec names a data axis on."""
        for d in range(ndim):
            axes = shd.dim_axes(spec[d] if d < len(spec) else None)
            if any(a in DATA_AXES for a in axes) and all(
                    shd.shard_index(spec, d, self.mesh, r) == (r, self.world)
                    for r in range(self.world)) and all(
                    shd.shard_index(spec, e, self.mesh)[1] == 1
                    for e in range(ndim) if e != d):
                return d
        return None

    def _cut(self, spec: tuple, ndim: int) -> bool:
        return any(shd.shard_index(spec, d, self.mesh)[1] > 1
                   for d in range(ndim))

    def gather_leaf(self, shard: torch.Tensor, spec: tuple, shape
                    ) -> torch.Tensor:
        """The global leaf of ``shape`` from this rank's block under the
        resolved ``spec`` (every rank calls it)."""
        d = self.rank_dim(spec, len(shape))
        if d is not None:
            return self.all_gather(shard, d)
        if not self._cut(spec, len(shape)):
            return shard
        flat = self.all_gather(shard.reshape(1, -1), 0)
        return shd.assemble([b.reshape(shard.shape) for b in flat], spec,
                            shape, self.mesh)

    def reduce_leaf(self, full: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block, under the resolved ``spec``, of the sum over
        ranks of ``full``, in f32 (every rank calls it)."""
        full = full.to(torch.float32)
        d = self.rank_dim(spec, full.ndim)
        if d is not None:
            return self.reduce_scatter(full, d)
        self.all_reduce(full)
        if not self._cut(spec, full.ndim):
            return full
        return shd.take_shard(full, spec, self.mesh)

    def shard(self, full: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of ``full`` under ``spec`` (no collective;
        differentiable)."""
        return shd.take_shard(full, spec, self.mesh)

    def owns(self, spec: tuple) -> bool:
        """Whether this rank counts its block in a sum over ranks."""
        return shd.owns(spec, self.mesh)


class LocalComm:
    """:class:`MeshComm`'s methods on one device: every leaf whole, every
    collective the identity, nothing recorded."""

    stats = None

    def gather_leaf(self, shard, spec, shape):
        return shard

    def reduce_leaf(self, full, spec):
        return full

    def all_reduce(self, x):
        return x

    def shard(self, full, spec):
        return full

    def owns(self, spec) -> bool:
        return True
