"""The sharded train step's collectives over ``torch.distributed``: the
port's counterpart of what XLA's GSPMD partitioner inserts into the
reference's step (``repro.launch.steps.make_train_step``), on the data
axes and on the ``model`` axis.

:class:`AxisComm` runs one mesh axis's collectives over that axis's
process group (``distributed.mesh.axis_group``: this rank's data column
or model row, the whole group, or none for an axis of size 1, where each
collective is a copy):

- :meth:`AxisComm.all_gather` and :meth:`AxisComm.reduce_scatter` along
  any dim. ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` cut
  dim 0 only, so a leaf cut on another dim (``wo``, ``w2``:
  ``('qkv_fused' | 'mlp', 'embed')``) has that dim moved to the front
  and made contiguous first, and moved back after;
- :meth:`AxisComm.all_reduce` (a sum or a max, in place).

:class:`MeshComm` holds a mesh's ``data`` and ``model`` axes and the
whole group (``world``), and works on leaves under their resolved specs:

- :meth:`MeshComm.gather_shard` / :meth:`MeshComm.reduce_leaf` (in f32):
  over the data axes only, between the rank's block and its *model
  shard* (the global leaf cut on ``model`` alone). Where one dim is cut
  over the data axes, block r on data rank r, it is the one collective
  along that dim, at data size 1 too (a copy there); a spec that cuts no
  dim over them is the rank's own tensor (gather) or an all-reduce
  (reduce); any other layout gathers every data rank's block
  (``sharding.assemble``) or all-reduces and keeps the rank's block;
- :meth:`MeshComm.gather_leaf`: the global leaf (the data axes, then
  ``model``), for checkpoints;
- :meth:`MeshComm.owns`: whether the rank counts its block in a sum over
  the world (a clipping norm).

The model axis's layers run over :attr:`MeshComm.model` through the
autograd functions of ``tensor_parallel``.

:class:`LocalComm` has :class:`MeshComm`'s methods for one device
without a group: every leaf whole, every collective the identity, no
model axis. The train step (``launch.steps``) runs one body over either.

Every call is recorded in a ``roofline.CollectiveStats`` under the
reference's kind names, and in its axis's own (:attr:`MeshComm.by_axis`:
``data``, ``model``, ``world``), its wire bytes a device from the ring
model over that axis's group size (``roofline.ring_wire_bytes``).
Barriers (:meth:`MeshComm.barrier`) are not recorded: they are not the
step's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.mesh import (
    axis_group,
    data_rank,
    data_size,
    model_rank,
    model_size,
)
from repro_torch.distributed.roofline import CollectiveStats


def _all_gather_single(out, x, group):
    # the newer name where this torch has it (the older one warns there)
    fn = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    fn(out, x, group=group)


def _reduce_scatter_single(out, x, group):
    fn = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    fn(out, x, group=group)


class AxisComm:
    """Collectives over one axis's ``group`` of ``size`` ranks (this rank
    ``rank`` on it; ``group`` None at size 1: copies), recorded in
    ``stats`` (the mesh's, every axis) and in ``own`` (this axis's)."""

    def __init__(self, group, size: int, rank: int, stats: CollectiveStats):
        self.group, self.size, self.rank = group, size, rank
        self.stats, self.own = stats, CollectiveStats()

    def _record(self, kind: str, t: torch.Tensor) -> None:
        for st in (self.stats, self.own):
            st.add(kind, t.numel() * t.element_size(), self.size)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order,
        contiguous."""
        front = x.movedim(dim, 0).contiguous()
        if self.group is None:
            out = front.clone()
        else:
            out = torch.empty((self.size * front.shape[0],)
                              + front.shape[1:], dtype=x.dtype,
                              device=x.device)
            _all_gather_single(out, front, self.group)
        self._record("all-gather", out)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum over ranks of ``x``, this rank's block along ``dim``
        (blocks in rank order), contiguous."""
        front = x.movedim(dim, 0).contiguous()
        if front.shape[0] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.size} ranks")
        if self.group is None:
            out = front.clone()
        else:
            out = torch.empty((front.shape[0] // self.size,)
                              + front.shape[1:], dtype=x.dtype,
                              device=x.device)
            _reduce_scatter_single(out, front, self.group)
        self._record("reduce-scatter", out)
        return out.movedim(0, dim).contiguous()

    def all_reduce(self, x: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The sum (or ``op``) over ranks, in place in ``x`` (returned)."""
        if self.group is not None:
            dist.all_reduce(x, op=op, group=self.group)
        self._record("all-reduce", x)
        return x

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (no collective)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)


class MeshComm:
    """Collectives over ``mesh``'s process group (the default group: the
    mesh spans the world) and its per-axis subgroups, recorded in
    ``stats``."""

    def __init__(self, mesh, stats: CollectiveStats | None = None):
        if not mesh.distributed:
            raise ValueError("MeshComm needs a mesh over a process group "
                             "(distributed.mesh.make_local_mesh inside one)")
        self.mesh = mesh
        self.stats = stats if stats is not None else CollectiveStats()
        self.data = AxisComm(axis_group(mesh, "data"), data_size(mesh),
                             data_rank(mesh), self.stats)
        self.model = AxisComm(axis_group(mesh, "model"), model_size(mesh),
                              model_rank(mesh), self.stats)
        self.world = AxisComm(dist.group.WORLD, mesh.size, mesh.rank,
                              self.stats)
        # axis -> its collectives (the step's bundle reports them)
        self.by_axis = {"data": self.data.own, "model": self.model.own,
                        "world": self.world.own}
        # the data axes as a mesh of their own (data rank r is its rank
        # r): the data part of a spec cuts a model shard over it
        names = tuple(a for a in mesh.axis_names if a != "model")
        self._dmesh = type(mesh)(names, tuple(mesh.shape[a] for a in names),
                                 rank=self.data.rank)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over every rank, in place (a clipping norm's)."""
        return self.world.all_reduce(x)

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data ranks, in place (a loss, mask counts)."""
        return self.data.all_reduce(x)

    def barrier(self) -> None:
        """Every rank has reached this point (not recorded)."""
        dist.all_reduce(torch.zeros(1, device=self.mesh.device))

    # ------------------------------------------------------- under a spec

    def _data_spec(self, spec: tuple) -> tuple:
        return shd.drop_axis(spec, "model")

    def rank_dim(self, spec: tuple, ndim: int) -> int | None:
        """The dim a leaf of ``ndim`` dims under ``spec`` is cut on over
        the data axes, every data rank in order (block r on data rank r),
        with no other dim cut over them; or None. At data size 1 that is
        the dim the spec names a data axis on."""
        spec, dm = self._data_spec(spec), self._dmesh
        for d in range(ndim):
            if shd.dim_axes(spec[d] if d < len(spec) else None) and all(
                    shd.shard_index(spec, d, dm, r) == (r, self.data.size)
                    for r in range(self.data.size)) and all(
                    shd.shard_index(spec, e, dm)[1] == 1
                    for e in range(ndim) if e != d):
                return d
        return None

    def _cut(self, spec: tuple, ndim: int) -> bool:
        spec = self._data_spec(spec)
        return any(shd.shard_index(spec, d, self._dmesh)[1] > 1
                   for d in range(ndim))

    def gather_shard(self, block: torch.Tensor, spec: tuple, shape
                     ) -> torch.Tensor:
        """This rank's model shard of the global leaf of ``shape`` from its
        block under the resolved ``spec``: a gather over the data axes
        (every rank calls it)."""
        shape = shd.model_shard_shape(spec, shape, self.mesh)
        d = self.rank_dim(spec, len(shape))
        if d is not None:
            return self.data.all_gather(block, d)
        if not self._cut(spec, len(shape)):
            return block
        flat = self.data.all_gather(block.reshape(1, -1), 0)
        return shd.assemble([b.reshape(block.shape) for b in flat],
                            self._data_spec(spec), shape, self._dmesh)

    def gather_leaf(self, block: torch.Tensor, spec: tuple, shape
                    ) -> torch.Tensor:
        """The global leaf of ``shape`` from this rank's block under the
        resolved ``spec``: over the data axes, then over ``model`` (every
        rank calls it)."""
        part = self.gather_shard(block, spec, shape)
        d = shd.model_dim(spec)
        return part if d is None else self.model.all_gather(part, d)

    def reduce_leaf(self, full: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block, under the resolved ``spec``, of the sum over
        the data ranks of ``full`` (a model shard), in f32 (every rank
        calls it). A leaf replicated over ``model`` has the same gradient
        on every model rank: it is not summed over them."""
        full = full.to(torch.float32)
        d = self.rank_dim(spec, full.ndim)
        if d is not None:
            return self.data.reduce_scatter(full, d)
        self.data.all_reduce(full)
        if not self._cut(spec, full.ndim):
            return full
        return self.shard(full, spec)

    def shard(self, full: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of the model shard ``full`` under ``spec`` (no
        collective; differentiable)."""
        return shd.take_shard(full, self._data_spec(spec), self._dmesh)

    def owns(self, spec: tuple) -> bool:
        """Whether this rank counts its block in a sum over the world."""
        return shd.owns(spec, self.mesh)


class LocalComm:
    """:class:`MeshComm`'s methods on one device: every leaf whole, every
    collective the identity, nothing recorded."""

    stats = None

    def gather_shard(self, block, spec, shape):
        return block

    def reduce_leaf(self, full, spec):
        return full

    def all_reduce(self, x, op=None):
        return x

    def all_gather(self, x, dim=0):
        return x

    def sum_data(self, x):
        return x

    def shard(self, full, spec):
        return full

    def owns(self, spec) -> bool:
        return True
