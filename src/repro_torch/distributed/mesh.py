"""The device mesh of the port: named axes over devices, and over the
ranks of a ``torch.distributed`` process group.

A :class:`Mesh` names its axes and their sizes, as the reference's
``jax.sharding.Mesh`` does for the rules that read it (``axis_names``,
``shape``, ``size``). A mesh may hold no devices (the dry-run's
production meshes, ``launch.mesh``); a local mesh holds
``torch.device``s, and at (1, 1) it is the one card.

Inside an initialised process group the local mesh is a mesh over the
group's ranks, one device a rank, row-major over the axes, and knows its
own ``rank`` (the counterpart of ``jax.devices()`` being global in a
multi-process JAX run): ``launch.steps`` then builds the sharded train
step over it (``collectives``). :func:`data_size` and :func:`data_rank`
read the data axes (``pod``, ``data``), :func:`model_size` and
:func:`model_rank` the ``model`` axis.

A mesh over a group carries its per-axis process subgroups
(:func:`axis_group`): this rank's data column (the ranks of its model
coordinate, in data-rank order) and its model row (the ranks of its data
coordinates). An axis of size 1 needs none, one that spans the group is
the whole group, and a 2-D mesh makes one subgroup for each data column
and one for each model row when it is made (:func:`make_group_mesh`):
every rank creates every subgroup, in the same order, as NCCL requires.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple
    devices: tuple = ()  # torch.devices, row-major over the axes, or none
    rank: int | None = None  # this process's rank: a mesh over a group
    # "data" / "model" -> this rank's subgroup on that axis, where the
    # axis is neither of size 1 nor the whole group (make_group_mesh)
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.sizes}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")
        if self.rank is not None and not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} on a mesh of {self.size}")

    @property
    def distributed(self) -> bool:
        """A mesh over a process group: one rank a device."""
        return self.rank is not None

    @property
    def device(self) -> torch.device:
        """This rank's device (the first device of a mesh without ranks)."""
        return self.devices[self.rank or 0]

    def coords(self, rank: int | None = None) -> dict:
        """Axis name -> coordinate of ``rank`` (default this process's, or
        0 on a mesh without ranks), row-major over the axes."""
        r = (self.rank or 0) if rank is None else rank
        out = {}
        for name, size in reversed(tuple(zip(self.axis_names, self.sizes))):
            out[name] = r % size
            r //= size
        return {a: out[a] for a in self.axis_names}

    @property
    def shape(self) -> dict:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def name(self) -> str:
        """``16x16``, ``2x16x16``, ... (the dry-run's ``mesh`` key)."""
        return "x".join(str(s) for s in self.sizes)


DATA_AXES = ("pod", "data")


def data_size(mesh: Mesh) -> int:
    """The product of the mesh's data axes (``pod``, ``data``)."""
    n = 1
    for a in DATA_AXES:
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def data_rank(mesh: Mesh) -> int:
    """This rank's place on the data axes, row-major (``pod``, ``data``)."""
    r, coords = 0, mesh.coords()
    for a in DATA_AXES:
        if a in mesh.axis_names:
            r = r * mesh.shape[a] + coords[a]
    return r


def model_size(mesh: Mesh) -> int:
    """The size of the mesh's ``model`` axis (1 without one)."""
    return mesh.shape.get("model", 1)


def model_rank(mesh: Mesh) -> int:
    """This rank's coordinate on the ``model`` axis."""
    return mesh.coords().get("model", 0)


def axis_members(mesh: Mesh, kind: str, rank: int | None = None) -> tuple:
    """The ranks of ``rank``'s subgroup on ``kind`` (``data``: the ranks
    of its model coordinate, in data-rank order; ``model``: the ranks of
    its data coordinates, in model order), ascending either way."""
    own = mesh.coords(rank)
    keep = DATA_AXES if kind == "model" else ("model",)
    return tuple(r for r in range(mesh.size)
                 if all(mesh.coords(r)[a] == own[a] for a in keep
                        if a in mesh.axis_names))


def axis_group(mesh: Mesh, kind: str):
    """This rank's process group on ``kind`` (``data`` or ``model``): None
    for an axis of size 1 (its collectives are copies), the whole group
    for an axis as large as the mesh, else the subgroup made with the
    mesh (:func:`make_group_mesh`)."""
    size = data_size(mesh) if kind == "data" else model_size(mesh)
    if size == mesh.size:
        return dist.group.WORLD
    if size == 1:
        return None
    if kind not in mesh.groups:
        raise ValueError(f"a {mesh.name} mesh over a group needs its {kind} "
                         "subgroups: make it with make_group_mesh")
    return mesh.groups[kind]


def _subgroups(mesh: Mesh) -> dict:
    """Every data column's and every model row's group, made in one fixed
    order on every rank; this rank's two."""
    out = {}
    for kind in ("data", "model"):
        seen = []
        for r in range(mesh.size):
            members = axis_members(mesh, kind, r)
            if members in seen:
                continue
            seen.append(members)
            group = dist.new_group(list(members))
            if mesh.rank in members:
                out[kind] = group
    return out


def make_group_mesh(axis_names: tuple, sizes: tuple, device=None) -> Mesh:
    """A mesh of ``axis_names`` x ``sizes`` over the initialised process
    group's ranks, one device a rank: ``cuda:LOCAL_RANK`` (rank r on
    ``cuda:(r % LOCAL_WORLD_SIZE)``, torchrun's layout; without those
    variables one host with one rank a card), or ``device`` (``"cpu"``
    over gloo). It raises unless the mesh's size is the world size, and
    without a GPU unless ``device`` is given. With data and model axes
    both larger than 1 every rank makes every per-axis subgroup
    (:func:`axis_group`) here."""
    n = 1
    for s in sizes:
        n *= s
    world, rank = dist.get_world_size(), dist.get_rank()
    name = "x".join(str(s) for s in sizes)
    if n != world:
        raise ValueError(f"a {name} mesh over a group of {world} ranks: its "
                         f"size must be the world size ({n} ranks)")
    if device is not None:
        devices = (torch.device(device),) * n
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for "
                               "a mesh of CPU ranks")
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                      torch.cuda.device_count()))
        devices = tuple(torch.device("cuda", r % per_host) for r in range(n))
        local = int(os.environ.get("LOCAL_RANK", rank % per_host))
        if devices[rank] != torch.device("cuda", local):
            raise ValueError(f"rank {rank} is LOCAL_RANK {local}, not "
                             f"{devices[rank]}")
    mesh = Mesh(tuple(axis_names), tuple(sizes), devices, rank=rank)
    if 1 < data_size(mesh) < n:
        mesh.groups.update(_subgroups(mesh))
    return mesh


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``data`` x ``model`` mesh over the visible CUDA devices (or
    ``device`` repeated: ``"cpu"`` in tests, ``"meta"`` for a dry-run that
    holds no memory). At (1, 1) it is the one card.

    Inside an initialised process group (and ``device`` not ``meta``) it
    is a mesh over the group's ranks, ``data * model`` of them, one device
    a rank: ``cuda:LOCAL_RANK`` (rank r on ``cuda:(r % LOCAL_WORLD_SIZE)``,
    torchrun's layout; without those variables one host with one rank a
    card), or ``device`` (``"cpu"`` over gloo), with its per-axis
    subgroups (:func:`make_group_mesh`). It raises unless ``data * model``
    is the world size, and without a GPU unless ``device`` is given."""
    n = data * model
    if (dist.is_available() and dist.is_initialized()
            and (device is None or torch.device(device).type != "meta")):
        return make_group_mesh(("data", "model"), (data, model), device)
    if device is not None:
        devices = (torch.device(device),) * n
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(f"a {data}x{model} mesh needs {n} CUDA devices, "
                             f"have {have} (pass device='cpu' or 'meta')")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    return Mesh(("data", "model"), (data, model), devices)
