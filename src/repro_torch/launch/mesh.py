"""Device meshes for the dry-run and the sharding rules (counterpart of
the reference's ``repro.launch.mesh``).

A :class:`Mesh` names its axes and their sizes, as the reference's
``jax.sharding.Mesh`` does for the rules that read it (``axis_names``,
``shape``, ``size``). The production meshes are the reference's pods and
hold no devices: the dry-run reasons about them without any. The local
mesh holds ``torch.device``s; at (1, 1) it is the one card.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple
    devices: tuple = ()  # torch.devices, row-major over the axes, or none

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.sizes}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips a pod ``("data", "model")``; two pods = 512 chips
    with a leading ``"pod"`` axis. No devices: the dry-run's meshes."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``data`` x ``model`` mesh over the visible CUDA devices (or
    ``device`` repeated: ``"cpu"`` in tests, ``"meta"`` for a dry-run that
    holds no memory). At (1, 1) it is the one card."""
    n = data * model
    if device is not None:
        devices = (torch.device(device),) * n
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(f"a {data}x{model} mesh needs {n} CUDA devices, "
                             f"have {have} (pass device='cpu' or 'meta')")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    return Mesh(("data", "model"), (data, model), devices)
