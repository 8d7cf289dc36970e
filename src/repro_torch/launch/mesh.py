"""Device meshes for the dry-run and the launcher (counterpart of the
reference's ``repro.launch.mesh``): the production pods, which hold no
devices (the dry-run reasons about them without any), and the local mesh
over the visible cards or over a process group's ranks
(``distributed.mesh``, where :class:`Mesh` lives).
"""

from __future__ import annotations

from repro_torch.distributed.mesh import Mesh, make_local_mesh  # noqa: F401


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips a pod ``("data", "model")``; two pods = 512 chips
    with a leading ``"pod"`` axis. No devices: the dry-run's meshes."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))
