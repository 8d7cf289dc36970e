"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel package holds ``ref.py`` (the plain version of the kernel's
own function) and ``ops.py`` (the wrapper). A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the
CUDA kernel from ``repro_torch/csrc`` (built by :mod:`._build`) or
raises. Every wrapper keeps a plain integer ``launches`` counter that it
bumps where it launches its kernel.
"""

import contextlib
import contextvars

_scratch_slot = contextvars.ContextVar("kernel_scratch_slot", default=None)


@contextlib.contextmanager
def scratch_slot(key):
    """Give the launches inside the block their own set of the wrappers'
    per-device scratch (``cim_linear``'s splitk workspace,
    ``mxfp4_matmul``'s mma arrival counters), keyed by ``key``. A wrapper
    leaves its scratch zero at rest and reuses it launch after launch on
    one stream; launches that may run at once on two streams of one card
    (two pipeline stages) each need their own."""
    token = _scratch_slot.set(key)
    try:
        yield
    finally:
        _scratch_slot.reset(token)


def scratch_key(dev):
    """The key of the scratch a launch on ``dev`` uses: the device and the
    enclosing :func:`scratch_slot` (None outside one)."""
    return (dev, _scratch_slot.get())
