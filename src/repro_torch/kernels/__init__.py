"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel package holds ``ref.py`` (the plain version of the kernel's
own function) and ``ops.py`` (the wrapper). A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the
CUDA kernel from ``repro_torch/csrc`` (built by :mod:`._build`) or
raises. Every wrapper keeps a plain integer ``launches`` counter that it
bumps where it launches its kernel.
"""
