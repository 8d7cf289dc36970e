"""PyTorch + CUDA (Hopper) port of the MXFormer reproduction.

Beside the JAX package ``repro``, which stays the reference. The port
imports no JAX and nothing of ``repro``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; kernel wrappers run their
plain PyTorch version only for CPU tensors.

Importing the package turns TF32 off for float32 matrix products and
convolutions, explicitly: the plain CIM datapath relies on exact integer
sums in f32, and the digital-SDPA emulation on exact products of
bf16-valued operands.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` or ``cuda``; raises if CUDA is asked for and missing (an
    entry point never carries on silently on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
