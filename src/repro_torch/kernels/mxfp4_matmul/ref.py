"""Plain PyTorch version of the packed-MXFP4 dequant-matmul kernel
(counterpart of ``repro.kernels.mxfp4_matmul.ref``).

Layout: codes [K//2, N] uint8, two E2M1 nibbles per byte along K (even
row in the low nibble); exps [K//32, N] uint8, biased E8M0.

The E8M0 floor: the reference builds the block scale as ``0.5 * 2^(b-127)``
and runs where subnormals flush to zero (XLA on the CPU, the TPU). There
a biased exponent ``b <= 1`` gives a scale of zero. :func:`half_scale`
writes that flush out, so the port gives the reference's values on every
block without depending on the floating-point environment.
"""

from __future__ import annotations

import torch

from repro_torch.core import mx as mxlib

BLOCK = mxlib.BLOCK


def half_scale(exps: torch.Tensor) -> torch.Tensor:
    """Biased E8M0 uint8 -> f32 ``0.5 * 2^(b-127)``; 0 for ``b <= 1``
    (the reference's subnormal results, flushed)."""
    b = exps.to(torch.int32)
    scale = 0.5 * mxlib._f32_from_field(b)  # 2^(b-127) by its IEEE field
    return torch.where(b <= 1, torch.zeros((), device=b.device), scale)


def dequant_ref(codes: torch.Tensor, exps: torch.Tensor) -> torch.Tensor:
    """packed uint8 [K//2, N] + biased uint8 [K//32, N] -> f32 [K, N]."""
    c = mxlib.unpack_codes(codes.T).T.to(torch.float32)  # 2x the FP4 value
    k, n = c.shape
    return (c.reshape(k // BLOCK, BLOCK, n)
            * half_scale(exps)[:, None, :]).reshape(k, n)


def mxfp4_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                     exps: torch.Tensor,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [M, K] @ dequant(codes, exps) in f32 -> [M, N] of ``out_dtype``
    (the reference's ``out_dtype``: bf16, or f32 as it is)."""
    return torch.matmul(x.to(torch.float32),
                        dequant_ref(codes, exps)).to(out_dtype)
