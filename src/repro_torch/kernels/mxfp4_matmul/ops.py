"""Wrapper for the packed-MXFP4 dequant-matmul kernel
(``csrc/mxfp4_matmul.cu``): ``x @ dequant(codes, exps)`` with the weights
expanded only in registers.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise. ``mxfp4_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mxfp4_matmul.ref import mxfp4_matmul_ref
from repro_torch.obs.profile import profiled_call

BM_SMALL, BM = 4, 8  # the kernel's row tiles (M <= 4: decode lanes)
COLS = 128  # output columns per block: 32 lanes x 4
KB_PER_STEP = 8  # 32-row K blocks per block step (one per warp)
TARGET_BLOCKS = 4 * 132  # four blocks per H100 SM before K is split
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def pick_splits(m: int, k: int, n: int) -> int:
    """Split K over this many blocks when the output tiles alone are too
    few to fill the card; each split keeps at least one block step."""
    bm = BM_SMALL if m <= BM_SMALL else BM
    tiles = -(-m // bm) * -(-n // COLS)
    if tiles >= TARGET_BLOCKS:
        return 1
    nkb = k // 32
    return max(1, min(-(-TARGET_BLOCKS // tiles), nkb // KB_PER_STEP))


def _launch(xm: torch.Tensor, codes: torch.Tensor,
            exps: torch.Tensor) -> torch.Tensor:
    m, k = xm.shape
    n = codes.shape[1]
    if n % 4:
        raise ValueError(f"mxfp4_matmul kernel needs N % 4 == 0, got N={n}")
    if xm.dtype not in (torch.bfloat16, torch.float32):
        xm = xm.to(torch.float32)
    xm = xm.contiguous()
    for t, name in ((codes, "codes"), (exps, "exps")):
        if (t.device != xm.device or t.dtype != torch.uint8
                or not t.is_contiguous()):
            raise ValueError(f"mxfp4_matmul: {name} must be contiguous uint8 "
                             f"on {xm.device}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xm.device)
    if m == 0:
        return out
    splits = pick_splits(m, k, n)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=xm.device) if splits > 1 else out)
    fn = _build.function("mxfp4_matmul", "mxfp4_matmul_launch", _ARGTYPES)
    err = fn(xm.data_ptr(), codes.data_ptr(), exps.data_ptr(),
             out.data_ptr(), partial.data_ptr(), m, k, n, splits,
             int(xm.dtype == torch.bfloat16),
             torch.cuda.current_stream(xm.device).cuda_stream)
    mxfp4_matmul.launches += 1
    _build.check(err, "mxfp4_matmul")
    return out


def mxfp4_matmul(x: torch.Tensor, codes: torch.Tensor, exps: torch.Tensor,
                 *, obs=None) -> torch.Tensor:
    """x [..., K] @ dequant(codes [K//2, N], exps [K//32, N]) -> bf16
    [..., N], f32 accumulation."""
    k = x.shape[-1]
    n = codes.shape[1]
    if k % 32 or codes.shape != (k // 2, n) or exps.shape != (k // 32, n):
        raise ValueError(f"mxfp4_matmul: x [..., {k}] does not match codes "
                         f"{tuple(codes.shape)} / exps {tuple(exps.shape)}")
    xm = x.reshape(-1, k)
    if x.device.type == "cpu":
        out = profiled_call("mxfp4_matmul.ref", obs,
                            lambda: mxfp4_matmul_ref(xm, codes, exps))
    elif x.device.type == "cuda":
        out = profiled_call("mxfp4_matmul", obs,
                            lambda: _launch(xm, codes, exps))
    else:
        raise ValueError(f"mxfp4_matmul: unsupported device {x.device}")
    return out.reshape(x.shape[:-1] + (n,))


mxfp4_matmul.launches = 0
