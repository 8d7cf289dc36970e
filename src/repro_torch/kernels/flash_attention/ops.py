"""Wrapper for the tiled online-softmax attention kernel
(``csrc/flash_attention.cu``) in the ``[B, S, H, D]`` layout of
``repro.kernels.flash_attention.ops.flash_attention``.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise. ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.obs.profile import profiled_call

D_MAX = 128  # head_dim the kernel holds per thread tile
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [
    ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch(q, k, v, causal: bool, window: int, q_offset: int):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d > D_MAX:
        raise ValueError(f"flash_attention kernel: head_dim {d} > {D_MAX}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} (f32 or "
                         "bf16)")
    for t, name in ((k, "k"), (v, "v")):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} on "
                             f"{q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
             sk, h, hkv, d, d ** -0.5, int(causal), window, q_offset,
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    _build.check(err, "flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    obs=None) -> torch.Tensor:
    """q [B, Sq, H, D], k / v [B, Sk, Hkv, D] -> [B, Sq, H, D] in q's
    dtype; f32 arithmetic, GQA by ``h // (H // Hkv)``."""
    b, sq, h, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or h % k.shape[2]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return profiled_call("flash_attention.ref", obs, lambda: (
            flash_attention_ref(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return profiled_call("flash_attention", obs,
                         lambda: _launch(q, k, v, causal, window, q_offset))


flash_attention.launches = 0
