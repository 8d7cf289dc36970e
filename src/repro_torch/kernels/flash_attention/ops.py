"""Wrapper for the tiled online-softmax attention kernel
(``csrc/flash_attention.cu``) in the ``[B, S, H, D]`` layout of
``repro.kernels.flash_attention.ops.flash_attention``.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise. The kernel has two routes, picked by :func:`pick_route`
from dtype and head_dim alone: ``"wgmma"`` (bf16 tensor cores for both
products, bf16 with D in ``TC_D``) and ``"fma"`` (f32 on the CUDA cores:
f32 inputs, other D). ``flash_attention.launches`` counts wrapper
launches, one per call; ``flash_attention.route_launches`` counts them by
route.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.obs.profile import profiled_call

D_MAX = 256  # head_dim the fma route holds per thread tile
TC_D = (64, 128)  # head_dims of the wgmma route (whole 64-value tiles)
ROUTES = ("fma", "wgmma")
# q, k, v, out, B, Sq, Sk, H, Hkv, D, scale, causal, window, q_offset, then
# is_bf16 (fma route only), stream
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [
    ctypes.c_int] * 3


def pick_route(sq: int, sk: int, d: int, dtype: torch.dtype) -> str:
    """``"wgmma"`` for bf16 with head_dim in ``TC_D``, else ``"fma"``; the
    tensor-core kernel masks ragged ``sq`` and ``sk`` itself, so the
    lengths do not decide. f32 stays on ``"fma"``: rounding q, k or v to
    bf16 would change the function."""
    del sq, sk
    return "wgmma" if dtype == torch.bfloat16 and d in TC_D else "fma"


def _launch(q, k, v, causal: bool, window: int, q_offset: int,
            route: str | None = None):
    """Launch the kernel on ``route`` (default :func:`pick_route`); a
    caller names it only to time both routes on one shape
    (``chip_smoke.py``)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} (f32 or "
                         "bf16)")
    for t, name in ((k, "k"), (v, "v")):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} on "
                             f"{q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    route = route or pick_route(sq, sk, d, q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "wgmma":
        if q.dtype != torch.bfloat16 or d not in TC_D:
            raise ValueError(f"flash_attention: the wgmma route takes bf16 "
                             f"with head_dim in {TC_D}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: the wgmma route needs 16-byte "
                             "aligned q, k and v")
        fn = _build.function("flash_attention", "flash_attention_tc_launch",
                             _ARGS + [ctypes.c_void_p])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 sq, sk, h, hkv, d, d ** -0.5, int(causal), window, q_offset,
                 stream)
    else:
        if d > D_MAX:
            raise ValueError(f"flash_attention kernel: head_dim {d} > "
                             f"{D_MAX}")
        fn = _build.function("flash_attention", "flash_attention_launch",
                             _ARGS + [ctypes.c_int, ctypes.c_void_p])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 sq, sk, h, hkv, d, d ** -0.5, int(causal), window, q_offset,
                 int(q.dtype == torch.bfloat16), stream)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    _build.check(err, "flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    obs=None) -> torch.Tensor:
    """q [B, Sq, H, D], k / v [B, Sk, Hkv, D] -> [B, Sq, H, D] in q's
    dtype; f32 softmax and sums, GQA by ``h // (H // Hkv)``. The wgmma
    route rounds P to bf16 for the PV product."""
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
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
