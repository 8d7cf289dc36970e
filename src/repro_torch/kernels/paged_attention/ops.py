"""Wrappers for ragged paged decode over the fused page pool and the
shape-derived chunk width.

- :func:`paged_flash_decode` runs ``csrc/paged_decode.cu`` over float
  (bf16) pages ``kv``.
- :func:`paged_flash_decode_mx` runs ``csrc/paged_decode_mx.cu`` over the
  quantized-resident MXFP4 mirrors ``quant``.
- :func:`ragged_paged_decode` is what ``layers.attention`` calls from the
  fused decode branch; it takes exactly one of ``kv=`` / ``quant=``.

CPU tensors take each kernel's plain version; CUDA tensors launch the
kernel or raise. Each of the two kernel wrappers counts its own launches
in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import mx as mxlib
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import (
    paged_flash_decode_mx_ref,
    paged_flash_decode_ref,
)
from repro_torch.obs.profile import profiled_call

BLOCK = mxlib.BLOCK
MAX_BK = 128
G_MAX = 16  # query heads per KV head the kernels hold in registers
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
_ARGTYPES_MX = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def pick_bk(w: int) -> int:
    """Chunk width for a page of ``w`` slots: a multiple of 32 capped at
    128; sub-32 pages stream whole. Part of the numerics (P quantizes per
    chunk on the mx path), so it matches the reference's choice."""
    if w < BLOCK:
        return w
    return min(MAX_BK, (w // BLOCK) * BLOCK)


def _check_shape(name: str, q, w: int, bk: int, n_kv: int) -> None:
    L, hkv, g, hd = q.shape
    if g > G_MAX or hd > 128 or hd % 2 or bk > min(MAX_BK, w) or hkv != n_kv:
        raise ValueError(f"{name} kernel: unsupported shape G={g} Dh={hd} "
                         f"bk={bk} W={w} Hkv={hkv}/{n_kv}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel: q must be bf16")


def _lane_ints(t, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _launch(q, kv, rows, lengths, scale: float, bk: int) -> torch.Tensor:
    L, hkv, g, hd = q.shape
    w = kv.shape[1]
    _check_shape("paged_decode", q, w, bk, kv.shape[2] // 2)
    if (kv.dtype != torch.bfloat16 or kv.device != q.device
            or not kv.is_contiguous() or kv.shape[3] != hd):
        raise ValueError(f"paged_decode: kv must be contiguous bf16 "
                         f"[P, W, 2Hkv, {hd}] on {q.device}")
    rows, lengths = _lane_ints(rows, q.device), _lane_ints(lengths, q.device)
    q = q.contiguous()
    out = torch.empty_like(q)
    fn = _build.function("paged_decode", "paged_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), kv.data_ptr(), rows.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), L, w, hkv, g, hd, bk, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    paged_flash_decode.launches += 1
    _build.check(err, "paged_decode")
    return out


def _launch_mx(q, quant, rows, lengths, scale: float, bk: int) -> torch.Tensor:
    L, hkv, g, hd = q.shape
    kvc, ke, ve = quant["kv_codes"], quant["k_exps"], quant["v_exps"]
    w, dpad = kvc.shape[1], 2 * kvc.shape[-1]
    _check_shape("paged_decode_mx", q, w, bk, kvc.shape[2] // 2)
    rows, lengths = _lane_ints(rows, q.device), _lane_ints(lengths, q.device)
    q = q.contiguous()
    for name, t in (("kv_codes", kvc), ("k_exps", ke), ("v_exps", ve)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode_mx: {name} must be contiguous on "
                             f"{q.device}")
    out = torch.empty_like(q)
    fn = _build.function("paged_decode_mx", "paged_decode_mx_launch",
                         _ARGTYPES_MX)
    table = mxlib.pair_table(str(q.device))
    err = fn(q.data_ptr(), kvc.data_ptr(), ke.data_ptr(), ve.data_ptr(),
             rows.data_ptr(), lengths.data_ptr(), table.data_ptr(),
             out.data_ptr(), L, w, hkv, g, hd, dpad, ve.shape[1], bk,
             scale, torch.cuda.current_stream(q.device).cuda_stream)
    paged_flash_decode_mx.launches += 1
    _build.check(err, "paged_decode_mx")
    return out


def paged_flash_decode(q, kv, rows, lengths, *, scale: float,
                       bk: int | None = None, obs=None) -> torch.Tensor:
    """q [L, Hkv, G, Dh] bf16, fused pages kv [P, W, 2Hkv, Dh] bf16, rows /
    lengths int [L] -> bf16 [L, Hkv, G, Dh]."""
    bk = bk or pick_bk(kv.shape[1])
    if q.device.type == "cpu":
        return profiled_call("paged_attention.ref", obs, lambda: (
            paged_flash_decode_ref(q, kv, rows, lengths, scale=scale, bk=bk)))
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    return profiled_call("paged_attention", obs,
                         lambda: _launch(q, kv, rows, lengths, scale, bk))


def paged_flash_decode_mx(q, quant, rows, lengths, *, scale: float,
                          bk: int | None = None, obs=None) -> torch.Tensor:
    """q [L, Hkv, G, Dh] (already MXFP4-fake-quant bf16), the fused code
    mirrors ``quant``, rows / lengths int [L] -> bf16 [L, Hkv, G, Dh]."""
    bk = bk or pick_bk(quant["kv_codes"].shape[1])
    if q.device.type == "cpu":
        return profiled_call(
            "paged_attention.mx.ref", obs,
            lambda: paged_flash_decode_mx_ref(
                q, quant["kv_codes"], quant["k_exps"], quant["v_exps"], rows,
                lengths, scale=scale, bk=bk))
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_mx: unsupported device "
                         f"{q.device}")
    return profiled_call("paged_attention.mx", obs,
                         lambda: _launch_mx(q, quant, rows, lengths, scale, bk))


def ragged_paged_decode(q, rows, lengths, *, kv=None, quant=None,
                        scale: float, bk: int | None = None,
                        obs=None) -> torch.Tensor:
    """Float pages (``kv=``) or quantized-resident mirrors (``quant=``);
    exactly one of the two."""
    if (kv is None) == (quant is None):
        raise ValueError("pass exactly one of kv= (float) or quant= (mx)")
    if kv is not None:
        return paged_flash_decode(q, kv, rows, lengths, scale=scale, bk=bk,
                                  obs=obs)
    return paged_flash_decode_mx(q, quant, rows, lengths, scale=scale, bk=bk,
                                 obs=obs)


paged_flash_decode.launches = 0
paged_flash_decode_mx.launches = 0
