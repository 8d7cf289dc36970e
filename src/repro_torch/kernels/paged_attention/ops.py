"""Wrapper for ragged paged decode (``csrc/paged_decode_mx.cu``) and the
shape-derived chunk width.

``ragged_paged_decode`` is what ``layers.attention`` calls from the fused
decode branch. On the quantized-resident mirrors (``quant=``) CPU tensors
take the kernel's plain version and CUDA tensors launch the kernel or
raise; ``ragged_paged_decode.launches`` counts kernel launches. The float
page variant (``kv=``) is the Pallas ``paged_flash_decode``, not ported yet
(ROADMAP.md Queue 2).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import mx as mxlib
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_flash_decode_mx_ref
from repro_torch.obs.profile import profiled_call

BLOCK = mxlib.BLOCK
MAX_BK = 128
G_MAX = 16  # query heads per KV head the kernel holds in registers


def pick_bk(w: int) -> int:
    """Chunk width for a page of ``w`` slots: a multiple of 32 capped at
    128; sub-32 pages stream whole. Part of the numerics (P quantizes per
    chunk), so it matches the reference's choice."""
    if w < BLOCK:
        return w
    return min(MAX_BK, (w // BLOCK) * BLOCK)


def _launch(q, quant, rows, lengths, scale: float, bk: int) -> torch.Tensor:
    L, hkv, g, hd = q.shape
    kvc, ke, ve = quant["kv_codes"], quant["k_exps"], quant["v_exps"]
    w, dpad = kvc.shape[1], 2 * kvc.shape[-1]
    if g > G_MAX or hd > 128 or hd % 2 or bk > min(MAX_BK, w):
        raise ValueError(f"paged_decode_mx kernel: unsupported shape G={g} "
                         f"Dh={hd} bk={bk} W={w}")
    if q.dtype != torch.bfloat16:
        raise ValueError("paged_decode_mx kernel: q must be bf16")
    rows = rows.to(device=q.device, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    q = q.contiguous()
    for name, t in (("kv_codes", kvc), ("k_exps", ke), ("v_exps", ve)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode_mx: {name} must be contiguous on "
                             f"{q.device}")
    out = torch.empty_like(q)
    lib = _build.load("paged_decode_mx")
    fn = lib.paged_decode_mx_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    table = mxlib.pair_table(str(q.device))
    err = fn(q.data_ptr(), kvc.data_ptr(), ke.data_ptr(), ve.data_ptr(),
             rows.data_ptr(), lengths.data_ptr(), table.data_ptr(),
             out.data_ptr(), L, w, hkv, g, hd, dpad, ve.shape[1], bk,
             scale, torch.cuda.current_stream(q.device).cuda_stream)
    ragged_paged_decode.launches += 1
    _build.check(err, "paged_decode_mx")
    return out


def ragged_paged_decode(q, rows, lengths, *, kv=None, quant=None,
                        scale: float, bk: int | None = None,
                        obs=None) -> torch.Tensor:
    """q [L, Hkv, G, Dh] (already MXFP4-fake-quant bf16), rows / lengths
    int [L] -> bf16 [L, Hkv, G, Dh]."""
    if (kv is None) == (quant is None):
        raise ValueError("pass exactly one of kv= (float) or quant= (mx)")
    if kv is not None:
        raise NotImplementedError(
            "ragged paged decode over float pages is the Pallas "
            "paged_flash_decode kernel, not ported yet (ROADMAP.md Queue 2)"
        )
    bk = bk or pick_bk(quant["kv_codes"].shape[1])
    if q.device.type == "cpu":
        return profiled_call(
            "paged_attention.mx.ref", obs,
            lambda: paged_flash_decode_mx_ref(
                q, quant["kv_codes"], quant["k_exps"], quant["v_exps"], rows,
                lengths, scale=scale, bk=bk))
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_decode: unsupported device {q.device}")
    return profiled_call("paged_attention.mx", obs,
                         lambda: _launch(q, quant, rows, lengths, scale, bk))


ragged_paged_decode.launches = 0
