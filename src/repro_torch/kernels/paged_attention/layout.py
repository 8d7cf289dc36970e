"""Fused head-interleaved KV page layout (PyTorch counterpart of
``repro.kernels.paged_attention.layout``).

Raw pages interleave K and V per KV head::

    kv [B, W, 2*Hkv, Dh]      K_h = kv[:, :, 2h]   V_h = kv[:, :, 2h+1]

Quantized-resident pools mirror the pages in the MXFP4 code domain::

    kv_codes [B, W, 2*Hkv, Dpad//2]    uint8  (Dpad = head_dim padded to 32)
    k_exps   [B, W, Hkv, Dpad//32]     int8   per-row head_dim blocks
    v_exps   [B, ceil(W/32), Hkv, Dh]  int8   per 32-slot key block

The per-step update writes the mirrors in place (the reference returns
new arrays; the serving engine donates them, so the effect is the same).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import mx as mxlib

BLOCK = mxlib.BLOCK


def padded_head_dim(hd: int) -> int:
    return -(-hd // BLOCK) * BLOCK


def fuse_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """k, v [..., H, D] -> fused [..., 2H, D] (K even / V odd rows)."""
    s = k.shape
    return torch.stack([k, v], dim=-2).reshape(s[:-2] + (2 * s[-2], s[-1]))


def split_kv(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused [..., 2H, D] -> (k, v) each [..., H, D]."""
    return kv[..., 0::2, :], kv[..., 1::2, :]


def fused_cache_init(batch: int, w: int, n_kv: int, hd: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    """A zero fused page pool on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"`` is given)."""
    return {"kv": torch.zeros((batch, w, 2 * n_kv, hd), dtype=dtype,
                              device=resolve_device(device))}


def fused_quant_init(batch: int, w: int, n_kv: int, hd: int,
                     device=None) -> dict:
    """Quantized mirrors of a zero page: zero codes, E8M0 floor exps, on
    ``device`` (default ``cuda``, as :func:`fused_cache_init`)."""
    device = resolve_device(device)
    dpad = padded_head_dim(hd)
    nwb = -(-w // BLOCK)
    return {
        "kv_codes": torch.zeros((batch, w, 2 * n_kv, dpad // 2),
                                dtype=torch.uint8, device=device),
        "k_exps": torch.full((batch, w, n_kv, dpad // BLOCK), mxlib.E8M0_MIN,
                             dtype=torch.int8, device=device),
        "v_exps": torch.full((batch, nwb, n_kv, hd), mxlib.E8M0_MIN,
                             dtype=torch.int8, device=device),
    }


def _pad_d(x: torch.Tensor, dpad: int) -> torch.Tensor:
    return x if x.shape[-1] == dpad else F.pad(x, (0, dpad - x.shape[-1]))


def quant_page_full(kw: torch.Tensor, vw: torch.Tensor) -> dict:
    """Quantize whole K/V pages [B, W, Hkv, Dh] into the fused mirrors."""
    w, hd = kw.shape[1], kw.shape[-1]
    dpad = padded_head_dim(hd)
    kq = mxlib.quantize(kw.to(torch.float32))  # codes [B, W, Hkv, Dpad]
    vq = mxlib.quantize_axis(vw.to(torch.float32), 1)  # key axis last
    v_codes = _pad_d(torch.movedim(vq.codes[..., :w], -1, 1), dpad)
    return {
        "kv_codes": mxlib.pack_codes(fuse_kv(kq.codes, v_codes)),
        "k_exps": kq.exps,
        "v_exps": torch.movedim(vq.exps, -1, 1).contiguous(),
    }


def quant_page_step(quant: dict, kv: torch.Tensor, rows: torch.Tensor,
                    slot: torch.Tensor,
                    write: torch.Tensor | None = None) -> None:
    """In-place per-step update of the fused mirrors ``quant`` from the
    just-updated pool ``kv`` [P, W, 2Hkv, Dh]: re-quantize the written K
    row and the active 32-slot V block of each lane (``rows``, ``slot``
    int [L]). Bitwise the reference's ``quant_page_step``. ``write``
    (bool [L]) limits the update to its lanes (a rank's block of a pool
    whose sequence is cut: the lanes whose slot it holds; no host sync)."""

    def put(dst, idx, new):
        if write is not None:
            m = write.reshape((-1,) + (1,) * (new.ndim - 1))
            new = torch.where(m, new.to(dst.dtype), dst[idx])
        dst[idx] = new

    w, hd = kv.shape[1], kv.shape[3]
    hkv = kv.shape[2] // 2
    dpad = padded_head_dim(hd)
    rows, slot = rows.long(), slot.long()
    even = 2 * torch.arange(hkv, device=kv.device)
    kq = mxlib.quantize(kv[rows, slot][:, 0::2].to(torch.float32))
    put(quant["kv_codes"], (rows[:, None], slot[:, None], even[None, :]),
        mxlib.pack_codes(kq.codes))
    put(quant["k_exps"], (rows, slot), kq.exps)
    start = (slot // BLOCK) * BLOCK  # [L]
    idx = start[:, None] + torch.arange(BLOCK, device=kv.device)  # [L, 32]
    inside = idx < w
    last = torch.clamp(idx, max=w - 1)  # slots past the page -> slot W-1
    blk = kv[rows[:, None], last][..., 1::2, :]
    zero = torch.zeros((), dtype=blk.dtype, device=blk.device)
    blk = torch.where(inside[:, :, None, None], blk, zero)  # past the page
    vq = mxlib.quantize_axis(blk.to(torch.float32), 1)  # [L, Hkv, Dh, 32]
    v_codes = _pad_d(torch.movedim(vq.codes, -1, 1), dpad)  # [L, 32, Hkv, Dpad]
    packed = mxlib.pack_codes(v_codes)
    # a partial end block (W % 32 != 0): its slots past the page write
    # slot W-1's own codes again, so every write to W-1 carries the same
    # bytes and the scatter needs no data-dependent shape or host sync
    packed = packed[torch.arange(len(rows), device=kv.device)[:, None],
                    last - start[:, None]]
    odd = (even + 1)[None, None, :]
    put(quant["kv_codes"], (rows[:, None, None], last[:, :, None], odd),
        packed)
    put(quant["v_exps"], (rows, slot // BLOCK), vq.exps[..., 0])


def _scale_blocks(codes: torch.Tensor, exps: torch.Tensor) -> torch.Tensor:
    """bf16 code values [..., K] * 2^(e-1) from int8 exps [..., K//32];
    exact in bf16."""
    shp = codes.shape
    cb = codes.reshape(shp[:-1] + (shp[-1] // BLOCK, BLOCK))
    scale = mxlib.exp2i(exps.to(torch.int32) - 1).to(torch.bfloat16)
    return (cb * scale[..., None]).reshape(shp)


def dequant_k_pages(kv_codes: torch.Tensor, k_exps: torch.Tensor,
                    hd: int) -> torch.Tensor:
    """Fused codes [..., W, 2Hkv, Dpad//2] + exps [..., W, Hkv, Dpad//32]
    -> bf16 K pages [..., W, Hkv, Dh]."""
    codes = mxlib.unpack_pairs_bf16(kv_codes[..., 0::2, :])
    return _scale_blocks(codes, k_exps)[..., :hd]


def dequant_v_pages(kv_codes: torch.Tensor, v_exps: torch.Tensor,
                    hd: int) -> torch.Tensor:
    """Fused codes + slot-block-major exps [..., ceil(W/32), Hkv, Dh]
    -> bf16 V pages [..., W, Hkv, Dh] (slot s uses row s // 32)."""
    codes = mxlib.unpack_pairs_bf16(kv_codes[..., 1::2, :])[..., :hd]
    w = codes.shape[-3]
    scale = mxlib.exp2i(v_exps.to(torch.int32) - 1).to(torch.bfloat16)
    scale = torch.repeat_interleave(scale, BLOCK, dim=-3)[..., :w, :, :]
    return codes * scale
