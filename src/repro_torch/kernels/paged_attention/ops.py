"""Wrappers for ragged paged decode over the fused page pool, the
shape-derived chunk width and the float kernel's key split.

- :func:`paged_flash_decode` runs ``csrc/paged_decode.cu`` over float
  (bf16) pages ``kv``, the keys split over blocks (:func:`pick_splits`).
- :func:`paged_flash_decode_mx` runs ``csrc/paged_decode_mx.cu`` over the
  quantized-resident MXFP4 mirrors ``quant``, the query heads of a KV
  head in blocks of :func:`pick_heads`.
- :func:`ragged_paged_decode` is what ``layers.attention`` calls from the
  fused decode branch; it takes exactly one of ``kv=`` / ``quant=``.

CPU tensors take each kernel's plain version; CUDA tensors launch the
kernel or raise; ``meta`` tensors (the dry-run) get the kernel's output
shape and record the call with :func:`cost_float` / :func:`cost_mx`
(``obs.cost``), launching nothing. Each of the two kernel wrappers counts
its own launches in ``.launches``.

``partial=True`` (the decode over a block of a page's slots, a rank's
block of a cache sequence cut over ranks: ``distributed.seq_parallel``)
returns the flash-decoding partial ``(o, lse)`` instead: o f32 [L, Hkv, G,
Dh], the output before its bf16 cast (bitwise that cast), and lse f32
[L, Hkv, G] = max + log(sum) of the lane's scores, ``-inf`` for a lane
with no live slot (o 0). Those launches are also counted in
``.partial_launches``.
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
from repro_torch.obs import cost as cost_mod
from repro_torch.obs.profile import profiled_call

BLOCK = mxlib.BLOCK
MAX_BK = 128
G_MAX = 16  # query heads per KV head the kernels hold in registers
SPLIT_WIDTHS = (16, 32, 64)  # keys per block of the float kernel
MAX_SPLITS = 256  # splits per lane its combine takes (pages <= 16384 slots)
# head widths the float kernel takes: the powers of two and the reference
# archs' 80 (h2o-danube-1.8b) and 256 (gemma3-1b)
FLOAT_DH = (8, 16, 32, 64, 80, 128, 256)
DH_MAX = 256  # head_dim both kernels take at most
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]
_ARGTYPES_MX = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_void_p]
MX_HEADS = 2  # query heads a block of the mx kernel takes (at most 16)


def pick_bk(w: int) -> int:
    """Chunk width for a page of ``w`` slots: a multiple of 32 capped at
    128; sub-32 pages stream whole. Part of the numerics (P quantizes per
    chunk on the mx path), so it matches the reference's choice."""
    if w < BLOCK:
        return w
    return min(MAX_BK, (w // BLOCK) * BLOCK)


def pick_splits(w: int) -> tuple[int, int]:
    """(split width SW, splits NS) of the float kernel for pages of ``w``
    slots: 16 keys a block, the fastest of 16 / 32 / 64 at 4 lanes on the
    H100 (a block's score, softmax and PV passes grow with its keys; see
    PERF.md), widened only where a page would need more than
    ``MAX_SPLITS``; pages narrower than that split whole. Only the float
    kernel's speed and rounding depend on it, not its function."""
    sw = next((s for s in SPLIT_WIDTHS if -(-w // s) <= MAX_SPLITS), None)
    if sw is None:
        raise ValueError(f"paged_decode kernel: W={w} needs more than "
                         f"{MAX_SPLITS} splits of {SPLIT_WIDTHS[-1]}")
    sw = min(sw, w)
    return sw, -(-w // sw)


def split_slots(w: int, sw: int, s: int, length: int) -> range:
    """The slots split ``s`` of the float kernel attends to in a lane of
    ``length``: its rows are fetched at ``min(s*sw, w-sw)`` and only the
    slots in ``[s*sw, length)`` stay live."""
    offs = min(s * sw, w - sw)
    return range(max(offs, s * sw), min(offs + sw, length))


def pick_heads(g: int) -> int:
    """Query heads a block of the mx kernel takes: the group's ``g`` heads
    in ``ceil(g / MX_HEADS)`` blocks of at most ``MX_HEADS`` (``g`` = 9 at
    starcoder2-7b width: 5 blocks per lane and KV head, 80 at 4 lanes; on
    the H100, 2 heads a block beat 1 (144 blocks) and 9 (16):
    ``scripts/torch_kernel_sweep.py``, ``mx_heads``). Each head keeps its
    own softmax state and P blocks, so only the speed depends on it."""
    return min(g, MX_HEADS)


def _check_shape(name: str, q, w: int, bk: int, n_kv: int) -> None:
    L, hkv, g, hd = q.shape
    if (g > G_MAX or hd > DH_MAX or hd % 2 or bk > min(MAX_BK, w)
            or hkv != n_kv):
        raise ValueError(f"{name} kernel: unsupported shape G={g} Dh={hd} "
                         f"bk={bk} W={w} Hkv={hkv}/{n_kv}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel: q must be bf16")


def _out_bytes(lanes: int, hkv: int, g: int, dh: int, partial: bool) -> int:
    """q (bf16) read and the output written once: bf16, or under
    ``partial`` o f32 and an f32 lse a head."""
    heads = lanes * hkv * g
    return 2 * heads * dh + (heads * (4 * dh + 4) if partial
                             else 2 * heads * dh)


def cost_float(lengths, hkv: int, g: int, dh: int, partial: bool = False
               ) -> tuple[float, float, str]:
    """(bytes, operations, their type) of one float decode: each lane's
    live K and V rows (bf16) read once, q read and the output written once
    (bf16; ``partial``: o and lse f32), the lane's row and length; 4 dh
    operations a (head, live key) pair. ``lengths``: the lanes' lengths
    (the dry-run, which sees no values, gives the full window a lane)."""
    lanes = len(lengths)
    n_bytes = (sum(hkv * n * 2 * dh * 2 for n in lengths)
               + _out_bytes(lanes, hkv, g, dh, partial) + 8 * lanes)
    ops = sum(4.0 * n * hkv * g * dh for n in lengths)
    return n_bytes, ops, "bf16"


def cost_mx(lengths, hkv: int, g: int, dh: int, half_bytes: int,
            n_blocks: int, partial: bool = False) -> tuple[float, float, str]:
    """The same for the mx decode from the resident mirrors: a live key's
    packed K and V codes (``half_bytes`` each, half the padded head_dim)
    and its K block exponents (``n_blocks``), V's exponents a 32-key
    block; q bf16, the output as :func:`cost_float`'s."""
    lanes = len(lengths)
    n_bytes = (sum(hkv * (n * (2 * half_bytes + n_blocks) + -(-n // 32) * dh)
                   for n in lengths)
               + _out_bytes(lanes, hkv, g, dh, partial) + 8 * lanes)
    ops = sum(4.0 * n * hkv * g * dh for n in lengths)
    return n_bytes, ops, "bf16"


def _outputs(q, partial: bool):
    """The output bf16 like ``q``, or under ``partial`` (o, lse) f32."""
    if not partial:
        return torch.empty_like(q)
    f32 = torch.float32
    return (torch.empty(q.shape, dtype=f32, device=q.device),
            torch.empty(q.shape[:-1], dtype=f32, device=q.device))


def _meta(q, w: int, quant=None, partial: bool = False):
    """A launch on ``meta``: the output (and the float kernel's split
    partials), and the call recorded at the full window ``w`` a lane
    (the lengths are values, which ``meta`` has not); nothing runs."""
    name = "paged_decode" if quant is None else "paged_decode_mx"
    _build.refuse_grad(name, q)
    L, hkv, g, hd = q.shape
    if quant is None:
        ns = pick_splits(w)[1]
        torch.empty((L, hkv, ns, g, 2), dtype=torch.float32, device=q.device)
        torch.empty((L, hkv, ns, g, hd), dtype=torch.float32,
                    device=q.device)
        n_bytes, ops, _ = cost_float([w] * L, hkv, g, hd, partial)
    else:
        n_bytes, ops, _ = cost_mx([w] * L, hkv, g, hd,
                                  quant["kv_codes"].shape[-1],
                                  quant["k_exps"].shape[-1], partial)
    cost_mod.record_kernel(name, "default", ops, n_bytes)
    return _outputs(q, partial)


def _lane_ints(t, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.int32).contiguous()


@_build.on_device
def _launch(q, kv, rows, lengths, scale: float,
            split_width: int | None = None, partial: bool = False):
    """Launch the float kernel, its keys split by :func:`pick_splits` or,
    to time the alternatives (``scripts/torch_kernel_sweep.py``), into
    ``split_width``-key splits; bf16 out, or the partial (o, lse)."""
    _build.refuse_grad("paged_decode", q, kv)
    L, hkv, g, hd = q.shape
    w = kv.shape[1]
    _check_shape("paged_decode", q, w, pick_bk(w), kv.shape[2] // 2)
    if (kv.dtype != torch.bfloat16 or kv.device != q.device
            or not kv.is_contiguous() or kv.shape[3] != hd):
        raise ValueError(f"paged_decode: kv must be contiguous bf16 "
                         f"[P, W, 2Hkv, {hd}] on {q.device}")
    if hd not in FLOAT_DH:
        raise ValueError(f"paged_decode kernel: head_dim {hd} not in "
                         f"{FLOAT_DH}")
    rows, lengths = _lane_ints(rows, q.device), _lane_ints(lengths, q.device)
    q = q.contiguous()
    if q.data_ptr() % 16 or kv.data_ptr() % 16:
        raise ValueError("paged_decode kernel: q and kv must be 16-byte "
                         "aligned")
    sw, ns = pick_splits(w)
    if split_width:
        sw, ns = min(split_width, w), -(-w // min(split_width, w))
    out = _outputs(q, partial)
    o, lse = out if partial else (out, None)
    ml = torch.empty((L, hkv, ns, g, 2), dtype=torch.float32, device=q.device)
    acc = torch.empty((L, hkv, ns, g, hd), dtype=torch.float32,
                      device=q.device)
    fn = _build.function("paged_decode", "paged_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), kv.data_ptr(), rows.data_ptr(), lengths.data_ptr(),
             ml.data_ptr(), acc.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(), L, w, hkv, g, hd, sw,
             ns, scale, torch.cuda.current_stream(q.device).cuda_stream)
    paged_flash_decode.launches += 1
    paged_flash_decode.partial_launches += int(partial)
    _build.check(err, "paged_decode")
    return out


@_build.on_device
def _launch_mx(q, quant, rows, lengths, scale: float, bk: int,
               heads: int | None = None, partial: bool = False):
    """Launch the mx kernel, ``heads`` query heads a block (default
    :func:`pick_heads`; named only to time the alternatives,
    ``scripts/torch_kernel_sweep.py``); bf16 out, or the partial (o,
    lse)."""
    _build.refuse_grad("paged_decode_mx", q)
    L, hkv, g, hd = q.shape
    kvc, ke, ve = quant["kv_codes"], quant["k_exps"], quant["v_exps"]
    w, dpad = kvc.shape[1], 2 * kvc.shape[-1]
    _check_shape("paged_decode_mx", q, w, bk, kvc.shape[2] // 2)
    if hd % 16:
        raise ValueError(f"paged_decode_mx kernel: head_dim {hd} is not a "
                         f"multiple of 16")
    rows, lengths = _lane_ints(rows, q.device), _lane_ints(lengths, q.device)
    q = q.contiguous()
    for name, t in (("kv_codes", kvc), ("k_exps", ke), ("v_exps", ve)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode_mx: {name} must be contiguous on "
                             f"{q.device}")
    if kvc.data_ptr() % 16 or ve.data_ptr() % 16:
        raise ValueError("paged_decode_mx kernel: kv_codes and v_exps must "
                         "be 16-byte aligned")
    heads = heads or pick_heads(g)
    out = _outputs(q, partial)
    o, lse = out if partial else (out, None)
    fn = _build.function("paged_decode_mx", "paged_decode_mx_launch",
                         _ARGTYPES_MX)
    table = mxlib.pair_table(str(q.device))
    err = fn(q.data_ptr(), kvc.data_ptr(), ke.data_ptr(), ve.data_ptr(),
             rows.data_ptr(), lengths.data_ptr(), table.data_ptr(),
             o.data_ptr(), None if lse is None else lse.data_ptr(), L, w,
             hkv, g, hd, dpad, ve.shape[1], bk, heads, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    paged_flash_decode_mx.launches += 1
    paged_flash_decode_mx.partial_launches += int(partial)
    _build.check(err, "paged_decode_mx")
    return out


def paged_flash_decode(q, kv, rows, lengths, *, scale: float,
                       bk: int | None = None, obs=None,
                       partial: bool = False):
    """q [L, Hkv, G, Dh] bf16, fused pages kv [P, W, 2Hkv, Dh] bf16, rows /
    lengths int [L] -> bf16 [L, Hkv, G, Dh] (``partial``: (o, lse)).
    ``bk`` is the plain version's chunk width; the kernel splits the keys
    by :func:`pick_splits`."""
    bk = bk or pick_bk(kv.shape[1])
    if q.device.type == "cpu":
        return profiled_call("paged_attention.ref", obs, lambda: (
            paged_flash_decode_ref(q, kv, rows, lengths, scale=scale, bk=bk,
                                   partial=partial)))
    if q.is_meta:
        return _meta(q, kv.shape[1], partial=partial)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    return profiled_call("paged_attention", obs, lambda: _launch(
        q, kv, rows, lengths, scale, partial=partial))


def paged_flash_decode_mx(q, quant, rows, lengths, *, scale: float,
                          bk: int | None = None, obs=None,
                          partial: bool = False):
    """q [L, Hkv, G, Dh] (already MXFP4-fake-quant bf16), the fused code
    mirrors ``quant``, rows / lengths int [L] -> bf16 [L, Hkv, G, Dh]
    (``partial``: (o, lse))."""
    bk = bk or pick_bk(quant["kv_codes"].shape[1])
    if q.device.type == "cpu":
        return profiled_call(
            "paged_attention.mx.ref", obs,
            lambda: paged_flash_decode_mx_ref(
                q, quant["kv_codes"], quant["k_exps"], quant["v_exps"], rows,
                lengths, scale=scale, bk=bk, partial=partial))
    if q.is_meta:
        return _meta(q, quant["kv_codes"].shape[1], quant, partial)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_mx: unsupported device "
                         f"{q.device}")
    return profiled_call("paged_attention.mx", obs, lambda: _launch_mx(
        q, quant, rows, lengths, scale, bk, partial=partial))


def ragged_paged_decode(q, rows, lengths, *, kv=None, quant=None,
                        scale: float, bk: int | None = None, obs=None,
                        partial: bool = False):
    """Float pages (``kv=``) or quantized-resident mirrors (``quant=``);
    exactly one of the two."""
    if (kv is None) == (quant is None):
        raise ValueError("pass exactly one of kv= (float) or quant= (mx)")
    if kv is not None:
        return paged_flash_decode(q, kv, rows, lengths, scale=scale, bk=bk,
                                  obs=obs, partial=partial)
    return paged_flash_decode_mx(q, quant, rows, lengths, scale=scale, bk=bk,
                                 obs=obs, partial=partial)


paged_flash_decode.launches = paged_flash_decode.partial_launches = 0
paged_flash_decode_mx.launches = paged_flash_decode_mx.partial_launches = 0
