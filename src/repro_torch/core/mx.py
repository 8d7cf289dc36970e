"""MXFP4 microscaling numerics (OCP MX spec, paper §2.3 + Appendix A).

PyTorch counterpart of ``repro.core.mx``, bitwise on the same inputs:
every decision runs on IEEE-754 exponent fields (``Tensor.view`` is the
bitcast) and ``torch.round`` rounds ties to even like ``jnp.rint``.

A length-32 block is stored as 32 E2M1 ("FP4") elements plus one shared
E8M0 power-of-two scale: ``V_i = P_i * 2^E``. Elements are carried as
integer *codes* ``2 * P_i`` in ``{0, ±1, ±2, ±3, ±4, ±6, ±8, ±12}``.

Subnormals: XLA on the CPU runs with flush-to-zero and denormals-are-zero,
PyTorch and the CUDA kernels do not (the kernels are built without
``-ftz``, so exact subnormal powers of two survive). The two therefore
agree bitwise on every block whose shared scale is a normal number; the
E8M0 floor window (scale ``2^-127``) differs unless PyTorch runs under
``torch.set_flush_denormal(True)``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

BLOCK = 32  # MX block size along the contraction axis
EMAX_ELEM = 2  # largest E2M1 exponent (6 = 1.5 * 2^2)
FP4_MAX = 6.0
CODE_MAX = 12  # 2 * FP4_MAX
WEIGHT_BIAS = 12  # INT5 affine bias for unsigned weight encoding
E8M0_MIN, E8M0_MAX = -127, 127

# |code| -> E2M1 nibble (sign bit added separately), valid at
# {0,1,2,3,4,6,8,12}; and nibble magnitude -> |code|
_ABS_CODE_TO_NIBBLE = (0, 1, 2, 3, 4, 0, 5, 0, 6, 0, 0, 0, 7)
_NIBBLE_TO_CODE = (0, 1, 2, 3, 4, 6, 8, 12)


class MX(NamedTuple):
    """A block-quantized tensor: ``codes`` int8 [..., K_pad]; ``exps``
    int8 [..., K_pad // 32] (unbiased E8M0).

    value[..., b*32 + i] = codes[..., b*32 + i] / 2 * 2^exps[..., b]
    """

    codes: torch.Tensor
    exps: torch.Tensor


class MXW(NamedTuple):
    """Weight matrix [K, N] quantized along K (the contraction axis):
    codes int8 [K_pad, N]; exps int8 [K_pad // 32, N]. :func:`quantize_w`
    returns both K-major (strides ``(1, K_pad)`` and ``(1, K_pad // 32)``):
    a column's codes are contiguous, as a CTT array column holds them."""

    codes: torch.Tensor
    exps: torch.Tensor


def _f32_from_field(field: torch.Tensor) -> torch.Tensor:
    """float32 whose biased exponent field is ``field`` (int32)."""
    return (field << 23).to(torch.int32).view(torch.float32)


def exp2i(e) -> torch.Tensor:
    """Exact 2^e (float32) for integer-valued ``e`` by exponent-field
    construction, split into two factors to cover [-252, 252]."""
    e = torch.as_tensor(e).to(torch.int32)
    h1 = torch.clamp(torch.div(e, 2, rounding_mode="floor"), -126, 127)
    h2 = torch.clamp(e - h1, -126, 127)
    return _f32_from_field(h1 + 127) * _f32_from_field(h2 + 127)


def floor_ilog2(x: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2(x))`` (int32) for finite ``x >= 0`` from the
    IEEE exponent field; zero and subnormals read as -127."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def _pad_last(x: torch.Tensor, multiple: int = BLOCK) -> torch.Tensor:
    rem = (-x.shape[-1]) % multiple
    if rem:
        x = torch.nn.functional.pad(x, (0, rem))
    return x


def _quant_scaled(xb: torch.Tensor):
    """Bit-level core of :func:`quantize`. ``xb`` f32 blocks [..., nb, 32]
    -> (code_mag f32 [..., nb, 32] in {0..12}, ebf int32 [..., nb, 1]
    biased shared-exponent field clipped to [2, 254])."""
    ax = xb.abs()
    amax = ax.amax(dim=-1, keepdim=True)
    ebf = torch.clamp((amax.view(torch.int32) >> 23) & 0xFF, 2, 254)
    y = ax * _f32_from_field(256 - ebf)  # |x| / 2^e_shared, exact
    e = torch.clamp((y.view(torch.int32) >> 23) - 127, 0, EMAX_ELEM)
    q = torch.round(y * _f32_from_field(128 - e))
    q = q * _f32_from_field(126 + e)
    q = torch.clamp(q, max=FP4_MAX)
    return 2.0 * q, ebf


def quantize_e2m1(y: torch.Tensor) -> torch.Tensor:
    """Round already-scaled ``y`` to the E2M1 grid (ties to even) and
    return the codes ``2 * fp4`` as int8. The grid step comes from the
    exponent field (0.5 below 2, 1 in [2, 4), 2 from 4) and the divide is
    an exact power-of-two multiply; magnitudes clamp at 6."""
    ay = y.abs()
    e = torch.clamp(floor_ilog2(ay), 0, EMAX_ELEM)
    q = torch.round(ay * exp2i(1 - e)) * exp2i(e - 1)
    q = torch.clamp(q, max=FP4_MAX)
    return (torch.sign(y) * (2.0 * q)).to(torch.int8)


def quantize(x: torch.Tensor, axis: int = -1) -> MX:
    """Block-quantize ``x`` to MXFP4 along ``axis`` (padded to 32); the
    quantized axis ends up last in both ``codes`` and ``exps``."""
    if axis not in (-1, x.ndim - 1):
        x = torch.movedim(x, axis, -1)
    x = _pad_last(x.to(torch.float32))
    shp = x.shape
    xb = x.reshape(shp[:-1] + (shp[-1] // BLOCK, BLOCK))
    code_mag, ebf = _quant_scaled(xb)
    codes = torch.where(xb < 0, -code_mag, code_mag).to(torch.int8)
    return MX(codes.reshape(shp), (ebf[..., 0] - 129).to(torch.int8))


def quantize_axis(x: torch.Tensor, axis: int) -> MX:
    """:func:`quantize` along ``axis``, which is moved to the end."""
    return quantize(x, axis)


def dequantize(mx: MX, out_len: int | None = None,
               dtype=torch.float32) -> torch.Tensor:
    shp = mx.codes.shape
    cb = mx.codes.reshape(shp[:-1] + (shp[-1] // BLOCK, BLOCK))
    v = cb.to(torch.float32) * 0.5 * exp2i(mx.exps)[..., None]
    v = v.reshape(shp)
    if out_len is not None and out_len != shp[-1]:
        v = v[..., :out_len]
    return v.to(dtype)


def encode_weight_unsigned(mx: MX) -> torch.Tensor:
    """INT5 affine map of weight codes into [0, 24] (uint8)."""
    return (mx.codes.to(torch.int16) + WEIGHT_BIAS).to(torch.uint8)


def decode_weight_unsigned(u: torch.Tensor) -> torch.Tensor:
    return (u.to(torch.int16) - WEIGHT_BIAS).to(torch.int8)


# ---------------------------------------------------------------- packing

@functools.lru_cache(maxsize=None)
def _lut(values: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes -> E2M1 nibbles, two per uint8 (even element in the low
    nibble; nibble = [sign(1) | exp(2) | man(1)]). Last axis even."""
    lut = _lut(_ABS_CODE_TO_NIBBLE, torch.uint8, str(codes.device))
    sign = (codes < 0).to(torch.uint8)
    nib = lut[codes.to(torch.int32).abs().long()] | (sign << 3)
    lo, hi = nib[..., 0::2], nib[..., 1::2]
    return lo | (hi << 4)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    lut = _lut(_NIBBLE_TO_CODE, torch.int8, str(packed.device))
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    nib = torch.stack([lo, hi], dim=-1).reshape(packed.shape[:-1] + (-1,))
    mag = lut[(nib & 0x7).long()]
    neg = ((nib >> 3) & 1).bool()
    return torch.where(neg, -mag, mag).to(torch.int8)


def _build_pair_table() -> np.ndarray:
    """256-entry byte -> uint32 table: the low/high u16 halves hold the
    bf16 bit patterns of the two code values (2 * fp4) a packed byte
    carries (even element in the low nibble)."""
    byte = np.arange(256)

    def val(nib):
        m = nib & 1
        e = (nib >> 1) & 3
        c = np.where(e == 0, m, (2 + m) << np.maximum(e - 1, 0))
        return np.where((nib >> 3) & 1, -c, c).astype(np.float32)

    def bf16_bits(v):  # round-to-nearest is exact for these integers
        return (v.astype(">f4").view(">u4") >> 16).astype(np.uint32)

    return bf16_bits(val(byte & 15)) | (bf16_bits(val(byte >> 4)) << 16)


PAIR_TABLE = _build_pair_table()


@functools.lru_cache(maxsize=None)
def pair_table(device: str) -> torch.Tensor:
    """:data:`PAIR_TABLE` as an int32 tensor (same bits) on ``device``."""
    return torch.from_numpy(PAIR_TABLE.view(np.int32).copy()).to(device)


def unpack_pairs_bf16(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 pairs [..., K//2] -> bf16 code values [..., K] through
    :data:`PAIR_TABLE`: one gather and one bitcast per byte."""
    pair = pair_table(str(packed.device))[packed.long()]  # [..., K//2]
    cb = pair.contiguous().view(torch.int16).view(torch.bfloat16)
    return cb.reshape(packed.shape[:-1] + (-1,))


def exps_to_biased(exps: torch.Tensor) -> torch.Tensor:
    """Unbiased int8 exponent -> biased uint8 (E8M0 storage)."""
    return (exps.to(torch.int16) + 127).to(torch.uint8)


def exps_from_biased(b: torch.Tensor) -> torch.Tensor:
    return (b.to(torch.int16) - 127).to(torch.int8)


# ------------------------------------------------------------- fake quant

def _bf16_pow2(field: torch.Tensor) -> torch.Tensor:
    """bf16 with exponent field ``field`` (int32 in [0, 255])."""
    return (field << 7).to(torch.int16).view(torch.bfloat16)


def _fake_quant_impl(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The MXFP4 quantize-dequantize chain in layout: the quantized axis
    reshapes in place to (nb, 32). bf16 inputs run natively in bf16
    (every grid value, tie point and power-of-two scale is exactly
    bf16-representable), bitwise the reference's bf16 path."""
    a = axis % x.ndim
    k = x.shape[a]
    rem = (-k) % BLOCK
    bf16 = x.dtype == torch.bfloat16
    xf = x if bf16 else x.to(torch.float32)
    if rem:
        pad = [0, 0] * (x.ndim - 1 - a) + [0, rem]
        xf = torch.nn.functional.pad(xf, pad)
    shp = xf.shape
    xb = xf.reshape(shp[:a] + ((k + rem) // BLOCK, BLOCK) + shp[a + 1:])

    def field(t):  # biased IEEE exponent field (bf16 and f32 share it)
        if bf16:
            return (t.view(torch.int16).to(torch.int32) >> 7) & 0xFF
        return (t.view(torch.int32) >> 23) & 0xFF

    def pow2(f):
        return _bf16_pow2(f) if bf16 else _f32_from_field(f)

    ax = xb.abs()
    amax = ax.amax(dim=a + 1, keepdim=True)
    ebf = torch.clamp(field(amax), 2, 254)
    y = ax * pow2(256 - ebf)
    e = torch.clamp(field(y) - 127, 0, EMAX_ELEM)
    q = torch.round(y * pow2(128 - e))
    q = q * pow2(126 + e)
    q = torch.clamp(q, max=FP4_MAX)
    scale = _bf16_pow2(ebf - 2) if bf16 else exp2i(ebf - 129)
    v = torch.where(xb < 0, -q, q) * scale  # q * 2^e_shared
    v = v.reshape(shp)
    if rem:
        v = v.narrow(a, 0, k)
    return v.to(x.dtype)


class _FakeQuant(torch.autograd.Function):
    """Straight-through estimator around the quantize-dequantize chain."""

    @staticmethod
    def forward(ctx, x, axis):
        return _fake_quant_impl(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize along the last axis (STE gradient); bitwise
    ``dequantize(quantize(x))`` with the shape preserved."""
    return _FakeQuant.apply(x, x.ndim - 1)


def fake_quant_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """:func:`fake_quant` along an arbitrary axis (STE gradient)."""
    return _FakeQuant.apply(x, axis)


# ------------------------------------------------- fidelity observability

def bucket_counts(v: torch.Tensor, buckets: tuple,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Bucket ``v`` on the boundaries ``buckets`` as ``Histogram.observe``
    does (``bisect_left``: a value equal to a boundary lands in that
    ``le`` bucket; the +Inf bucket takes the tail). Returns int32 counts
    of length ``len(buckets) + 1`` on ``v``'s device, for
    ``Histogram.merge_counts``; ``weights`` (0/1) masks elements out."""
    b = torch.tensor(buckets, dtype=torch.float32, device=v.device)
    idx = torch.searchsorted(b, v.to(torch.float32).reshape(-1), right=False)
    w = (torch.ones_like(idx) if weights is None
         else weights.reshape(-1).to(torch.int64))
    out = torch.zeros(len(buckets) + 1, dtype=torch.int64, device=v.device)
    return out.index_add_(0, idx, w).to(torch.int32)


def quant_health(x: torch.Tensor, exp_buckets: tuple = ()) -> dict:
    """MXFP4 quantizer health over one tensor (last-axis blocks), never
    on the hot path. Over the unpadded elements: ``clipped`` (beyond the
    top of the E2M1 grid, ``|x| > 6 * 2^E``), ``underflow`` (nonzero
    values flushed to code 0 by the block exponent), ``total`` (a Python
    int); and the shared exponents of live (nonzero) blocks bucketed on
    ``exp_buckets``: ``exp_counts`` / ``exp_sum`` / ``exp_n`` /
    ``exp_min`` / ``exp_max``. Tensors stay on ``x``'s device."""
    xf = _pad_last(x.to(torch.float32))
    shp = xf.shape
    xb = xf.reshape(shp[:-1] + (shp[-1] // BLOCK, BLOCK))
    code_mag, ebf = _quant_scaled(xb)
    scale = exp2i(ebf - 129)  # 2^e_shared, exact
    e = ebf[..., 0] - 129  # [..., nb] shared exponent a block
    live = (xb != 0).any(dim=-1)  # zero-amax blocks sit on the floor
    big = 10 ** 6
    return {
        "total": int(np.prod(x.shape)),
        "clipped": (xb.abs() > FP4_MAX * scale).sum(),
        "underflow": ((xb != 0) & (code_mag == 0)).sum(),
        "exp_counts": bucket_counts(e, exp_buckets, weights=live),
        "exp_sum": torch.where(live, e, 0).sum(),
        "exp_n": live.sum(),
        "exp_min": torch.where(live, e, big).amin(),
        "exp_max": torch.where(live, e, -big).amax(),
    }


# ------------------------------------------------------------ bf16 helper

def to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def mx_dot_bf16(a: MX, b: MXW, bf16_partials: bool = False) -> torch.Tensor:
    """Digital-path ``a @ b`` with MXFP4 operands (paper §4.5): ``a``
    quantized along its last axis, ``b`` a [K, N] weight quantized along K.
    With ``bf16_partials`` each 32-block's partial sum is rounded to bf16
    before the cross-block sum (the systolic array's bf16 accumulator at
    block granularity); otherwise one f32 matmul and a final bf16 round.
    The products of two MXFP4 values are exact in f32, so the sums are
    too while their span fits in 24 bits (model-scale K does)."""
    va = dequantize(a)  # [..., K]
    vb = dequantize_w(b)  # [K, N]
    k = vb.shape[0]
    if bf16_partials:
        nb = k // BLOCK
        vab = va[..., :k].reshape(va.shape[:-1] + (nb, BLOCK))
        parts = torch.einsum("...bk,bkn->...bn", vab,
                             vb.reshape(nb, BLOCK, -1))
        parts = parts.to(torch.bfloat16).to(torch.float32)
        return parts.sum(dim=-2).to(torch.bfloat16)
    return torch.matmul(va[..., :k], vb).to(torch.bfloat16)


def kmajor(t: torch.Tensor) -> torch.Tensor:
    """The same [K, N] values with K contiguous (strides ``(1, K)``): the
    [K, N] view of an [N, K] contiguous tensor. No copy if already so."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_w(w: torch.Tensor) -> MXW:
    """Quantize a [K, N] weight along K (axis 0); codes and exps come out
    K-major (see :class:`MXW`)."""
    mx = quantize(w.transpose(-1, -2))
    return MXW(kmajor(mx.codes.transpose(-1, -2)),
               kmajor(mx.exps.transpose(-1, -2)))


def dequantize_w(w: MXW, dtype=torch.float32) -> torch.Tensor:
    mx = MX(w.codes.transpose(-1, -2), w.exps.transpose(-1, -2))
    return dequantize(mx, dtype=dtype).transpose(-1, -2)
