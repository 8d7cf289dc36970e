"""The two kernel modes a row-parallel linear (K over the model ranks)
needs, in their plain versions on the CPU (the card's routes are held to
these by ``chip_smoke.py`` phase 17).

- Kernel C's ``out_dtype``: ``mxfp4_matmul(..., out_dtype=float32)``
  against the reference's ``mxfp4_matmul_ref(out_dtype=jnp.float32)``
  (rtol 1e-6, atol 1e-6 * max|ref|: f32 sums in another order), and its
  bf16 output bitwise the f32 one cast to bf16, at decode and prefill
  rows; the ``meta`` branch's output dtype and the cost model's output
  bytes.
- Kernel A's pass sums: ``cim_linear(..., sums=True)`` is
  ``core.cim.pass_sums`` (int32 [2, ..., N] in units of 2^-CM); the sums
  of four 32-aligned K-slices, read out (``read_out_sums``), bitwise the
  whole linear (``core.cim.cim_linear``), under three CIM configs; the
  sums match ``tests/test_torch_cim_splitk.py``'s int64 model of the
  kernel's integer sums. The constructed row whose ordered f32 sum
  rounds (K = 18432, CM 3): the split sums read out differ from the
  one-device ordered walk in that row (c1 exact, 16957440 + 116 units of
  2^-3, where the walk drops the 116 half-ulps: 14.5 apart), and only
  there.
- ``sums_dtype``: int32 below a row bound of 2^31, int64 from it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mxfp4_matmul import ref as jmm_ref  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.kernels.cim_linear import ops as cim_ops  # noqa: E402
from repro_torch.kernels.mxfp4_matmul import ops as mm_ops  # noqa: E402
from repro_torch.layers import backends  # noqa: E402
from test_torch_cim_splitk import (  # noqa: E402
    CFGS,
    _int_sums,
    rounding_case,
)


def _packed(k: int, n: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((k, n), generator=gen) * k ** -0.5
    p = backends._quantize_packed(w)
    return p["codes"], p["exps"]


@pytest.mark.parametrize("m", [4, 96])
@pytest.mark.parametrize("k,n", [(288, 128), (1152, 64)])
def test_c_f32_out_against_reference(m, k, n):
    codes, exps = _packed(k, n, m + k)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(k)).to(
        torch.bfloat16)
    got = mm_ops.mxfp4_matmul(x, codes, exps, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    ref = np.asarray(jmm_ref.mxfp4_matmul_ref(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(codes.numpy()), jnp.asarray(exps.numpy()),
        out_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    half = mm_ops.mxfp4_matmul(x, codes, exps)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, got.to(torch.bfloat16))


def test_c_out_dtype_meta_and_cost():
    codes, exps = _packed(64, 128, 0)
    x = torch.empty((4, 64), dtype=torch.bfloat16, device="meta")
    out = mm_ops.mxfp4_matmul(x, codes.to("meta"), exps.to("meta"),
                              out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (4, 128)
    b16, _, _ = mm_ops.cost(4, 64, 128, 2)
    b32, _, _ = mm_ops.cost(4, 64, 128, 2, 4)
    assert b32 - b16 == 2 * 4 * 128
    with pytest.raises(ValueError, match="out_dtype"):
        mm_ops.mxfp4_matmul(x, codes.to("meta"), exps.to("meta"),
                            out_dtype=torch.float16)


def _slices(x, w: tmx.MXW, parts: int):
    k = w.codes.shape[0]
    ks = k // parts
    return [(x[:, i * ks:(i + 1) * ks],
             tmx.MXW(tmx.kmajor(w.codes[i * ks:(i + 1) * ks]),
                     tmx.kmajor(w.exps[i * ks // 32:(i + 1) * ks // 32])))
            for i in range(parts)]


@pytest.mark.parametrize("adc,cm,two", CFGS)
@pytest.mark.parametrize("m,k", [(4, 256), (40, 1152)])
def test_a_split_sums_read_out_bitwise(adc, cm, two, m, k):
    n = 48
    gen = torch.Generator().manual_seed(m + k + cm)
    x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
    w = tmx.quantize_w(torch.randn((k, n), generator=gen) * k ** -0.5)
    cfg = tcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    cal = tcim.calibrate_rowhist([x.float()], w, cfg)
    whole = cim_ops.cim_linear(x, w, cal, cfg=cfg)
    sums = cim_ops.cim_linear(x, w, cal, cfg=cfg, sums=True)
    assert sums.dtype == torch.int32 and sums.shape == (2, m, n)
    assert torch.equal(sums, tcim.pass_sums(x, w, cal, cfg))
    i1, i2, _ = _int_sums(x, w, int(cal.e_n), cm, np.random.default_rng(0))
    assert torch.equal(sums[0].long(), i1)
    assert torch.equal(sums[1].long(), i2 if two else torch.zeros_like(i2))
    parts = [cim_ops.cim_linear(xs, ws, cal, cfg=cfg, sums=True)
             for xs, ws in _slices(x, w, 4)]
    total = sum(parts)
    assert torch.equal(total, sums)
    assert torch.equal(tcim.read_out_sums(total, cal, cfg), whole)


@pytest.mark.parametrize("two", [True, False])
def test_a_split_sums_differ_only_in_the_rounding_row(two):
    """Row 0's ordered f32 walk rounds past 2^24 units (the one-device
    result, guarded on the card); the split integer sums are exact there,
    so the read-outs differ in that row only. Row 1 is bitwise."""
    x, w, cal = rounding_case()
    cfg = tcim.CIMConfig(adc_bits=None, cm_bits=3, two_pass=two)
    whole, _ = tcim.cim_linear(x, w, cfg, cal)
    total = sum(tcim.pass_sums(xs, ws, cal, cfg)
                for xs, ws in _slices(x, w, 4))
    assert cim_ops.needs_guard(w.codes.shape[0], 3)
    assert not cim_ops.needs_guard(w.codes.shape[0] // 4, 3)
    # 460 blocks of 32 products 144 at shift CM, then 116 of 1 unit
    assert int(total[0, 0, 0]) == 460 * 32 * 144 * 8 + 116
    exact = total[0].double() * 2.0 ** -3
    got = tcim.read_out_sums(total, cal, cfg)
    differ = (got != whole).any(-1)
    assert differ.tolist() == [True, False]
    # the one-device walk dropped the 116 small terms (half an ulp each)
    assert float(exact[0, 0] - whole[0, 0].double() / 0.25) == 116 / 8


def test_sums_dtype():
    assert tcim.sums_dtype(18432, 3) == torch.int32
    k = 2 ** 31 // (144 * 8)
    assert tcim.sums_dtype(k, 3) == torch.int32
    assert tcim.sums_dtype(k + 1, 3) == torch.int64
