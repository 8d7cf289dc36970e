"""The port's remaining numerics against the JAX reference.

The same numpy-seeded inputs go through ``repro.core`` and
``repro_torch.core``:

- MXFP4 (``core/mx.py``): ``quantize_e2m1`` on every tie point and both
  signs, the unsigned INT5 weight encoding, ``to_bf16`` and
  ``mx_dot_bf16`` (both accumulations): bitwise;
  ``bucket_counts`` and ``quant_health``: integer-exact, including
  all-zero input, clipped and underflowing elements and the subnormal
  floor (under ``torch.set_flush_denormal``, as XLA on the CPU flushes).
- CIM (``core/cim.py``): ``bitplane_dot`` exact against the direct
  integer dot; ``cim_linear_unsigned`` bitwise the port's ``cim_linear``
  (and the reference's); the online ``row0`` / ``row_opt`` strategies
  bitwise the reference's (an even block count pins ``jnp.median``'s
  mean of the two middle values, truncated toward zero) and worse than
  ``row_hist`` (``tests/test_cim.py``); percentile calibration gives the
  reference's ``e_n`` and ``adc_fs``, a batch with dead blocks included;
  ``adc_health`` integer-exact, with samples exactly at +-full scale
  (quantization error, not saturation) and the ADC model off.
- Digital attention (``core/digital.py``): ``mx_attention`` at the
  tolerance of ``tests/test_digital.py`` (3e-2), ``attention_ref`` at
  f32 rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cim as jcim  # noqa: E402
from repro.core import digital as jdig  # noqa: E402
from repro.core import mx as jmx  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.core import digital as tdig  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.obs import EXP_BUCKETS, RATIO_BUCKETS  # noqa: E402

HEALTH_KEYS = ("total", "clipped", "underflow", "exp_counts", "exp_sum",
               "exp_n", "exp_min", "exp_max")


def _t(a):
    return torch.from_numpy(np.array(a))


def _both_w(w: np.ndarray):
    return tmx.quantize_w(_t(w)), jmx.quantize_w(jnp.asarray(w))


def _setup(seed=0, t=8, k=96, m=16, xscale=1.0):
    """``tests/test_cim.py``'s layer: x [t, k], w [k, m] quantized."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, k)) * xscale).astype(np.float32)
    w = rng.standard_normal((k, m)).astype(np.float32)
    tw, jw = _both_w(w)
    return x, tw, jw


def _jcalib(c: tcim.LayerCalib) -> jcim.LayerCalib:
    return jcim.LayerCalib(jnp.int32(int(c.e_n)), jnp.float32(float(c.adc_fs)))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------------ MXFP4

def test_quantize_e2m1_bitwise():
    ties = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 7.0], np.float32)
    grid = np.array([0, 0.5, 1, 1.5, 2, 3, 4, 6], np.float32)
    rng = np.random.default_rng(0)
    y = np.concatenate([ties, -ties, grid, -grid, [8.0, 100.0, 1e-30, 0.0],
                        rng.uniform(-7, 7, 200).astype(np.float32)])
    y = y.astype(np.float32)
    got = tmx.quantize_e2m1(_t(y))
    assert got.dtype == torch.int8
    ref = jmx.quantize_e2m1(jnp.asarray(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # ties to even on the local grid; clamp at 6
    assert got[:8].tolist() == [0, 2, 2, 4, 4, 8, 8, 12]


def test_unsigned_weight_encoding_bitwise():
    x = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)
    tq, jq = tmx.quantize(_t(x)), jmx.quantize(jnp.asarray(x))
    tu, ju = tmx.encode_weight_unsigned(tq), jmx.encode_weight_unsigned(jq)
    assert tu.dtype == torch.uint8
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert int(tu.min()) >= 0 and int(tu.max()) <= 24
    back = tmx.decode_weight_unsigned(tu)
    np.testing.assert_array_equal(back.numpy(), tq.codes.numpy())
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jmx.decode_weight_unsigned(ju)))


@pytest.mark.parametrize("bf16_partials", [False, True])
def test_mx_dot_bf16_bitwise(bf16_partials):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((4, 64)).astype(np.float32)
    b = rng.standard_normal((64, 8)).astype(np.float32)
    tb, jb = _both_w(b)
    got = tmx.mx_dot_bf16(tmx.quantize(_t(a)), tb, bf16_partials)
    ref = jmx.mx_dot_bf16(jmx.quantize(jnp.asarray(a)), jb, bf16_partials)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))
    np.testing.assert_array_equal(
        tmx.to_bf16(_t(a)).view(torch.int16).numpy(),
        np.asarray(jmx.to_bf16(jnp.asarray(a))).view(np.int16))


def test_bucket_counts_matches_reference():
    rng = np.random.default_rng(0)
    v = rng.integers(-30, 30, size=257).astype(np.float32)
    v[:4] = [-24.0, 16.0, 16.5, -100.0]  # on a boundary, past the last
    w = (rng.random(257) < 0.7).astype(np.int32)
    for weights in (None, w):
        got = tmx.bucket_counts(_t(v), EXP_BUCKETS,
                                None if weights is None else _t(weights))
        ref = jmx.bucket_counts(jnp.asarray(v), EXP_BUCKETS,
                                None if weights is None
                                else jnp.asarray(weights))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum()) == int(w.sum())
    assert tmx.bucket_counts(_t(v), ()).tolist() == [v.size]


def _health_cases():
    rng = np.random.default_rng(3)
    edge = np.zeros((2, tmx.BLOCK), np.float32)
    edge[0, 0], edge[0, 1] = 1.0, 1e-8  # 1e-8 underflows next to 1.0
    edge[1, :] = 3e38  # beyond 6 * 2^125: clipped
    return {"random": rng.standard_normal((6, 80)).astype(np.float32)
            * np.float32(4.0),
            "wide": rng.standard_normal((3, 64)).astype(np.float32)
            * np.float32(2.0) ** rng.integers(-30, 20, (3, 64)),
            "edge": edge,
            "zero": np.zeros((1, tmx.BLOCK), np.float32)}


@pytest.mark.parametrize("name", list(_health_cases()))
def test_quant_health_matches_reference(name):
    x = _health_cases()[name]
    got = tmx.quant_health(_t(x), EXP_BUCKETS)
    ref = jax.device_get(jmx.quant_health(jnp.asarray(x), EXP_BUCKETS))
    for key in HEALTH_KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)
    if name == "edge":
        assert int(got["underflow"]) == 1
        assert int(got["clipped"]) == tmx.BLOCK
        assert (int(got["exp_min"]), int(got["exp_max"])) == (-2, 125)
    if name == "zero":
        assert int(got["clipped"]) == int(got["underflow"]) == 0
        assert int(got["exp_n"]) == 0


def test_quant_health_subnormal_floor_under_flush_denormal():
    x = (np.random.default_rng(4).standard_normal((4, 32)).astype(np.float32)
         * np.float32(2e-38))
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush denormals")
    try:
        got = tmx.quant_health(_t(x), EXP_BUCKETS)
    finally:
        torch.set_flush_denormal(False)
    ref = jax.device_get(jmx.quant_health(jnp.asarray(x), EXP_BUCKETS))
    for key in HEALTH_KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)


# -------------------------------------------------------------------- CIM

def test_bitplane_dot_exact():
    rng = np.random.default_rng(1)
    cx = rng.integers(-12, 13, size=(5, 32)).astype(np.int8)
    cw = rng.integers(-12, 13, size=(5, 32)).astype(np.int8)
    direct = np.sum(cx.astype(np.int64) * cw.astype(np.int64), axis=-1)
    got = tcim.bitplane_dot(_t(cx), _t(cw))
    np.testing.assert_array_equal(got.numpy().astype(np.float64),
                                  direct.astype(np.float64))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcim.bitplane_dot(jnp.asarray(cx),
                                                  jnp.asarray(cw))))


@pytest.mark.parametrize("cm,adc", [(3, None), (3, 10), (2, 8)])
def test_cim_linear_unsigned_bitwise(cm, adc):
    """Unsigned [0, 24] weights plus the bias column == the signed path,
    bit for bit, and the reference's unsigned variant."""
    x, tw, jw = _setup(seed=6)
    cfg = tcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=True)
    calib = tcim.calibrate_rowhist([_t(x)], tw, cfg)
    y_s, _ = tcim.cim_linear(_t(x), tw, cfg, calib)
    y_u = tcim.cim_linear_unsigned(_t(x), tw, cfg, calib)
    np.testing.assert_array_equal(_bits(y_u), _bits(y_s))
    jcfg = jcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=True)
    ref = jcim.cim_linear_unsigned(jnp.asarray(x), jw, jcfg, _jcalib(calib))
    np.testing.assert_array_equal(_bits(y_u), _bits(ref))


@pytest.mark.parametrize("k", [96, 128])  # 3 and 4 blocks: odd, even
@pytest.mark.parametrize("strategy,offset",
                         [("row0", 0), ("row_opt", 0), ("row_opt", 1)])
@pytest.mark.parametrize("two_pass", [True, False])
def test_online_strategies_match_reference(strategy, offset, k, two_pass):
    x, tw, jw = _setup(seed=9, t=32, k=k)
    kw = dict(adc_bits=None, cm_bits=3, two_pass=two_pass, strategy=strategy,
              strategy_offset=offset, collect_stats=True)
    y, st = tcim.cim_linear(_t(x), tw, tcim.CIMConfig(**kw))
    jy, jst = jcim.cim_linear(jnp.asarray(x), jw, jcim.CIMConfig(**kw))
    np.testing.assert_array_equal(_bits(y), _bits(jy))
    assert st.keys() == jst.keys()
    for key in st:
        assert float(st[key]) == pytest.approx(float(jst[key]), rel=1e-6)


def test_row_opt_median_of_even_count_truncates_toward_zero():
    """Four blocks: the median is the mean of the two middle exponents,
    and -2.5 truncates to -2 (not -3), as ``jnp.median(...).astype``."""
    es = np.array([[[-3, 4, 0], [-2, 1, 5], [-9, 3, 6], [7, 2, -8]]],
                  np.int32)  # [1, nb=4, N=3]
    cfg = tcim.CIMConfig(strategy="row_opt")
    got = tcim._target_exponent(cfg, None, _t(es))
    ref = jcim._target_exponent(jcim.CIMConfig(strategy="row_opt"), None,
                                jnp.asarray(es))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.reshape(-1).tolist() == [-2, 2, 2]


def test_online_strategies_run_and_are_worse():
    """Row0 / RowOpt underperform Row-Hist (Fig 5), as in the reference's
    ``tests/test_cim.py``."""
    x, tw, jw = _setup(seed=9, t=32)
    ref = (tmx.dequantize(tmx.quantize(_t(x)), out_len=96)
           @ tmx.dequantize_w(tw)).numpy()

    def err(cfg, calib=None):
        y, _ = tcim.cim_linear(_t(x), tw, cfg, calib)
        return float(np.mean((y.numpy() - ref) ** 2))

    cfg_rh = tcim.CIMConfig(adc_bits=None, cm_bits=3, two_pass=True)
    e_rh = err(cfg_rh, tcim.calibrate_rowhist([_t(x)], tw, cfg_rh))
    e_r0 = err(tcim.CIMConfig(adc_bits=None, cm_bits=3, strategy="row0"))
    e_ro = err(tcim.CIMConfig(adc_bits=None, cm_bits=3, strategy="row_opt"))
    assert e_rh <= e_r0 and e_rh <= e_ro, (e_rh, e_r0, e_ro)


@pytest.mark.parametrize("seed", [0, 3])  # seed 0 has a dead block, 3 none
@pytest.mark.parametrize("percentile", [50.0, 90.0, 99.0])
def test_percentile_calibration_matches_reference(seed, percentile):
    x, tw, jw = _setup(seed=seed)
    s, _ = tcim._block_partials(_t(x), tw)
    assert bool((s == 0).any()) == (seed == 0)
    cfg = tcim.CIMConfig()
    got = tcim.calibrate_rowhist([_t(x)], tw, cfg, percentile=percentile)
    ref = jcim.calibrate_rowhist([jnp.asarray(x)], jw, jcim.CIMConfig(),
                                 percentile=percentile)
    assert int(got.e_n) == int(ref.e_n)
    assert _bits(got.adc_fs) == _bits(ref.adc_fs)
    assert got.e_n.dtype == torch.int32


def test_adc_health_matches_reference():
    rng = np.random.default_rng(5)
    fs = np.float32(40.0)
    c = (rng.standard_normal((6, 50)) * 20).astype(np.float32)
    c[0, :4] = [fs, -fs, fs * 1.5, -fs * 2]  # at +-fs: not saturated
    for bits in (10, 6, None):
        got = tcim.adc_health(_t(c), torch.tensor(fs), bits, RATIO_BUCKETS)
        ref = jax.device_get(jcim.adc_health(jnp.asarray(c), fs, bits,
                                             RATIO_BUCKETS))
        for key in ("total", "saturated", "occ_counts", "occ_n", "peak",
                    "occ_min", "occ_max"):
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(ref[key]), err_msg=key)
        assert float(got["occ_sum"]) == pytest.approx(float(ref["occ_sum"]),
                                                      rel=1e-6)
        want = 0 if bits is None else int(np.sum(np.abs(c) > fs * 1.001))
        assert int(got["saturated"]) == want


# ---------------------------------------------------------------- digital

def _qkv(seed, b=2, s=48, d=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, d)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("causal,tile,quantize_sv,s", [
    (False, 64, True, 48), (True, 64, True, 48), (True, 16, True, 64),
    (False, 16, False, 64), (True, 32, False, 40)])
def test_mx_attention_matches_reference(causal, tile, quantize_sv, s):
    q, k, v = _qkv(s, s=s)
    got = tdig.mx_attention(_t(q), _t(k), _t(v), causal=causal, tile=tile,
                            quantize_sv=quantize_sv)
    ref = jdig.mx_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, tile=tile, quantize_sv=quantize_sv)
    assert got.dtype == torch.bfloat16 and got.shape == (2, s, 32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_ref_matches_reference(causal):
    q, k, v = _qkv(7)
    got = tdig.attention_ref(_t(q), _t(k), _t(v), causal=causal)
    ref = jdig.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
