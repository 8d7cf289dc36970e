"""The port's MXFP4 numerics against the JAX reference: bitwise.

The same numpy inputs (seeded) go through ``repro.core.mx`` and
``repro_torch.core.mx``; codes, exponents, packed bytes and
fake-quantized values must be identical bit for bit. The edge cases are
those of ``tests/test_fusedpath.py`` (random blocks over many scales, the
E2M1 tie points of every binade, a block max one ulp below a power of
two, zero blocks and both E8M0 clamp ends).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import mx as jmx  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402

# one compiled graph per reference function (eager JAX compiles op by op)
j_quantize = jax.jit(jmx.quantize)
j_fake_quant = jax.jit(jmx.fake_quant)
j_fake_quant_axis = jax.jit(jmx.fake_quant_axis, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _bf16_bits(a) -> np.ndarray:
    """bf16 values (jax array or torch tensor) -> uint16 bit patterns."""
    if torch.is_tensor(a):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _assert_quantize_bitwise(x: np.ndarray):
    j = j_quantize(jnp.asarray(x))
    t = tmx.quantize(_t(x))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.exps.numpy(), np.asarray(j.exps))
    np.testing.assert_array_equal(
        tmx.fake_quant(_t(x)).numpy().view(np.uint32),
        np.asarray(j_fake_quant(jnp.asarray(x))).view(np.uint32))


def _edge_cases():
    rng = np.random.default_rng(0)
    cases = {}
    for scale in (1.0, 1e-3, 1e3, 1e30, 1e-30):
        cases[f"random_{scale:g}"] = (
            rng.standard_normal((16, 96)).astype(np.float32) * np.float32(scale))
    ties = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 7.0], np.float32)
    for e in (-20, -2, 0, 3, 19):
        row = np.tile(ties, 4) * np.float32(2.0 ** e)
        row[0] = 6.0 * 2.0 ** e  # anchor amax so ties stay ties
        cases[f"ties_2^{e}"] = row[None]
    x = rng.choice(ties, size=(8, 32)) * rng.choice([-1.0, 1.0], (8, 32))
    x[:, 0] = 6.0
    cases["ties_signed"] = x.astype(np.float32)
    edge = np.zeros((3, 32), np.float32)
    edge[0, 0] = np.nextafter(np.float32(4.0), np.float32(0.0))
    edge[1, 0] = 4.0
    edge[2, 0] = np.nextafter(np.float32(4.0), np.float32(8.0))
    cases["binade_edges"] = edge
    cases["zero"] = np.zeros((2, 64), np.float32)
    cases["huge"] = (rng.uniform(0.5, 2.0, (4, 32)).astype(np.float32)
                     * np.float32(1.5e38)
                     * rng.choice([-1.0, 1.0], (4, 32)).astype(np.float32))
    cases["odd_width"] = rng.standard_normal((5, 45)).astype(np.float32)
    return cases


CASES = _edge_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_quantize_and_fake_quant_bitwise(name):
    _assert_quantize_bitwise(CASES[name])


def test_subnormal_floor_bitwise_under_flush_denormal():
    """Blocks on the E8M0 floor with subnormal values: XLA on the CPU
    flushes subnormals (FTZ/DAZ); under ``torch.set_flush_denormal`` the
    port matches it bitwise. (The CUDA kernels keep IEEE subnormals.)"""
    rng = np.random.default_rng(2)
    tiny = rng.standard_normal((4, 32)).astype(np.float32) * np.float32(2e-38)
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush denormals")
    try:
        _assert_quantize_bitwise(tiny)
    finally:
        torch.set_flush_denormal(False)


def test_clamp_edge_values():
    t = tmx.quantize(_t(CASES["binade_edges"]))
    assert int(t.codes[0, 0]) == 12 and int(t.exps[0, 0]) == -1
    assert int(tmx.quantize(_t(CASES["huge"])).exps.max()) == 125
    np.testing.assert_array_equal(
        tmx.quantize(_t(CASES["zero"])).exps.numpy(),
        np.full((2, 2), tmx.E8M0_MIN, np.int8))


@pytest.mark.parametrize("shape,axis", [((2, 48, 4, 16), 1), ((3, 70), 0),
                                        ((2, 5, 64), -1)])
def test_fake_quant_axis_bitwise_f32_and_bf16(shape, axis):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        tmx.fake_quant_axis(_t(x), axis).numpy().view(np.uint32),
        np.asarray(j_fake_quant_axis(jnp.asarray(x), axis)).view(np.uint32))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = _t(np.asarray(xb).view(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal(
        _bf16_bits(tmx.fake_quant_axis(tb, axis)),
        _bf16_bits(j_fake_quant_axis(xb, axis)))
    np.testing.assert_array_equal(  # last axis: the bf16-native chain
        _bf16_bits(tmx.fake_quant(tb)), _bf16_bits(j_fake_quant(xb)))


def test_quantize_w_pack_and_pair_table_bitwise():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    jw, tw = jax.jit(jmx.quantize_w)(jnp.asarray(w)), tmx.quantize_w(_t(w))
    np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(tw.exps.numpy(), np.asarray(jw.exps))
    np.testing.assert_array_equal(
        tmx.dequantize_w(tw).numpy(), np.asarray(jax.jit(jmx.dequantize_w)(jw)))
    codes = np.asarray(j_quantize(jnp.asarray(w)).codes)
    jp = np.asarray(jax.jit(jmx.pack_codes)(jnp.asarray(codes)))
    tp = tmx.pack_codes(_t(codes))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tmx.unpack_codes(tp).numpy(), codes)
    np.testing.assert_array_equal(tmx.PAIR_TABLE, jmx.PAIR_TABLE)
    np.testing.assert_array_equal(
        _bf16_bits(tmx.unpack_pairs_bf16(tp)),
        _bf16_bits(jax.jit(jmx.unpack_pairs_bf16)(jnp.asarray(jp))))
    e = rng.integers(-127, 128, (7, 9)).astype(np.int8)
    np.testing.assert_array_equal(tmx.exps_to_biased(_t(e)).numpy(),
                                  np.asarray(jmx.exps_to_biased(jnp.asarray(e))))
    np.testing.assert_array_equal(
        tmx.exps_from_biased(tmx.exps_to_biased(_t(e))).numpy(), e)


def test_exp2i_and_floor_ilog2_bitwise():
    e = np.arange(-252, 253, dtype=np.int32)
    np.testing.assert_array_equal(
        tmx.exp2i(_t(e)).numpy().view(np.uint32)[e >= -126],
        np.asarray(jmx.exp2i(jnp.asarray(e))).view(np.uint32)[e >= -126])
    x = np.abs(np.random.default_rng(5).standard_normal(1000)).astype(np.float32)
    np.testing.assert_array_equal(tmx.floor_ilog2(_t(x)).numpy(),
                                  np.asarray(jmx.floor_ilog2(jnp.asarray(x))))


def test_fake_quant_is_straight_through():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    (tmx.fake_quant(x) * 3.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full((4, 64), 3.0))
