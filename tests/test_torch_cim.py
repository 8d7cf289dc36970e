"""The port's analog CIM linear against the JAX reference.

The plain version of the ``cim_linear`` kernel (``repro_torch.core.cim``
blockwise) is held against ``repro.core.cim.cim_linear`` and against the
JAX Pallas kernel in interpret mode at rtol/atol 1e-5, the bound the
reference keeps between its own kernel and its jnp simulation
(``tests/test_kernels.py``), over the three (ADC, CM, two-pass) cases.
Row-Hist calibration must pick the same per-layer E_N and full scale.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cim as jcim  # noqa: E402
from repro.core import mx as jmx  # noqa: E402
from repro.kernels.cim_linear import ops as jcim_ops  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.kernels.cim_linear import ops as tcim_ops  # noqa: E402
from repro_torch.layers import backends as tbackends  # noqa: E402
from repro_torch.layers.common import RunCtx, linear_apply  # noqa: E402

CFGS = [(10, 3, True), (None, 2, False), (8, 4, True)]


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _both(x, w, adc, cm, two):
    jcfg = jcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    tcfg = tcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    jw = jmx.quantize_w(jnp.asarray(w))
    tw = tmx.quantize_w(torch.from_numpy(w))
    jcal = jcim.calibrate_rowhist([jnp.asarray(x)], jw, jcfg)
    tcal = tcim.calibrate_rowhist([torch.from_numpy(x)], tw, tcfg)
    return jcfg, tcfg, jw, tw, jcal, tcal


@pytest.mark.parametrize("m,k,n", [(16, 128, 32), (197, 64, 96)])
@pytest.mark.parametrize("adc,cm,two", CFGS)
def test_cim_linear_plain_matches_reference(m, k, n, adc, cm, two):
    x, w = _case(m, k, n, m + k + n + cm)
    jcfg, tcfg, jw, tw, jcal, tcal = _both(x, w, adc, cm, two)
    assert int(tcal.e_n) == int(jcal.e_n)
    assert float(tcal.adc_fs) == float(jcal.adc_fs)
    ref, _ = jax.jit(jcim.cim_linear, static_argnums=2)(
        jnp.asarray(x), jw, jcfg, jcal)
    got = tcim_ops.cim_linear(torch.from_numpy(x), tw, tcal, cfg=tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("adc,cm,two", CFGS)
def test_cim_linear_plain_matches_pallas_interpret(adc, cm, two):
    """The kernel's plain version against the Pallas kernel itself (the
    function the CUDA kernel replaces), run in interpret mode."""
    x, w = _case(24, 96, 48, 7 + cm)
    jcfg, tcfg, jw, tw, jcal, tcal = _both(x, w, adc, cm, two)
    ref = jcim_ops.cim_linear(jnp.asarray(x), jw, jcal, cfg=jcfg,
                              interpret=True)
    got = tcim_ops.cim_linear(torch.from_numpy(x), tw, tcal, cfg=tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_lossless_cim_equals_digital_linear():
    """No ADC and an unbounded window: the analog linear is exactly the
    digital MXFP4 W+A product (the reference's invariant)."""
    x, w = _case(8, 96, 64, 3)
    lossless = tcim.CIMConfig(adc_bits=None, cm_bits=64, two_pass=False)
    tw = tmx.quantize_w(torch.from_numpy(w))
    cal = tcim.calibrate_rowhist([torch.from_numpy(x)], tw, lossless)
    y, _ = tcim.cim_linear(torch.from_numpy(x), tw, lossless, cal)
    dig = (tmx.fake_quant(torch.from_numpy(x)).double()
           @ tmx.dequantize_w(tw).double())
    np.testing.assert_array_equal(y.numpy(), dig.float().numpy())


def test_cpu_wrapper_runs_plain_version_without_launching():
    x, w = _case(4, 64, 32, 1)
    tw = tmx.quantize_w(torch.from_numpy(w))
    cfg = tcim.CIMConfig()
    cal = tcim.calibrate_rowhist([torch.from_numpy(x)], tw, cfg)
    before = tcim_ops.cim_linear.launches
    y = tcim_ops.cim_linear(torch.from_numpy(x)[None], tw, cal, cfg=cfg)
    assert y.shape == (1, 4, 32)
    assert tcim_ops.cim_linear.launches == before
    ref, _ = tcim.cim_linear(torch.from_numpy(x), tw, cfg, cal)
    np.testing.assert_array_equal(y[0].numpy(), ref.numpy())


def test_backend_registry_names_and_errors():
    assert tbackends.backend_names() == ["cim_analog", "float_bf16",
                                         "mxfp4_ste", "mxfp4_wonly"]
    assert tbackends.get_backend("cim").name == "cim_analog"
    assert tbackends.get_backend("none").name == "float_bf16"
    assert tbackends.get_backend("mxfp4_digital").name == "mxfp4_ste"
    with pytest.raises(ValueError, match="unknown"):
        tbackends.get_backend("int3_magic")
    assert tbackends.get_backend("mxfp4_wonly").name == "mxfp4_wonly"
    with pytest.raises(NotImplementedError, match="Queue 1"):
        tbackends.get_backend("mxfp4_ste_prequant")  # training


def test_cim_backend_converted_node_and_fallback():
    """A converted node runs the analog datapath (bf16 out, bias added
    after read-out); an unconverted linear under ``cim`` runs digital
    MXFP4, exactly the ``mxfp4_ste`` backend."""
    x, w = _case(4, 64, 48, 2)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    p = {"w": torch.from_numpy(w), "b": torch.full((48,), 0.5)}
    ctx = RunCtx(quant="cim")
    cal = tcim.calibrate_rowhist([xt.float()], tmx.quantize_w(p["w"]),
                                 tcim.CIMConfig())
    node = tbackends.get_backend("cim").convert(p, cal)
    y = linear_apply(ctx, node, xt)
    ref, _ = tcim.cim_linear(xt, tmx.MXW(node["codes"], node["exps"]),
                             tcim.CIMConfig(), cal)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        y.float().numpy(), (ref.to(torch.bfloat16) + node["b"]).float().numpy())
    dig = linear_apply(dataclasses.replace(ctx, quant="mxfp4_digital"), p, xt)
    np.testing.assert_array_equal(linear_apply(ctx, p, xt).float().numpy(),
                                  dig.float().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("adc,cm,two", CFGS)
def test_cuda_kernel_matches_plain_version(adc, cm, two):
    """The CUDA kernel against its plain version on the card, odd M
    (padded to the row tile) and a partial column tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, w = _case(13, 96, 200, 11 + cm)
    cfg = tcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    xt = torch.from_numpy(x).cuda()
    tw = tmx.quantize_w(torch.from_numpy(w).cuda())
    cal = tcim.calibrate_rowhist([xt], tw, cfg)
    before = tcim_ops.cim_linear.launches
    got = tcim_ops.cim_linear(xt, tw, cal, cfg=cfg)
    assert tcim_ops.cim_linear.launches == before + 1
    ref, _ = tcim.cim_linear(xt, tw, cfg, cal)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
