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

from torch_one_thread import one_torch_thread  # noqa: E402,F401

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
                                         "mxfp4_ste", "mxfp4_ste_prequant",
                                         "mxfp4_wonly"]
    assert tbackends.get_backend("cim").name == "cim_analog"
    assert tbackends.get_backend("none").name == "float_bf16"
    assert tbackends.get_backend("mxfp4_digital").name == "mxfp4_ste"
    with pytest.raises(ValueError, match="unknown"):
        tbackends.get_backend("int3_magic")
    assert tbackends.get_backend("mxfp4_wonly").name == "mxfp4_wonly"
    # training: the weights arrive prequantized (bf16), the activations
    # are fake-quantized here, as the reference's backend does
    pre = tbackends.get_backend("mxfp4_ste_prequant")
    assert pre.name == "mxfp4_ste_prequant"
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 64)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 32)).astype(np.float32))
    wq = tmx.fake_quant_axis(w, 0).to(torch.bfloat16)
    ste = tbackends.get_backend("mxfp4_ste").forward(None, {"w": w}, x)
    assert torch.equal(pre.forward(None, {"w": wq}, x), ste)


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


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cuda_case(m, k, n, seed, cfg, x_dtype=torch.float32):
    """x and K-major weights on the card, calibrated on x."""
    x, w = _case(m, k, n, seed)
    dev = _cuda()
    xt = torch.from_numpy(x).to(dev, x_dtype)
    tw = tmx.quantize_w(torch.from_numpy(w / np.sqrt(k)).to(dev))
    return xt, tw, tcim.calibrate_rowhist([xt.float()], tw, cfg)


def _kernel_vs_plain(xt, tw, cal, cfg):
    route = tcim_ops.pick_route(xt.shape[0], *tw.codes.shape)
    before = tcim_ops.cim_linear.launches
    before_route = tcim_ops.cim_linear.route_launches[route]
    got = tcim_ops.cim_linear(xt, tw, cal, cfg=cfg)
    assert tcim_ops.cim_linear.launches == before + 1
    assert tcim_ops.cim_linear.route_launches[route] == before_route + 1
    ref, _ = tcim.cim_linear(xt, tw, cfg, cal)
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("adc,cm,two", CFGS)
def test_cuda_kernel_matches_plain_version(adc, cm, two):
    """The CUDA kernel against its plain version on the card, bitwise: odd
    M (masked in the row tile) and a partial column tile."""
    cfg = tcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    xt, tw, cal = _cuda_case(13, 96, 200, 11 + cm, cfg)
    got, ref = _kernel_vs_plain(xt, tw, cal, cfg)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 13, 192])
@pytest.mark.parametrize("k,n", [(640, 200), (4608, 520), (1024, 1100)])
@pytest.mark.parametrize("adc,cm,two", CFGS)
def test_cuda_splitk_bitwise(m, k, n, adc, cm, two):
    """Bitwise at decode and prefill row counts, N not a multiple of the
    column tile (64 or 256), K split over blocks (pick_splits > 1 at small
    M) or not, on every (ADC, CM, two-pass) case."""
    cfg = tcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    xt, tw, cal = _cuda_case(m, k, n, m + k + n + cm, cfg)
    got, ref = _kernel_vs_plain(xt, tw, cal, cfg)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 64, 100, 192])
@pytest.mark.parametrize("adc,cm,two", CFGS)
def test_cuda_both_routes_bitwise(m, adc, cm, two):
    """Each route named on the same input, bitwise the plain version: the
    tensor-core route on rows it would not be picked for (16) and on ragged
    row and column tiles (M = 100, N = 1100)."""
    cfg = tcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    xt, tw, cal = _cuda_case(m, 1024, 1100, m + cm, cfg)
    ref, _ = tcim.cim_linear(xt, tw, cfg, cal)
    for route in tcim_ops.ROUTES:
        got = tcim_ops._launch(xt, tw, cal, cfg, route=route)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), route


@pytest.mark.cuda
def test_cuda_bf16_activations():
    """bf16 activations go in as they are, the same function as their f32
    values."""
    cfg = tcim.CIMConfig()
    for m, n in ((4, 512), (192, 2048)):  # both routes
        xt, tw, cal = _cuda_case(m, 4608, n, 21, cfg, torch.bfloat16)
        got, ref = _kernel_vs_plain(xt, tw, cal, cfg)
        assert torch.equal(got, ref)
        assert torch.equal(got, tcim_ops.cim_linear(xt.float(), tw, cal,
                                                    cfg=cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 13])
def test_cuda_guard_rows_at_k18432(m):
    """K = 18432 at CM = 3 needs the guard: random rows stay on the integer
    sums (none guarded), and the constructed rows whose ordered f32 sum
    rounds take the ordered walk on the card, bitwise the plain version."""
    from test_torch_cim_splitk import rounding_case

    dev = _cuda()
    cfg = tcim.CIMConfig(adc_bits=None, cm_bits=3)
    assert tcim_ops.needs_guard(18432, 3)
    xr, wr, calr = rounding_case(n=300)
    xr = xr.to(dev)
    wr = tmx.MXW(wr.codes.to(dev), wr.exps.to(dev))
    calr = tcim.LayerCalib(calr.e_n.to(dev), calr.adc_fs.to(dev))
    counter = tcim_ops.guard_rows(dev)
    for x, rows in ((xr, 1), (xr[[1, 0, 1, 1]], 1),
                    (torch.randn((m, 18432), device=dev), 0)):
        w, cal = wr, calr
        if rows == 0:
            w = tmx.quantize_w(torch.randn((18432, 300), device=dev) / 136)
            cal = tcim.calibrate_rowhist([x], w, cfg)
        counter.zero_()
        got, ref = _kernel_vs_plain(x, w, cal, cfg)
        assert torch.equal(got, ref)
        assert int(counter) == rows


@pytest.mark.cuda
def test_cuda_rejects_n_contiguous_codes():
    cfg = tcim.CIMConfig()
    xt, tw, cal = _cuda_case(4, 96, 64, 3, cfg)
    with pytest.raises(ValueError, match="K-major"):
        tcim_ops.cim_linear(xt, tmx.MXW(tw.codes.contiguous(), tw.exps), cal,
                            cfg=cfg)
