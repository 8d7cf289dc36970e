"""No kernel of the port hands autograd an output without a gradient.

The five CUDA kernels have no backward, as the Pallas kernels they
replace have none. Each wrapper raises on CUDA inputs that need a
gradient (grad mode on and a floating input with ``requires_grad``), and
a differentiable prefill past ``dense_attn_max`` takes the torch-op
``_flash_attn``, the function the reference's training differentiates.
This file imports no JAX: its ``cuda``-marked test runs on the card.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers.common import RunCtx  # noqa: E402


def test_needs_grad():
    x = torch.ones(3, requires_grad=True)
    assert _build.needs_grad(torch.ones(3), x)
    assert not _build.needs_grad(torch.ones(3),
                                 torch.ones(3, dtype=torch.int8))
    with torch.no_grad():
        assert not _build.needs_grad(x)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("k", x)
    _build.refuse_grad("k", x.detach())


def test_flash_kernel_route_declines_under_autograd():
    cfg = tattn.AttnStatic(d_model=64, n_heads=4, n_kv=2, head_dim=16)
    ctx = RunCtx(dense_attn_max=8, arange_positions=True)
    assert tattn._takes_flash_kernel(ctx, cfg, "cuda", False, 9)
    assert not tattn._takes_flash_kernel(ctx, cfg, "cuda", False, 9,
                                         grad=True)


def _inputs(dev, grad: bool):
    """One call's inputs of each wrapper on ``dev``, the float ones
    requiring grad when ``grad``."""
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.paged_attention import layout

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=g).to(dtype).to(dev)
        return t.requires_grad_(grad)

    w = torch.randn((64, 64), generator=g)
    packed = {"codes": torch.randint(0, 256, (32, 64), dtype=torch.uint8,
                                     generator=g).to(dev),
              "exps": torch.full((2, 64), 127, dtype=torch.uint8).to(dev)}
    kv = torch.randn((2, 16, 4, 64), generator=g).to(torch.bfloat16).to(dev)
    quant = layout.quant_page_full(*layout.split_kv(kv))
    cal = cimlib.LayerCalib(e_n=torch.tensor(0, dtype=torch.int32),
                            adc_fs=torch.tensor(64.0))
    wq = mxlib.quantize_w(w)
    return {
        "cim_linear": lambda ops: ops.cim_linear(
            rnd(4, 64, dtype=torch.float32), mxlib.MXW(
                wq.codes.to(dev), wq.exps.to(dev)),
            cimlib.LayerCalib(cal.e_n.to(dev), cal.adc_fs.to(dev))),
        "mxfp4_matmul": lambda ops: ops.mxfp4_matmul(
            rnd(4, 64), packed["codes"], packed["exps"]),
        "paged_decode": lambda ops: ops.paged_flash_decode(
            rnd(2, 2, 2, 64), kv.requires_grad_(grad),
            torch.tensor([0, 1]).to(dev), torch.tensor([3, 16]).to(dev),
            scale=0.125),
        "paged_decode_mx": lambda ops: ops.paged_flash_decode_mx(
            rnd(2, 2, 2, 64), {k: v.to(dev) for k, v in quant.items()},
            torch.tensor([0, 1]).to(dev), torch.tensor([3, 16]).to(dev),
            scale=0.125),
        "flash_attention": lambda ops: ops.flash_attention(
            rnd(1, 24, 4, 64), rnd(1, 24, 2, 64), rnd(1, 24, 2, 64)),
    }


def _ops(name):
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    return {"cim_linear": cim_ops, "mxfp4_matmul": mm_ops,
            "paged_decode": pa_ops, "paged_decode_mx": pa_ops,
            "flash_attention": fa_ops}[name]


@pytest.mark.parametrize("name", ["cim_linear", "mxfp4_matmul",
                                  "paged_decode", "paged_decode_mx",
                                  "flash_attention"])
def test_cpu_wrappers_run_their_plain_versions_under_grad(name):
    """On CPU tensors a wrapper runs its plain version, a composition of
    torch ops that autograd handles like any other: nothing to refuse."""
    out = _inputs("cpu", grad=True)[name](_ops(name))
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cim_linear", "mxfp4_matmul",
                                  "paged_decode", "paged_decode_mx",
                                  "flash_attention"])
def test_cuda_wrappers_raise_on_inputs_that_require_grad(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ops, dev = _ops(name), torch.device("cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        _inputs(dev, grad=True)[name](ops)
    with torch.no_grad():  # the serving paths: launched as before
        _inputs(dev, grad=True)[name](ops)
    _inputs(dev, grad=False)[name](ops)
    torch.cuda.synchronize()
