"""The port's ViT (``repro_torch.models.vit``) against the JAX reference
on the tiny vision config (``tiny_vit(vit-b16)``: 32 px, 8 px patches, 17
tokens, 2 layers, d 64).

The reference initialises, calibrates (``convert_model_cim(...,
forward_fn=vit.forward)``) and packs (``convert_params_mxfp4``, jitted)
the model on fixed numpy images; its trees cross into the port through
``repro_torch.convert.from_reference``. The reference runs eagerly with
``unroll_layers=True``, the mode in which it pins bitwise MXFP4 identity.
Bounds:

- ``patchify``: bitwise.
- Logits under float, ``mxfp4`` (packed weight-only) and ``cim`` (hybrid
  analog): SQNR >= 30 dB, the bound of the LM tests.
- Row-Hist calibration from the same float weights and images: the
  reference's paths (patch, trunk, head), E_N and ADC full scales, exactly.

Port-only invariants: a lossless CIM config gives the port's digital
MXFP4 ViT; the chip chain (``split_chips`` + ``forward_chip``) is bitwise
the monolithic forward under float and ``cim``; dense and online-softmax
attention agree on the bidirectional encoder at token counts that are not
a multiple of the chunk. The ``cuda``-marked tests hold the kernels at the
ViT's shapes against their plain versions on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import cim as jcim  # noqa: E402
from repro.layers.common import RunCtx as JCtx, ShardingCtx  # noqa: E402
from repro.layers.common import (  # noqa: E402
    convert_params_mxfp4 as jconvert_mxfp4,
)
from repro.models import calibrate as jcalibrate  # noqa: E402
from repro.models import vit as jvit  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.kernels.cim_linear import ops as tcim_ops  # noqa: E402
from repro_torch.kernels.mxfp4_matmul import ops as tmm_ops  # noqa: E402
from repro_torch.kernels.mxfp4_matmul import ref as tmm_ref  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import backends as tbackends  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.models import vit as tvit  # noqa: E402

JCFG = jconfigs.tiny_vit(jconfigs.VISION_ARCHS["vit-b16"])
TCFG = tconfigs.tiny_vit(tconfigs.VIT_B16)
IMG = np.random.default_rng(0).standard_normal(
    (2, JCFG.image_size, JCFG.image_size, 3)).astype(np.float32)
CIM = dict(quant="cim", cim=tcim.CIMConfig())


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _images() -> dict:
    return {"images": torch.from_numpy(IMG)}


@pytest.fixture(scope="module")
def models():
    jctx = JCtx(shd=ShardingCtx(), dense_attn_max=256)
    params, _ = jvit.init_model(jax.random.PRNGKey(0), JCFG)
    batches = [{"images": jnp.asarray(IMG)}]
    conv, calibs = jcalibrate.convert_model_cim(
        params, JCFG, jctx, batches, cim_cfg=jcim.CIMConfig(), min_n=32,
        forward_fn=jvit.forward)
    # packing is a pure function of the weights: jitted, it gives the
    # eager conversion's tree bit for bit, in a second instead of twenty
    packed = jax.jit(lambda p: jconvert_mxfp4(p, min_n=32))(params)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(jctx=jctx, j={"float": params, "mxfp4": packed, "cim": conv},
                jcalibs=calibs,
                t={"float": from_reference(to_np(params), device="cpu"),
                   "mxfp4": from_reference(to_np(packed), device="cpu"),
                   "cim": from_reference(to_np(conv), device="cpu")})


def test_config_fields_match_reference():
    for name, tcfg in tconfigs.VISION_ARCHS.items():
        jcfg = jconfigs.VISION_ARCHS[name]
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert (tcfg.seq_len, tcfg.patch_dim) == (jcfg.seq_len, jcfg.patch_dim)
        for shrink in ("tiny_vit", "geometry_tiny_vit"):
            assert dataclasses.asdict(getattr(tconfigs, shrink)(tcfg)) == \
                dataclasses.asdict(getattr(jconfigs, shrink)(jcfg))
    assert (tconfigs.VIT_B16.seq_len, tconfigs.VIT_L32.seq_len) == (197, 145)


@pytest.mark.parametrize("patch", [4, 8])
def test_patchify_bitwise(patch):
    got = tvit.patchify(torch.from_numpy(IMG), patch)
    ref = jvit.patchify(jnp.asarray(IMG), patch)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_from_reference_carries_vit_tree(models):
    """The reference's ViT tree (patch, cls, pos, final_ln, head, one
    stacked segment) crosses with the segment unstacked; CIM nodes keep
    their per-layer calibration and K-major codes."""
    for kind, tree in models["t"].items():
        assert set(tree) == {"patch", "cls", "pos", "segments", "final_ln",
                             "head"}, kind
        assert tuple(tree["cls"].shape) == (1, 1, TCFG.d_model)
        assert tuple(tree["pos"].shape) == (1, TCFG.seq_len, TCFG.d_model)
        assert len(tree["segments"]) == 1
        assert len(tree["segments"][0]) == TCFG.n_layers
    jconv, tconv = models["j"]["cim"], models["t"]["cim"]
    for j, layer in enumerate(tconv["segments"][0]):
        node = layer["ffn"]["w1"]
        assert tuple(node["codes"].shape) == (TCFG.d_model, TCFG.d_ff)
        assert node["codes"].stride() == (1, TCFG.d_model)  # K-major
        assert int(node["e_n"]) == int(
            jconv["segments"][0]["ffn"]["w1"]["e_n"][j])
    for name in ("patch", "head"):
        assert tconv[name]["e_n"].shape == ()
        assert "codes" in models["t"]["mxfp4"][name]


@pytest.mark.parametrize("kind", ["float", "mxfp4", "cim"])
def test_forward_matches_reference(models, kind):
    quant = {"float": {}, "mxfp4": dict(quant="mxfp4_wonly"),
             "cim": dict(quant="cim", cim=jcim.CIMConfig())}[kind]
    jctx = dataclasses.replace(models["jctx"], unroll_layers=True, **quant)
    tctx = TCtx(dense_attn_max=256, **(CIM if kind == "cim" else
                                       {"quant": quant.get("quant", "none")}))
    ref, jcache = jvit.forward(models["j"][kind], JCFG, jctx,
                               {"images": jnp.asarray(IMG)})
    got, tcache = tvit.forward(models["t"][kind], TCFG, tctx, _images())
    assert jcache is None and tcache is None
    assert tuple(got.shape) == (2, TCFG.n_classes)
    assert got.dtype == torch.bfloat16
    assert _sqnr_db(ref, got.float()) >= 30.0


def test_calibration_matches_reference(models):
    """The port's Row-Hist calibration from the same float weights and
    images: the same paths (patch embedding, every trunk linear, head),
    target exponents and ADC full scales."""
    _, calibs = tcalibrate.convert_model_cim(
        models["t"]["float"], TCFG, TCtx(dense_attn_max=256), [_images()],
        cim_cfg=tcim.CIMConfig(), min_n=32, forward_fn=tvit.forward)
    jcalibs = models["jcalibs"]
    assert sorted(calibs) == sorted(jcalibs)
    assert "patch" in calibs and "head" in calibs
    for j in range(TCFG.n_layers):
        for leaf in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "ffn/w1",
                     "ffn/w2"):
            assert f"segments/0/L{j}/{leaf}" in calibs
    for path, cal in calibs.items():
        assert int(cal.e_n) == int(jcalibs[path].e_n), path
        assert float(cal.adc_fs) == float(jcalibs[path].adc_fs), path


def test_lossless_cim_equals_digital_mxfp4(models):
    """No ADC and an unbounded mirror window: the hybrid analog ViT is the
    port's digital MXFP4 ViT, through patch embedding, bidirectional SDPA,
    FFN and head (the reference's invariant; measured ~299 dB there)."""
    lossless = tcim.CIMConfig(adc_bits=None, cm_bits=64, two_pass=False)
    conv, _ = tcalibrate.convert_model_cim(
        models["t"]["float"], TCFG, TCtx(dense_attn_max=256), [_images()],
        cim_cfg=lossless, min_n=32, forward_fn=tvit.forward)
    d, _ = tvit.forward(models["t"]["float"], TCFG,
                        TCtx(quant="mxfp4_digital", dense_attn_max=256),
                        _images())
    h, _ = tvit.forward(conv, TCFG,
                        TCtx(quant="cim", cim=lossless, dense_attn_max=256),
                        _images())
    assert _sqnr_db(d.float(), h.float()) > 60.0
    assert torch.equal(d.float().argmax(-1), h.float().argmax(-1))


def _chain(params, cfg, ctx, images, n_chips):
    chips = tvit.split_chips(params, cfg, n_chips)
    x = images
    for ci, (chip_params, n) in enumerate(chips):
        x = tvit.forward_chip(chip_params, cfg, ctx, x, n, first=ci == 0,
                              last=ci == len(chips) - 1)
    return x, [n for _, n in chips]


def test_chip_chain_equals_monolithic_float():
    cfg = dataclasses.replace(TCFG, n_layers=5, chips=2)
    params = tvit.init_model(cfg, torch.Generator().manual_seed(3))
    ctx = TCtx(dense_attn_max=256)
    mono, _ = tvit.forward(params, cfg, ctx, _images())
    got, split = _chain(params, cfg, ctx, _images()["images"], 2)
    assert split == [3, 2]
    assert torch.equal(got, mono)
    with pytest.raises(ValueError):
        tvit.split_chips(params, dataclasses.replace(cfg, n_layers=4), 2)


def test_chip_chain_equals_monolithic_cim(models):
    """The chain slices resident analog nodes (codes, exps, each layer's
    e_n / adc_fs) with their layers: bitwise the monolithic forward."""
    ctx = TCtx(dense_attn_max=256, **CIM)
    mono, _ = tvit.forward(models["t"]["cim"], TCFG, ctx, _images())
    got, split = _chain(models["t"]["cim"], TCFG, ctx, _images()["images"], 2)
    assert split == [1, 1]
    assert torch.equal(got, mono)


@pytest.mark.parametrize("n", [197, 145])
def test_encoder_dense_vs_flash_non_multiple_of_chunk(n):
    """Bidirectional dense and online-softmax attention agree at the
    encoder token counts (197 = ViT-B/16, 145 = ViT-L/32), neither a
    multiple of the chunk: the flash path's KV_PAD keys stay masked on
    the non-causal path too (mirror of the reference's test)."""
    cfg = tattn.AttnStatic(d_model=32, n_heads=2, n_kv=2, head_dim=16,
                           causal=False, use_rope=False)
    rng = np.random.default_rng(n)
    q = torch.from_numpy(rng.standard_normal((2, n, 2, 1, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, n, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, n, 2, 16), np.float32))
    pos = torch.arange(n)[None].expand(2, n)
    dense = tattn._dense_attn(q, k, v, pos, pos, cfg)
    flash = tattn._flash_attn(q, k, v, pos, pos, cfg,
                              TCtx(attn_chunk=64, q_chunk=64))
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_forward_pipelined_is_not_ported(models):
    """``vit.forward_pipelined`` (once a stub) over two stages on a CPU
    grid: logits bitwise the monolithic forward under float and ``cim``,
    and the returned runner reused for a second batch."""
    from repro_torch.distributed import pipeline_exec as pex

    cpu = torch.device("cpu")
    for key, ctx in (("float", TCtx(dense_attn_max=256)),
                     ("cim", TCtx(dense_attn_max=256, **CIM))):
        params = models["t"][key]
        mono, _ = tvit.forward(params, TCFG, ctx, _images())
        out, runner = tvit.forward_pipelined(
            params, TCFG, ctx, _images(), stages=2, microbatches=2,
            mb_size=1, mesh=pex.make_pipeline_mesh(2, devices=[cpu] * 2))
        assert runner.bounds == [(0, 1), (1, 2)]
        assert torch.equal(out, mono), key
        again, same = tvit.forward_pipelined(params, TCFG, ctx,
                                             {"images": _images()["images"][:1]},
                                             runner=runner)
        assert same is runner and torch.equal(again, mono[:1]), key


# ------------------------------------------- the kernels at the ViT's shapes

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype", [
    (196, 768, 768, torch.float32),  # ViT-B/16 patch embedding (f32 x)
    (144, 3072, 1024, torch.float32),  # ViT-L/32 patch embedding
    (1, 768, 1000, torch.bfloat16),  # ViT-B/16 classifier over the CLS row
    (1, 1024, 1000, torch.bfloat16),  # ViT-L/32 classifier
])
def test_cuda_mxfp4_fma_at_vit_shapes(m, k, n, dtype):
    """The patch embeddings and the classifiers take the fma route (f32 x;
    N = 1000 is no multiple of 16) and match the plain version at the
    kernel tests' bound."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(m + k + n)
    packed = tbackends._quantize_packed(torch.randn(k, n, generator=gen)
                                        * k ** -0.5)
    codes, exps = packed["codes"].to(dev), packed["exps"].to(dev)
    x = torch.randn(m, k, generator=gen).to(dtype).to(dev)
    assert tmm_ops.pick_route(m, k, n, dtype) == "fma"
    before = tmm_ops.mxfp4_matmul.route_launches["fma"]
    got = tmm_ops.mxfp4_matmul(x, codes, exps).float()
    assert tmm_ops.mxfp4_matmul.route_launches["fma"] == before + 1
    ref = tmm_ref.mxfp4_matmul_ref(x, codes, exps).float()
    torch.testing.assert_close(got, ref, rtol=2e-2,
                               atol=2e-2 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (197, 768, 768),  # ViT-B/16 wq/wk/wv/wo: splitk at prefill rows
    (197, 3072, 768),  # ViT-B/16 w2
    (197, 768, 3072),  # ViT-B/16 w1: wgmma
    (196, 768, 768),  # ViT-B/16 patch embedding (f32 x)
    (1, 768, 1000),  # ViT-B/16 classifier
    (145, 1024, 1024),  # ViT-L/32 trunk
    (1, 1024, 1000),  # ViT-L/32 classifier
])
def test_cuda_cim_linear_at_vit_shapes(m, k, n):
    """cim_linear at the ViT's shapes and on the route its picker takes
    there: bitwise its plain version."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(m * n + k)
    w = tmx.quantize_w((torch.randn(k, n, generator=gen) * k ** -0.5).to(dev))
    x = torch.randn(m, k, generator=gen).to(dev)
    cfg = tcim.CIMConfig()
    cal = tcim.calibrate_rowhist([x], w, cfg)
    route = tcim_ops.pick_route(m, k, n)
    assert route == ("wgmma" if n > 1024 else "splitk")
    before = tcim_ops.cim_linear.route_launches[route]
    got = tcim_ops.cim_linear(x, w, cal, cfg=cfg)
    assert tcim_ops.cim_linear.route_launches[route] == before + 1
    ref, _ = tcim.cim_linear(x, w, cfg, cal)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
