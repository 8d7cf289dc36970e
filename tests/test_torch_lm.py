"""The port's hybrid analog/digital LM against the JAX reference, on the
tiny starcoder2-7b config the reference's serving tests pin.

The JAX package calibrates and converts the model (``convert_model_cim``
on fixed numpy tokens); its converted tree crosses into the port through
``repro_torch.convert.from_reference``. Bounds (SQNR of logits >= 30 dB):

- Prefill logits against the reference's eager ``unroll_layers`` forward,
  the mode in which the reference itself pins bitwise MXFP4 identity (its
  jitted forward fuses bf16 element-wise chains and moves MXFP4 codes).
- Teacher-forced decode-step logits over the fused paged cache, the
  port's main path (CPU: the plain versions of both kernels) against the
  reference running its Pallas kernels in interpret mode.

Port-only invariants: calibration from the same float weights and tokens
picks the reference's E_N and ADC full scales; with a lossless CIM config
the hybrid model is the port's own digital MXFP4 model.
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
from repro.models import calibrate as jcalibrate  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

JCFG = jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"])
TCFG = tconfigs.tiny(tconfigs.STARCODER2_7B)
SEQ, PAGE, STEPS = 36, 48, 2  # decode at 36.. reads the clamped 2nd chunk
IDS = np.random.default_rng(0).integers(0, JCFG.vocab_size, (1, SEQ + STEPS))


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


@pytest.fixture(scope="module")
def models():
    jctx = JCtx(shd=ShardingCtx(), dense_attn_max=256)
    params, _ = jlm.init_model(jax.random.PRNGKey(0), JCFG)
    # one calibration batch at the prefill shape: eager JAX compiles each
    # op per shape, so sharing shapes keeps the reference run short
    batches = [{"ids": jnp.asarray(IDS[:, :SEQ])}]
    conv, calibs = jcalibrate.convert_model_cim(
        params, JCFG, jctx, batches, cim_cfg=jcim.CIMConfig(), min_n=32)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(jparams=params, jconv=conv, jcalibs=calibs, jctx=jctx,
                tfloat=from_reference(to_np(params), device="cpu"),
                tconv=from_reference(to_np(conv), device="cpu"))


def test_config_fields_match_reference():
    for name, tcfg in tconfigs.ARCHS.items():
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(
            jconfigs.ARCHS[name])
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)


def test_from_reference_unstacks_layers(models):
    tconv, jconv = models["tconv"], models["jconv"]
    layers = tconv["segments"][0]
    assert len(layers) == JCFG.n_layers
    for j, layer in enumerate(layers):
        node = layer["ffn"]["w1"]
        assert node["codes"].dtype == torch.int8
        assert tuple(node["codes"].shape) == (JCFG.d_model, JCFG.d_ff)
        assert node["e_n"].shape == ()
        assert int(node["e_n"]) == int(jconv["segments"][0]["ffn"]["w1"]["e_n"][j])
        assert node["b"].dtype == torch.bfloat16
    assert tconv["lm_head"]["adc_fs"].dtype == torch.float32
    assert tconv["embed"]["emb"].dtype == torch.bfloat16


def test_calibration_matches_reference(models):
    """The port's own Row-Hist calibration from the same float weights and
    tokens: the same per-layer target exponents and ADC full scales."""
    _, calibs = tcalibrate.convert_model_cim(
        models["tfloat"], TCFG, TCtx(dense_attn_max=256),
        [{"ids": torch.from_numpy(IDS[:, :SEQ])}], cim_cfg=tcim.CIMConfig(),
        min_n=32)
    jcalibs = models["jcalibs"]
    assert sorted(calibs) == sorted(jcalibs)
    for path, cal in calibs.items():
        assert int(cal.e_n) == int(jcalibs[path].e_n), path
        assert float(cal.adc_fs) == float(jcalibs[path].adc_fs), path


def test_prefill_logits_match_reference(models):
    jctx = dataclasses.replace(models["jctx"], quant="cim",
                               cim=jcim.CIMConfig(), unroll_layers=True)
    ref, _ = jlm.forward(models["jconv"], JCFG, jctx,
                         {"ids": jnp.asarray(IDS[:, :SEQ])})
    got, _ = tlm.forward(models["tconv"], TCFG,
                         TCtx(quant="cim", cim=tcim.CIMConfig(),
                              dense_attn_max=256),
                         {"ids": torch.from_numpy(IDS[:, :SEQ])})
    assert got.shape == (1, SEQ, JCFG.vocab_size)
    assert _sqnr_db(ref, got.float()) >= 30.0


def test_decode_logits_match_reference_kernels(models):
    """Prefill into a fused quantized-resident page, then teacher-forced
    decode steps: the port's main path against the reference's Pallas
    kernels (``impl="pallas"``, interpret mode)."""
    jctx = dataclasses.replace(models["jctx"], quant="cim",
                               cim=jcim.CIMConfig(), unroll_layers=True,
                               impl="pallas", interpret=True)
    tctx = TCtx(quant="cim", cim=tcim.CIMConfig(), dense_attn_max=256)
    jc = jlm.init_cache(JCFG, 1, PAGE, mx_digital=True, fused=True)
    tc = tlm.init_cache(TCFG, 1, PAGE, mx_digital=True, fused=True,
                        device="cpu")
    _, jc = jlm.forward(models["jconv"], JCFG, jctx,
                        {"ids": jnp.asarray(IDS[:, :SEQ])}, caches=jc)
    _, tc = tlm.forward(models["tconv"], TCFG, tctx,
                        {"ids": torch.from_numpy(IDS[:, :SEQ])}, caches=tc)
    for p in range(SEQ, SEQ + STEPS):
        ref, jc = jlm.decode_step(models["jconv"], JCFG, jctx,
                                  jnp.asarray(IDS[:, p:p + 1]), jnp.int32(p),
                                  jc)
        got, tc = tlm.decode_step(models["tconv"], TCFG, tctx,
                                  torch.from_numpy(IDS[:, p:p + 1]), p, tc)
        assert _sqnr_db(ref, got.float()) >= 30.0, p
    for name in ("kv", "kv_codes", "k_exps", "v_exps"):  # the page itself
        got = tc[0][0][name]
        ref = np.asarray(jax.tree.map(lambda a: a[0], jc[0])[name])
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
            ref = ref.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_lossless_cim_equals_digital_mxfp4_model(models):
    """No ADC and an unbounded mirror window: the hybrid analog model is
    the port's digital MXFP4 model, end to end (the reference's
    invariant; measured ~300 dB there)."""
    lossless = tcim.CIMConfig(adc_bits=None, cm_bits=64, two_pass=False)
    ids = torch.from_numpy(IDS[:, :SEQ])
    conv, _ = tcalibrate.convert_model_cim(
        models["tfloat"], TCFG, TCtx(dense_attn_max=256), [{"ids": ids}],
        cim_cfg=lossless, min_n=32)
    d, _ = tlm.forward(models["tfloat"], TCFG,
                       TCtx(quant="mxfp4_digital", dense_attn_max=256),
                       {"ids": ids})
    h, _ = tlm.forward(conv, TCFG,
                       TCtx(quant="cim", cim=lossless, dense_attn_max=256),
                       {"ids": ids})
    assert _sqnr_db(d.float(), h.float()) > 60.0
    assert torch.equal(d.float().argmax(-1), h.float().argmax(-1))
