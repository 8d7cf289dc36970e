"""The port's LM under ``--backend mxfp4`` (packed weight-only linears)
and ``--backend float`` against the JAX reference, on the tiny
starcoder2-7b config the reference's serving tests pin.

The JAX package builds the model and converts it (``convert_params_mxfp4``,
``min_n=32`` as the launchers do); the trees cross into the port through
``repro_torch.convert.from_reference``. Both backends decode over float
fused pages (no code mirrors). Bound: SQNR of logits >= 30 dB, the bound
of ``tests/test_torch_lm.py``, for

- prefill logits against the reference's eager ``unroll_layers``
  forward, and
- prefill into a fused page and then 4 teacher-forced decode steps, the
  port's main path (CPU: the plain versions of ``mxfp4_matmul`` and the
  float ``paged_flash_decode``), and the same steps under ``impl="ref"``
  (bf16 dequant matmul, dense float-page decode), against the reference
  running its Pallas kernels in interpret mode.

Measured on this tiny model: 43.3-46.8 dB under mxfp4 and 43.0-51.5 dB
under float (bf16 roundings of the two frameworks' op orders).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

JCFG = jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"])
TCFG = tconfigs.tiny(tconfigs.STARCODER2_7B)
SEQ, PAGE, STEPS = 36, 48, 4  # decode at 36.. reads the clamped 2nd chunk
IDS = np.random.default_rng(0).integers(0, JCFG.vocab_size, (1, SEQ + STEPS))
QUANT = {"mxfp4": "mxfp4_wonly", "float": "none"}


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


@pytest.fixture(scope="module")
def models():
    params, _ = jlm.init_model(jax.random.PRNGKey(0), JCFG)
    conv = jax.jit(jcommon.convert_params_mxfp4,
                   static_argnames="min_n")(params, min_n=32)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"mxfp4": (conv, from_reference(to_np(conv), device="cpu")),
            "float": (params, from_reference(to_np(params), device="cpu"))}


def test_from_reference_carries_packed_nodes(models):
    jconv, tconv = models["mxfp4"]
    layers = tconv["segments"][0]
    assert len(layers) == JCFG.n_layers
    for j, layer in enumerate(layers):
        for name, shape in (("w1", (JCFG.d_model // 2, JCFG.d_ff)),
                            ("w2", (JCFG.d_ff // 2, JCFG.d_model))):
            node = layer["ffn"][name]
            assert node["codes"].dtype == torch.uint8
            assert node["exps"].dtype == torch.uint8
            assert tuple(node["codes"].shape) == shape
            np.testing.assert_array_equal(
                node["exps"].numpy(),
                np.asarray(jconv["segments"][0]["ffn"][name]["exps"][j]))
    assert tconv["lm_head"]["codes"].dtype == torch.uint8
    assert tconv["embed"]["emb"].dtype == torch.bfloat16


@pytest.mark.parametrize("backend", ["mxfp4", "float"])
def test_logits_match_reference(models, backend):
    jparams, tparams = models[backend]
    quant = QUANT[backend]
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), quant=quant,
                          dense_attn_max=256, unroll_layers=True)
    tctx = TCtx(quant=quant, dense_attn_max=256)
    ids = torch.from_numpy(IDS)
    ref, _ = jlm.forward(jparams, JCFG, jctx, {"ids": jnp.asarray(IDS[:, :SEQ])})
    got, _ = tlm.forward(tparams, TCFG, tctx, {"ids": ids[:, :SEQ]})
    assert got.shape == (1, SEQ, JCFG.vocab_size)
    sq = [_sqnr_db(ref, got.float())]
    # prefill into a fused float page, then decode through the kernels
    kctx = dataclasses.replace(jctx, impl="pallas", interpret=True)
    jc = jlm.init_cache(JCFG, 1, PAGE, mx_digital=False, fused=True)
    tc = tlm.init_cache(TCFG, 1, PAGE, fused=True, device="cpu")
    assert sorted(tc[0][0]) == ["kv"]  # no code mirrors
    ref, jc = jlm.forward(jparams, JCFG, kctx,
                          {"ids": jnp.asarray(IDS[:, :SEQ])}, caches=jc)
    got, tc = tlm.forward(tparams, TCFG, tctx, {"ids": ids[:, :SEQ]},
                          caches=tc)
    sq.append(_sqnr_db(ref, got.float()))
    rctx = dataclasses.replace(tctx, impl="ref")
    _, rc = tlm.forward(tparams, TCFG, rctx, {"ids": ids[:, :SEQ]},
                        caches=tlm.init_cache(TCFG, 1, PAGE, fused=True,
                                              device="cpu"))
    for p in range(SEQ, SEQ + STEPS):
        ref, jc = jlm.decode_step(jparams, JCFG, kctx,
                                  jnp.asarray(IDS[:, p:p + 1]), jnp.int32(p),
                                  jc)
        got, tc = tlm.decode_step(tparams, TCFG, tctx, ids[:, p:p + 1], p, tc)
        got_ref, rc = tlm.decode_step(tparams, TCFG, rctx, ids[:, p:p + 1], p,
                                      rc)
        sq += [_sqnr_db(ref, got.float()), _sqnr_db(ref, got_ref.float())]
    print(f"{backend}: logits SQNR (eager prefill, cached prefill, then "
          f"per decode step auto / ref): {sq}")
    assert min(sq) >= 30.0, sq
