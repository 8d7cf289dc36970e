"""Tiny hubert-xlarge (the audio family: non-causal, no RoPE,
LayerNorm with biases, GELU; the front end the reference's stub of
``front_proj`` on frame embeddings plus sinusoidal positions) through the
port against the JAX reference, on weights carried by ``from_reference``:

- ``embed_inputs`` bitwise in bf16;
- logits SQNR >= 30 dB against the reference's eager ``unroll_layers``
  forward under float, mxfp4 (its Pallas kernel in interpret mode) and
  cim (the reference's conversion under the port's calibration on the
  same ``emb`` batch; tiny ``front_proj`` has K = 24, so it stays
  digital there);
- the launcher exits for the encoder-only arch as the reference's does.
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
from repro.layers import backends as jbackends  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

NAME = "hubert-xlarge"
TINY = jconfigs.tiny(jconfigs.ARCHS[NAME])
SEQ = 12
EMB = np.random.default_rng(1).standard_normal((2, SEQ, 24)).astype(
    np.float32)
QUANT = {"float": "none", "mxfp4": "mxfp4_wonly", "cim": "cim"}

_JMX = jax.jit(jcommon.convert_params_mxfp4, static_argnames="min_n")
_JCIM = jax.jit(jbackends.convert_params_cim, static_argnames="min_n")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _tcfg():
    return tconfigs.ArchConfig(**dataclasses.asdict(TINY))


def _ctxs(backend: str):
    cim = {"cim": jcim.CIMConfig()} if backend == "cim" else {}
    tcim_kw = {"cim": tcim.CIMConfig()} if backend == "cim" else {}
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256,
                          quant=QUANT[backend], unroll_layers=True,
                          impl="pallas" if backend == "mxfp4" else "auto",
                          interpret=True, **cim)
    return jctx, TCtx(quant=QUANT[backend], dense_attn_max=256, **tcim_kw)


@pytest.fixture(scope="module")
def hubert():
    params, _ = jlm.init_model(jax.random.PRNGKey(0), TINY)
    fl = from_reference(_np(params), device="cpu")
    _, tcalibs = tcalibrate.convert_model_cim(
        fl, _tcfg(), TCtx(dense_attn_max=256),
        [{"emb": torch.from_numpy(EMB)}], cim_cfg=tcim.CIMConfig(), min_n=32)
    calibs = {path: jcim.LayerCalib(jnp.int32(int(c.e_n)),
                                    jnp.float32(float(c.adc_fs)))
              for path, c in tcalibs.items()}
    j = {"float": params, "mxfp4": _JMX(params, min_n=32),
         "cim": _JCIM(params, calibs, min_n=32)}
    return {"j": j, "t": {b: from_reference(_np(t), device="cpu")
                          for b, t in j.items()}, "tcalibs": tcalibs}


def test_hubert_embed_inputs_bitwise(hubert):
    jctx, tctx = _ctxs("float")
    ref = jlm.embed_inputs(jctx, TINY, hubert["j"]["float"],
                           {"emb": jnp.asarray(EMB)})
    got = tlm.embed_inputs(tctx, _tcfg(), hubert["t"]["float"],
                           {"emb": torch.from_numpy(EMB)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    want = {f"segments/0/L{j}/{p}" for j in range(2)
            for p in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "ffn/w1",
                      "ffn/w2")} | {"lm_head"}
    assert sorted(hubert["tcalibs"]) == sorted(want)


@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
def test_hubert_logits_match_reference(backend, hubert):
    jctx, tctx = _ctxs(backend)
    ref, _ = jlm.forward(hubert["j"][backend], TINY, jctx,
                         {"emb": jnp.asarray(EMB)})
    got, _ = tlm.forward(hubert["t"][backend], _tcfg(), tctx,
                         {"emb": torch.from_numpy(EMB)})
    assert got.shape == (2, SEQ, TINY.vocab_size)
    assert _sqnr_db(ref, got.float()) >= 30.0


def test_launcher_exits_for_encoder_only(monkeypatch):
    """The reference's launcher leaves an encoder-only arch with this
    SystemExit (before building anything); so does the port's."""
    with pytest.raises(SystemExit) as ref:
        monkeypatch.setattr("sys.argv", ["serve", "--arch", "hubert-xlarge",
                                         "--tiny"])
        jserve.main()
    with pytest.raises(SystemExit) as got:
        tserve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    assert str(got.value) == str(ref.value) == (
        "hubert-xlarge is encoder-only; no decode")
