"""The recurrent families through the port against the JAX reference
(the blocks alone: ``tests/test_torch_ssm.py``, ``tests/test_torch_xlstm.py``;
the legacy split K/V cache: ``tests/test_torch_legacy_cache.py``; the
audio encoder: ``tests/test_torch_audio.py``). One file, so that the eager
reference compiles each op once for all of them.

- Tiny xlstm-125m (mLSTM, sLSTM, mLSTM x2) and zamba2-1.2b (Mamba x2,
  the shared block, Mamba x2, the shared block, Mamba: no visit after the
  short last run) on weights carried by ``from_reference``: a prefill into
  ``init_cache`` (the legacy cache and the recurrent states) against the
  reference's eager ``unroll_layers`` forward, then teacher-forced decode
  steps, under float, mxfp4 and cim (the reference's conversion under the
  port's calibration of the same weights and tokens, held to the
  reference's below):
  logits SQNR >= 30 dB. Under mxfp4 the reference runs its Pallas kernel
  in interpret mode (the function the port's wrapper computes: an mLSTM
  decode feeds ``wq`` / ``wk`` an f32 x, which the kernel takes as f32).
- Decode from an empty cache matches the prefill (``tests/test_archs.py``
  holds the reference to the same bound).
- ``greedy_decode`` gives the reference launcher's loop's tokens under
  float and mxfp4, both on the reference's CPU compositions (the port
  under ``impl="ref"``); the launcher greedy-decodes by default and its
  engine refuses the recurrent archs, as the reference's does.
- Row-Hist calibration of tiny zamba: the reference's paths (the shared
  block under ``shared/...``, each path two visits, concatenated in
  visit order; no Mamba linear) and values; the conversion makes the
  shared block analog and leaves the Mamba linears float; the fidelity
  tools name the shared paths as calibration does (``scale_adc_fs``,
  ``sqnr_trace``). Tiny xlstm calibrates nothing (its linears are
  unnamed and its head is tied).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import cim as jcim  # noqa: E402
from repro.layers import backends as jbackends  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.models import calibrate as jcalibrate  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers import backends as tbackends  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

ARCHS = ("xlstm-125m", "zamba2-1.2b")
TINY = {name: jconfigs.tiny(jconfigs.ARCHS[name]) for name in ARCHS}
# one cache shape for every test (the eager reference compiles each op
# once a shape): a 12-token prompt, 4 positions more
SEQ, STEPS, NEW = 12, 2, 4
PAGE = SEQ + NEW
IDS = np.random.default_rng(0).integers(0, 128, (1, SEQ + STEPS))
QUANT = {"float": "none", "mxfp4": "mxfp4_wonly", "cim": "cim"}

# the reference's conversions compiled once (bitwise their eager runs)
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


def _tcfg(name: str, **over):
    return tconfigs.ArchConfig(**(dataclasses.asdict(TINY[name]) | over))


def _ctxs(backend: str, **jover):
    cim = {"cim": jcim.CIMConfig()} if backend == "cim" else {}
    tcim_kw = {"cim": tcim.CIMConfig()} if backend == "cim" else {}
    jkw = dict(shd=jcommon.ShardingCtx(), dense_attn_max=256,
               quant=QUANT[backend], unroll_layers=True,
               impl="pallas" if backend == "mxfp4" else "auto",
               interpret=True, **cim)
    jctx = jcommon.RunCtx(**(jkw | jover))
    return jctx, TCtx(quant=QUANT[backend], dense_attn_max=256, **tcim_kw)


def _trees(params, calibs):
    j = {"float": params, "mxfp4": _JMX(params, min_n=32),
         "cim": _JCIM(params, calibs, min_n=32)}
    return {"j": j, "t": {b: from_reference(_np(t), device="cpu")
                          for b, t in j.items()}}


@pytest.fixture(scope="module")
def models():
    """Per arch: the reference's float, mxfp4 and cim trees (the cim one
    under the port's Row-Hist calibration of the prompt: none for xlstm,
    whose linears are unnamed and whose head is tied) and the port's
    carried copies."""
    out = {}
    for name in ARCHS:
        params, _ = jlm.init_model(jax.random.PRNGKey(0), TINY[name])
        tcalibs = tcalibrate.capture_rowhist_calibration(
            from_reference(_np(params), device="cpu"), _tcfg(name),
            TCtx(dense_attn_max=256), [{"ids": torch.from_numpy(
                IDS[:, :SEQ])}], cim_cfg=tcim.CIMConfig(), min_n=32)
        calibs = {path: jcim.LayerCalib(jnp.int32(int(c.e_n)),
                                        jnp.float32(float(c.adc_fs)))
                  for path, c in tcalibs.items()}
        out[name] = _trees(params, calibs)
    return out


@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_logits_match_reference(name, backend, models):
    jcfg, tcfg = TINY[name], _tcfg(name)
    jparams, tparams = models[name]["j"][backend], models[name]["t"][backend]
    jctx, tctx = _ctxs(backend)
    jc = jlm.init_cache(jcfg, 1, PAGE)
    tc = tlm.init_cache(tcfg, 1, PAGE, device="cpu")
    ids = IDS[:, :SEQ]
    ref, jc = jlm.forward(jparams, jcfg, jctx, {"ids": jnp.asarray(ids)},
                          caches=jc)
    got, tc = tlm.forward(tparams, tcfg, tctx, {"ids": torch.from_numpy(ids)},
                          caches=tc)
    assert got.shape == (1, SEQ, jcfg.vocab_size)
    assert _sqnr_db(ref, got.float()) >= 30.0
    for p in range(SEQ, SEQ + STEPS):
        ref, jc = jlm.decode_step(jparams, jcfg, jctx,
                                  jnp.asarray(IDS[:, p:p + 1]), jnp.int32(p),
                                  jc)
        got, tc = tlm.decode_step(tparams, tcfg, tctx,
                                  torch.from_numpy(IDS[:, p:p + 1]), p, tc)
        assert _sqnr_db(ref, got.float()) >= 30.0, p


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_prefill(name, models):
    """Teacher-forced decode from an empty cache against the prefill's
    logits (the reference's bound in ``tests/test_archs.py``)."""
    cfg, params = _tcfg(name), models[name]["t"]["float"]
    ctx = TCtx(dense_attn_max=256)
    ids = torch.from_numpy(IDS[:, :6])
    full, _ = tlm.forward(params, cfg, ctx, {"ids": ids})
    caches = tlm.init_cache(cfg, 1, 8, device="cpu")
    for t in range(6):
        lg, caches = tlm.decode_step(params, cfg, ctx, ids[:, t:t + 1], t,
                                     caches)
    np.testing.assert_allclose(lg.float().numpy(), full[:, -1].float().numpy(),
                               rtol=5e-2, atol=5e-2)


def _reference_greedy(params, cfg, ctx, prompt, tokens):
    """The reference launcher's greedy loop (``src/repro/launch/serve.py``),
    its decode step eager."""
    caches = jlm.init_cache(cfg, prompt.shape[0], prompt.shape[1] + tokens)
    hidden, caches = jlm.forward(params, cfg, ctx, {"ids": prompt},
                                 caches=caches, return_hidden=True)
    logits = jlm._head(ctx, cfg, params, hidden[:, -1:])
    ids = jnp.argmax(logits[:, -1].astype(jnp.float32), -1)[:, None]
    outs = [ids]
    for t in range(tokens - 1):
        logits, caches = jlm.decode_step(params, cfg, ctx, ids,
                                         jnp.int32(prompt.shape[1] + t),
                                         caches)
        ids = jnp.argmax(logits.astype(jnp.float32), -1)[:, None]
        outs.append(ids)
    return np.asarray(jnp.concatenate(outs, 1))


@pytest.mark.parametrize("backend", ["float", "mxfp4"])
@pytest.mark.parametrize("name", ARCHS)
def test_greedy_decode_tokens_equal_reference(name, backend, models):
    jparams = models[name]["j"][backend]
    tparams = models[name]["t"][backend]
    # the reference's loop as its launcher runs it on the CPU (its jnp
    # compositions: an f32 x of a packed linear is rounded to bf16 first),
    # and the port's impl="ref", the same compositions; the kernels'
    # function is held by the logits tests
    jctx, tctx = _ctxs(backend, impl="auto")
    tctx = dataclasses.replace(tctx, impl="ref")
    prompt = IDS[:, :SEQ]
    want = _reference_greedy(jparams, TINY[name], jctx, jnp.asarray(prompt),
                             NEW)
    got = tserve.greedy_decode(tparams, _tcfg(name), tctx,
                               torch.from_numpy(prompt), NEW)
    assert got["ids"].tolist() == want.tolist()
    assert len(got["token_s"]) == NEW - 1 and got["capture_s"] is None


def test_calibration_matches_reference(models):
    """Row-Hist calibration of tiny zamba: the shared block's linears under
    ``shared/...`` (two visits each, concatenated in visit order) and the
    head, no Mamba linear; the reference's values."""
    name = "zamba2-1.2b"
    params, cfg = models[name]["t"]["float"], _tcfg(name)
    batch = {"ids": torch.from_numpy(IDS[:, :SEQ])}
    calibs = tcalibrate.capture_rowhist_calibration(
        params, cfg, TCtx(dense_attn_max=256), [batch],
        cim_cfg=tcim.CIMConfig(), min_n=32)
    jcalibs = jcalibrate.capture_rowhist_calibration(
        models[name]["j"]["float"], TINY[name],
        jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256),
        [{"ids": jnp.asarray(IDS[:, :SEQ])}], cim_cfg=jcim.CIMConfig(),
        min_n=32)
    want = {f"shared/{p}" for p in ("w_in", "attn/wq", "attn/wk", "attn/wv",
                                    "attn/wo", "ffn/w1", "ffn/w2", "w_out")}
    assert sorted(calibs) == sorted(jcalibs) == sorted(want | {"lm_head"})
    for path, cal in calibs.items():
        assert int(cal.e_n) == int(jcalibs[path].e_n), path
        assert float(cal.adc_fs) == float(jcalibs[path].adc_fs), path
    tap = tbackends.ActivationTap(min_n=32)
    tlm.forward(params, cfg, TCtx(dense_attn_max=256, tap=tap), batch)
    assert {p: len(v) for p, v in tap.records.items()} == dict.fromkeys(
        sorted(want | {"lm_head"}), 2) | {"lm_head": 1}
    caps, _ = tcalibrate.capture_linear_inputs(params, cfg, TCtx(), batch)
    assert caps["shared/w_in"].shape[0] == 2 * SEQ
    torch.testing.assert_close(caps["shared/w_in"][:SEQ],
                               tap.records["shared/w_in"][0], rtol=0, atol=0)
    conv = tbackends.convert_params_cim(params, calibs, min_n=32)
    assert all("e_n" in conv["shared"]["attn"][k] for k in ("wq", "wo"))
    assert "e_n" in conv["shared"]["w_in"] and "e_n" in conv["shared"]["w_out"]
    assert "e_n" not in conv["segments"][0][0]["in_proj"]
    # the fidelity tools name the shared paths as calibration does
    scaled = tobs.scale_adc_fs(conv, 0.25, match="shared/")
    assert float(scaled["shared"]["w_in"]["adc_fs"]) == 0.25 * float(
        conv["shared"]["w_in"]["adc_fs"])
    assert torch.equal(scaled["lm_head"]["adc_fs"], conv["lm_head"]["adc_fs"])
    ccaps, _ = tcalibrate.capture_linear_inputs(
        conv, cfg, TCtx(quant="cim", cim=tcim.CIMConfig()), batch)
    per = tobs.sqnr_trace(caps, ccaps)
    assert sorted(per) == sorted(want | {"lm_head"})
    xl = "xlstm-125m"
    assert tcalibrate.capture_rowhist_calibration(
        models[xl]["t"]["float"], _tcfg(xl), TCtx(dense_attn_max=256),
        [batch], min_n=32) == {}


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_greedy_decode_on_cpu(name, tmp_path):
    """Without ``--serve-trace`` / ``--arrivals`` the launcher greedy-decodes
    (the reference's default path) and writes the token-latency histogram
    into ``--metrics-out``; the engine refuses the recurrent archs as the
    reference's paged pool does."""
    out = tserve.main(["--arch", name, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--tokens", "3", "--log-level",
                       "warning", "--metrics-out",
                       str(tmp_path / "m.json")])
    assert tuple(out["ids"].shape) == (2, 3)
    assert ((out["ids"] >= 0) & (out["ids"] < 128)).all()
    assert len(out["token_s"]) == 2 and out["tok_s"] > 0
    assert "serve_token_latency_seconds" in (tmp_path / "m.json").read_text()
    with pytest.raises(NotImplementedError, match="attention-only"):
        tserve.main(["--arch", name, "--device", "cpu", "--serve-trace",
                     "--log-level", "warning"])
