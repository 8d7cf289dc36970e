"""Tiny mixtral-8x22b and qwen3-moe-235b-a22b through the port against
the JAX reference (the MoE layer itself: ``tests/test_torch_moe.py``).

- A prefill into fused pages against the reference's eager
  ``unroll_layers`` forward, then teacher-forced decode steps against the
  reference with its Pallas kernels in interpret mode, under float, mxfp4
  and cim: logits SQNR >= 30 dB.
- The engine: tiny mixtral's tokens equal the reference engine's (fused
  layout, the published capacity factor); staggered requests give each
  request its solo tokens where no token can be dropped (capacity factor
  E / k: a token's expert slots then never depend on the other rows of
  its step, which the reference's capacity otherwise lets them do).
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
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

ARCHS = ("mixtral-8x22b", "qwen3-moe-235b-a22b")
TINY = {name: jconfigs.tiny(jconfigs.ARCHS[name]) for name in ARCHS}
SEQ, PAGE, STEPS = 12, 16, 2  # tiny mixtral's window is 16 slots
IDS = np.random.default_rng(0).integers(0, 128, (1, SEQ + STEPS))
QUANT = {"float": "none", "mxfp4": "mxfp4_wonly", "cim": "cim"}
ECFG = EngineConfig(lanes=2, num_slots=3, page_len=16, prefill_len=10)
REQS = ((9, 6), (4, 7), (10, 5), (2, 8))  # (prompt length, new tokens)


# the reference's conversions compiled once (bitwise their eager runs;
# eagerly they compile op by op, ~10x slower)
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


@pytest.fixture(scope="module")
def models():
    """Per arch: the reference's float, mxfp4 and cim trees and the port's
    carried copies. The cim trees are the reference's conversion under the
    port's own calibration of the same weights and tokens (held to the
    reference's in ``tests/test_torch_moe.py``)."""
    out = {}
    for name in ARCHS:
        params, _ = jlm.init_model(jax.random.PRNGKey(0), TINY[name])
        mx = _JMX(params, min_n=32)
        fl = from_reference(_np(params), device="cpu")
        _, tcalibs = tcalibrate.convert_model_cim(
            fl, _tcfg(name), TCtx(dense_attn_max=256),
            [{"ids": torch.from_numpy(IDS[:, :SEQ])}],
            cim_cfg=tcim.CIMConfig(), min_n=32)
        calibs = {path: jcim.LayerCalib(jnp.int32(int(c.e_n)),
                                        jnp.float32(float(c.adc_fs)))
                  for path, c in tcalibs.items()}
        cim = _JCIM(params, calibs, min_n=32)
        out[name] = {"j": {"float": params, "mxfp4": mx, "cim": cim},
                     "t": {b: from_reference(_np(t), device="cpu")
                           for b, t in (("float", params), ("mxfp4", mx),
                                        ("cim", cim))}}
    return out


def _ctxs(backend: str):
    cim = {"cim": jcim.CIMConfig()} if backend == "cim" else {}
    tcim_kw = {"cim": tcim.CIMConfig()} if backend == "cim" else {}
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256,
                          quant=QUANT[backend], unroll_layers=True, **cim)
    return jctx, TCtx(quant=QUANT[backend], dense_attn_max=256, **tcim_kw)


@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_logits_match_reference(name, backend, models):
    """A prefill into fused pages against the reference's eager
    ``unroll_layers`` forward, then teacher-forced decode steps against
    the reference with its Pallas kernels in interpret mode: logits SQNR
    >= 30 dB."""
    jcfg, tcfg = TINY[name], _tcfg(name)
    jparams, tparams = models[name]["j"][backend], models[name]["t"][backend]
    jctx, tctx = _ctxs(backend)
    mx_dig = tctx.hybrid_digital_sdpa
    jc = jlm.init_cache(jcfg, 1, PAGE, mx_digital=mx_dig, fused=True)
    tc = tlm.init_cache(tcfg, 1, PAGE, mx_digital=mx_dig, fused=True,
                        device="cpu")
    ids = IDS[:, :SEQ]
    ref, jc = jlm.forward(jparams, jcfg, jctx, {"ids": jnp.asarray(ids)},
                          caches=jc)
    got, tc = tlm.forward(tparams, tcfg, tctx, {"ids": torch.from_numpy(ids)},
                          caches=tc)
    assert got.shape == (1, SEQ, jcfg.vocab_size)
    assert _sqnr_db(ref, got.float()) >= 30.0
    jctx = dataclasses.replace(jctx, impl="pallas", interpret=True)
    for p in range(SEQ, SEQ + STEPS):
        ref, jc = jlm.decode_step(jparams, jcfg, jctx,
                                  jnp.asarray(IDS[:, p:p + 1]), jnp.int32(p),
                                  jc)
        got, tc = tlm.decode_step(tparams, tcfg, tctx,
                                  torch.from_numpy(IDS[:, p:p + 1]), p, tc)
        assert _sqnr_db(ref, got.float()) >= 30.0, p


def _prompts(vocab: int) -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).tolist() for n, _ in REQS]


def test_engine_tokens_equal_reference_engine(models):
    """Tiny mixtral under mxfp4 at its published capacity factor: the
    port's engine gives the reference engine's tokens (fused layout,
    staggered arrivals, 2 lanes: idle lanes route and take capacity in
    both)."""
    name, backend = "mixtral-8x22b", "mxfp4"
    jctx, tctx = _ctxs(backend)
    jctx = dataclasses.replace(jctx, unroll_layers=False)
    jeng = jengine.Engine(models[name]["j"][backend], TINY[name], jctx,
                          jengine.EngineConfig(
                              lanes=ECFG.lanes, num_slots=ECFG.num_slots,
                              page_len=ECFG.page_len,
                              prefill_len=ECFG.prefill_len,
                              kv_layout="fused"))
    teng = Engine(models[name]["t"][backend], _tcfg(name), tctx, ECFG)
    rids = {}
    for prompt, (_, m) in zip(_prompts(TINY[name].vocab_size), REQS):
        rids[jeng.add_request(prompt, max_new=m)] = teng.add_request(
            prompt, max_new=m)
        jeng.step()
        teng.step()
    jout, tout = jeng.run(), teng.run()
    for jr, tr in rids.items():
        assert tout[tr] == [int(t) for t in jout[jr]], tr


@pytest.mark.parametrize("backend", ["mxfp4", "cim"])
def test_engine_staggered_equals_solo(backend, models):
    """Where no token can be dropped (capacity factor E / k), staggered
    requests through the engine give each request the tokens it gets
    alone."""
    name = "mixtral-8x22b"
    cfg = _tcfg(name, capacity_factor=TINY[name].n_experts
                / TINY[name].top_k)
    params = models[name]["t"][backend]
    _, ctx = _ctxs(backend)
    eng = Engine(params, cfg, ctx, ECFG)
    rids = []
    for prompt, (_, m) in zip(_prompts(cfg.vocab_size), REQS):
        rids.append(eng.add_request(prompt, max_new=m))
        eng.step()
    together = eng.run()
    for rid, prompt, (_, m) in zip(rids, _prompts(cfg.vocab_size), REQS):
        solo = Engine(params, cfg, ctx, ECFG)
        solo.add_request(prompt, max_new=m)
        assert solo.run()[0] == together[rid], rid
        assert len(together[rid]) == m
