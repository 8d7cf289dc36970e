"""The engine's legacy split-K/V page pool in the port, against the JAX
reference (tiny starcoder2-7b, weights from ``from_reference``).

- ``PagedKVCache(layout="legacy")`` has the reference's leaves, shapes,
  dtypes and specs (float and ``mx_digital``; the reference stacks a
  layer axis in front, the port keeps one dict a layer).
- ``lm.decode_step`` over a fused cache equals the same over a legacy
  cache, bitwise, under float, mxfp4 and ``mxfp4_digital`` at page 16
  (the reference's ``tests/test_paged_attention.py``
  ``test_model_decode_fused_bitwise_legacy``). The fused decode runs
  under ``impl="ref"``: the reference's dense whole-key-axis function,
  which the reference itself runs off the TPU. The kernels' plain
  versions (``impl="auto"`` on the CPU) are the Pallas kernels' chunked
  online softmax and round otherwise.
- The legacy decode step (``engine._legacy_decode_step``: gather,
  ``lm.decode_step``, scatter) run twice on one input leaves the pool as
  one run does, the warm-up argument of a captured step.
- The port's legacy engine gives its fused engine's tokens under
  ``mxfp4_digital`` (the reference's
  ``test_fused_engine_matches_legacy_engine``), and the reference's
  legacy engine's tokens under ``mxfp4`` and ``cim`` (its steps jitted
  with XLA's excess precision off: bitwise its eager steps).

Chunked prefill, clone and the prefix cache on a legacy pool are checked
with their fused counterparts in ``tests/test_torch_prefix.py``.
"""

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
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import kvcache as jkvcache  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.layers.common import RunCtx  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402
from repro_torch.serving import engine as eng_mod  # noqa: E402
from repro_torch.serving.kvcache import PagedKVCache  # noqa: E402

CFG = C.tiny(C.STARCODER2_7B)
JCFG = jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"])
QUANT = {"float": "none", "mxfp4": "mxfp4_wonly", "cim": "cim"}
IDS = np.random.default_rng(0).integers(0, CFG.vocab_size, (1, 16))

# the reference's conversions compiled once (bitwise their eager runs)
_JMX = jax.jit(jcommon.convert_params_mxfp4, static_argnames="min_n")
_JCIM = jax.jit(jbackends.convert_params_cim, static_argnames="min_n")
# XLA rounds every bf16 value a jitted reference step stores, as its eager
# run does (by default a fusion may keep it in f32)
_NO_EXCESS = {"xla_allow_excess_precision": False}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """The reference's float, mxfp4 and cim trees and the port's copies.
    The cim tree is the reference's conversion under the port's own
    calibration of the same weights and tokens (held to the reference's
    calibration in ``tests/test_torch_lm.py``)."""
    params, _ = jlm.init_model(jax.random.PRNGKey(0), JCFG)
    fl = from_reference(_np(params), device="cpu")
    _, tcalibs = tcalibrate.convert_model_cim(
        fl, CFG, RunCtx(dense_attn_max=256),
        [{"ids": torch.from_numpy(IDS)}], cim_cfg=tcim.CIMConfig(), min_n=32)
    calibs = {path: jcim.LayerCalib(jnp.int32(int(c.e_n)),
                                    jnp.float32(float(c.adc_fs)))
              for path, c in tcalibs.items()}
    j = {"float": params, "mxfp4": _JMX(params, min_n=32),
         "cim": _JCIM(params, calibs, min_n=32)}
    return {"j": j, "t": {b: from_reference(_np(t), device="cpu")
                          for b, t in j.items()}}


def _ctx(backend: str, **kw) -> RunCtx:
    cim = {"cim": tcim.CIMConfig()} if backend == "cim" else {}
    return RunCtx(quant=QUANT.get(backend, backend), dense_attn_max=256,
                  **cim, **kw)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _pool_bits(pool) -> list:
    return [_bits(v).clone() for seg in pool for layer in seg
            for v in layer.values()]


# ------------------------------------------------------------------ pool

@pytest.mark.parametrize("mx_digital", [False, True])
def test_legacy_pool_matches_reference(mx_digital):
    """Leaf names, shapes, dtypes and specs of a legacy pool are the
    reference's, per layer; ``fused`` names the layout."""
    kv = PagedKVCache(CFG, num_slots=3, lanes=2, page_len=40,
                      mx_digital=mx_digital, layout="legacy", device="cpu")
    jkv = jkvcache.PagedKVCache(JCFG, num_slots=3, lanes=2, page_len=40,
                                mx_digital=mx_digital, layout="legacy")
    assert not kv.fused and not jkv.fused and kv.layout == "legacy"
    assert len(kv.pool) == len(jkv.pool) == len(kv.specs)
    for seg, jseg, spec, jspec in zip(kv.pool, jkv.pool, kv.specs,
                                      jkv.specs):
        want = {"k", "v"} | ({"k_codes", "k_exps", "v_codes", "v_exps"}
                             if mx_digital else set())
        assert set(spec) == set(jseg) == want
        assert len(seg) == CFG.n_layers
        for name, leaf in jseg.items():
            # the reference stacks the layers in front: ("layers", ...)
            assert ("layers",) + spec[name] == jspec[name], name
            for layer in seg:
                assert tuple(layer[name].shape) == leaf.shape[1:], name
                assert str(layer[name].dtype).removeprefix("torch.") \
                    == str(leaf.dtype), name
    assert PagedKVCache(CFG, 3, 2, 40, layout="fused", device="cpu").fused


# ---------------------------------------------------------------- decode

@pytest.mark.parametrize("quant", ["none", "mxfp4_wonly", "mxfp4_digital"])
def test_decode_fused_bitwise_legacy(quant, models):
    """``lm.decode_step`` over a fused cache == over a legacy cache,
    bitwise logits, after a prefill into each and six steps deep, at page
    16, on the float path, the packed linears and the quantized-resident
    digital SDPA. The fused decode under ``impl="ref"``: the function the
    reference runs off the TPU."""
    params = models["t"]["float" if quant == "none" else "mxfp4"]
    ctx = _ctx(quant, impl="ref")
    mx = ctx.hybrid_digital_sdpa
    ids = torch.from_numpy(IDS[:, :10])
    with torch.no_grad():
        caches = {fused: lm.init_cache(CFG, 1, 16, mx_digital=mx,
                                       fused=fused, device="cpu")
                  for fused in (False, True)}
        for fused in caches:
            _, caches[fused] = lm.forward(params, CFG, ctx,
                                          {"ids": ids[:, :4]},
                                          caches=caches[fused])
        for p in range(4, 10):
            logits = {}
            for fused in caches:
                logits[fused], caches[fused] = lm.decode_step(
                    params, CFG, ctx, ids[:, p:p + 1], p, caches[fused])
            assert torch.equal(logits[True], logits[False]), p


@pytest.mark.parametrize("backend", ["float", "cim"])
def test_legacy_decode_step_twice_writes_once(backend, models):
    """Two prompts prefilled into a legacy pool, then the decode step on
    one input (lane 0 on a page, lane 1 parked on its scratch row) run
    twice: the same ids, and the pool bytes of one run (the capture's
    warm-up reruns the step)."""
    params, ctx = models["t"][backend], _ctx(backend)
    eng = Engine(params, CFG, ctx, EngineConfig(
        lanes=2, num_slots=3, page_len=40, prefill_len=12,
        kv_layout="legacy"))
    eng.add_request(IDS[0, :7].tolist(), max_new=1)
    eng.add_request(IDS[0, 3:12].tolist(), max_new=1)
    eng.run()
    step = torch.tensor([[1, eng.kv.scratch_row(1)], [int(IDS[0, 7]), 0],
                         [7, 0]], dtype=torch.int64)
    once = eng_mod._legacy_decode_step(params, CFG, ctx, eng.kv.pool,
                                       eng.kv.specs, step)
    pool = _pool_bits(eng.kv.pool)
    again = eng_mod._legacy_decode_step(params, CFG, ctx, eng.kv.pool,
                                        eng.kv.specs, step)
    assert once.shape == (2,) and torch.equal(once, again)
    assert all(torch.equal(a, b)
               for a, b in zip(_pool_bits(eng.kv.pool), pool))


# ---------------------------------------------------------------- engine

def _requests(vocab: int) -> list:
    rng = np.random.default_rng(11)
    return [(rng.integers(0, vocab, size=rng.integers(2, 8)).tolist(),
             int(rng.integers(2, 6))) for _ in range(4)]


def _serve(eng, reqs) -> list:
    rids = []
    for prompt, max_new in reqs:
        rids.append(eng.add_request(prompt, max_new=max_new))
        eng.step()
    out = eng.run()
    return [out[r] for r in rids]


def test_fused_engine_matches_legacy_engine(models):
    """The reference's check inside the port: staggered requests through
    a fused and a legacy engine on quantized-resident pools
    (``mxfp4_digital``, packed weights; the fused decode under
    ``impl="ref"``, as the reference runs it off the TPU) give the same
    tokens."""
    params, ctx = models["t"]["mxfp4"], _ctx("mxfp4_digital", impl="ref")
    reqs = _requests(CFG.vocab_size)
    outs = {layout: _serve(Engine(params, CFG, ctx, EngineConfig(
        lanes=3, num_slots=4, page_len=24, prefill_len=8,
        kv_layout=layout)), reqs) for layout in ("fused", "legacy")}
    assert outs["fused"] == outs["legacy"]


@pytest.mark.parametrize("backend", ["mxfp4", "cim"])
def test_legacy_engine_matches_reference_engine(backend, models):
    """Staggered requests through the port's legacy engine and the
    reference's (its default layout) on the same weights: the same
    tokens. The reference's prefill and decode steps are jitted with XLA's
    excess precision off (:data:`_NO_EXCESS`); under cim its default jit
    lets a fused bf16 chain skip a round, which flips MXFP4 codes, and
    its steps run eagerly (80 s more) give these tokens too."""
    cim = {"cim": jcim.CIMConfig()} if backend == "cim" else {}
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256,
                          quant=QUANT[backend], **cim)
    ecfg = dict(lanes=2, num_slots=3, page_len=20, prefill_len=8)
    reqs = _requests(CFG.vocab_size)
    jeng = jengine.Engine(models["j"][backend], JCFG, jctx,
                          jengine.EngineConfig(**ecfg))
    jeng._prefill, jeng._decode = (
        jax.jit(step.__wrapped__, compiler_options=_NO_EXCESS)
        for step in (jeng._prefill, jeng._decode))
    want = _serve(jeng, reqs)
    eng = Engine(models["t"][backend], CFG, _ctx(backend),
                 EngineConfig(**ecfg))
    assert eng.kv.layout == "legacy"  # the default, as the reference's
    assert _serve(eng, reqs) == want
