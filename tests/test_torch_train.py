"""The port's training path against the JAX reference, on the CPU.

- ``lm.lm_loss`` and its gradients against
  ``jax.value_and_grad(repro.models.lm.lm_loss)`` on the tiny configs of
  all ten LM archs, under ``quant="none"``, with a loss mask that drops a
  fifth of the tokens. The reference runs its layers unrolled
  (``unroll_layers``: the mode the port's Python loop over layers is, and
  in which the reference pins bitwise MXFP4 identity; under its
  ``lax.scan`` a fused bf16 chain skips roundings and flips MXFP4 codes),
  jitted with XLA's excess precision off for the same reason. Bounds: loss within 1e-3 relative; each gradient leaf, carried
  across by ``from_reference`` (the reference's stacked layer axis
  unstacked), >= 30 dB; a leaf whose reference gradient is zero is zero
  here. Without RoPE (hubert-xlarge) a key bias (``attn/wk/b``) has a
  zero gradient in exact arithmetic (softmax is invariant to a shift of
  every key's logit by q.b), so both frameworks return rounding noise
  there: each is held under 1e-3 of the gradient's global norm instead.
- The prequant loss equals the per-call ``mxfp4_ste`` loss bitwise on
  init params (exact hoisting).
- ``quantize_weights_tree`` bitwise, dtypes included, on tiny
  h2o-danube-1.8b (stacked segments: gammas to bf16), gemma3-1b
  (single-layer segments between stacked ones: those gammas stay f32)
  and mixtral-8x22b (expert banks).
- ``launch.steps.pick_microbatches``.

``tests/test_torch_train_step.py`` holds the MXFP4 training numerics and
the train step against the reference.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.layers.common import (  # noqa: E402
    RunCtx as TCtx,
    quantize_weights_tree,
)
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

B, S = 2, 32
LM_ARCHS = sorted(jconfigs.ARCHS)
# XLA rounds every bf16 value a jitted reference step stores, as its eager
# run does (by default a fusion may keep it in f32)
_NO_EXCESS = {"xla_allow_excess_precision": False}
ATTN = dict(dense_attn_max=16, attn_chunk=16, q_chunk=16)  # S=32: online


def _jctx(quant: str = "none", unroll: bool = True, **attn):
    return jcommon.RunCtx(shd=jcommon.ShardingCtx(), quant=quant,
                          unroll_layers=unroll, **(attn or ATTN))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _paths(tree, prefix=""):
    """(path, leaf) of a port tree, in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio":
        out["emb"] = rng.standard_normal((B, S, cfg.frontend_dim)).astype(
            np.float32)
    else:
        out["ids"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "vision":
        out["vis_emb"] = rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.frontend_dim)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out["loss_mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    return out


def _port_grads(params, cfg, ctx, batch):
    """(loss, {path: grad or None}) of the port's lm_loss."""
    flat = [t.requires_grad_(True) for _, t in _paths(params)]
    loss = tlm.lm_loss(params, cfg, ctx,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       chunk=16)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return float(loss.detach()), {p: g for (p, _), g in zip(_paths(params),
                                                             gs)}


def _check_grads(want_tree, got: dict, zero_kb: bool = False) -> None:
    want = dict(_paths(from_reference(_np(want_tree), device="cpu")))
    assert want.keys() == got.keys()
    gnorm = np.sqrt(sum(float(np.sum(w.numpy().astype(np.float64) ** 2))
                        for w in want.values()))
    for path, w in want.items():
        w = w.numpy()
        g = (np.zeros_like(w) if got[path] is None
             else got[path].detach().numpy())
        if zero_kb and path.endswith("attn/wk/b"):  # 0 in exact arithmetic
            assert np.linalg.norm(w) < 1e-3 * gnorm, path
            assert np.linalg.norm(g) < 1e-3 * gnorm, path
        elif not np.any(w):
            assert not np.any(g), path
        else:
            assert _sqnr_db(w, g) >= 30.0, (path, _sqnr_db(w, g))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    jcfg = jconfigs.tiny(jconfigs.ARCHS[arch])
    tcfg = tconfigs.tiny(tconfigs.ARCHS[arch])
    params, _ = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    jctx = _jctx(unroll=False)  # float: its scan body rounds as eager
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jctx, batch, chunk=16)),
        compiler_options=_NO_EXCESS)(params)
    tparams = from_reference(_np(params), device="cpu")
    loss, grads = _port_grads(tparams, tcfg, TCtx(**ATTN), batch)
    assert loss == pytest.approx(float(jloss), rel=1e-3)
    _check_grads(jgrads, grads, zero_kb=jcfg.family == "audio")


def test_lm_loss_pads_the_last_chunk():
    """A sequence that is not a whole number of chunks is padded and the
    pad masked out: the loss is the one-chunk loss."""
    cfg = tconfigs.tiny(tconfigs.H2O_DANUBE_1_8B)
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    one = tlm.lm_loss(params, cfg, TCtx(**ATTN), batch, chunk=S)
    ragged = tlm.lm_loss(params, cfg, TCtx(**ATTN), batch, chunk=12)
    assert float(ragged) == pytest.approx(float(one), rel=1e-6)
    batch["loss_mask"] = torch.zeros_like(batch["loss_mask"])
    assert float(tlm.lm_loss(params, cfg, TCtx(**ATTN), batch)) == 0.0


DANUBE_J = jconfigs.tiny(jconfigs.ARCHS["h2o-danube-1.8b"])
DANUBE_T = tconfigs.tiny(tconfigs.H2O_DANUBE_1_8B)


def test_prequant_loss_is_the_per_call_loss_bitwise():
    """quantize_weights_tree hoists the per-linear weight fake-quant
    exactly: on init params (norm gammas 1, biases 0, exact in bf16) the
    prequant loss is the per-call ``mxfp4_ste`` loss bit for bit."""
    params = tlm.init_model(DANUBE_T, torch.Generator().manual_seed(1))
    batch = {k: torch.from_numpy(v) for k, v in _batch(DANUBE_T).items()}
    per_call = tlm.lm_loss(params, DANUBE_T, TCtx(quant="mxfp4_ste", **ATTN),
                           batch)
    q = quantize_weights_tree(params, tlm.ref_ndim_tree(DANUBE_T, params))
    pre = tlm.lm_loss(q, DANUBE_T, TCtx(quant="mxfp4_ste_prequant", **ATTN),
                      batch)
    assert torch.equal(per_call, pre)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma3-1b",
                                  "mixtral-8x22b"])
def test_quantize_weights_tree_bitwise(arch):
    jcfg = jconfigs.tiny(jconfigs.ARCHS[arch])
    tcfg = tconfigs.tiny(tconfigs.ARCHS[arch])
    params, _ = jlm.init_model(jax.random.PRNGKey(2), jcfg)
    want = from_reference(_np(jax.jit(jcommon.quantize_weights_tree)(params)),
                          device="cpu")
    tparams = from_reference(_np(params), device="cpu")
    got = quantize_weights_tree(tparams, tlm.ref_ndim_tree(tcfg, tparams))
    want, got = dict(_paths(want)), dict(_paths(got))
    assert want.keys() == got.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        assert torch.equal(got[path], w), path
    kinds = {w.dtype for p, w in want.items() if p.endswith("gamma")}
    if arch == "gemma3-1b":  # stacked and single-layer segments both
        assert kinds == {torch.bfloat16, torch.float32}
    if arch == "mixtral-8x22b":
        assert want["/segments/0/0/moe/w1"].dtype == torch.bfloat16


def test_ref_ndim_tree_adds_the_stacked_axis():
    cfg = tconfigs.tiny(tconfigs.GEMMA3_1B)  # segments of 5, 1, 5, 1
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0))
    nd = tlm.ref_ndim_tree(cfg, params)
    assert [len(s) for s in params["segments"]] == [5, 1, 5, 1]
    assert nd["segments"][0][0]["attn"]["ln"]["gamma"] == 2
    assert nd["segments"][1][0]["attn"]["ln"]["gamma"] == 1
    assert nd["segments"][0][3]["attn"]["wq"]["w"] == 3
    assert nd["final_ln"]["gamma"] == 1 and nd["embed"]["emb"] == 2
    with pytest.raises(ValueError, match="segments"):
        tlm.ref_ndim_tree(cfg, dict(params, segments=params["segments"][:2]))


def test_pick_microbatches():
    assert tsteps.pick_microbatches(tconfigs.Shape(1024, 2, "train")) == 1
    assert tsteps.pick_microbatches(tconfigs.Shape(4096, 8, "train")) == 4
    assert tsteps.pick_microbatches(tconfigs.Shape(4096, 1, "train")) == 1
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.make_train_step(DANUBE_T, tconfigs.Shape(S, 3, "train"),
                               microbatches=2, device="cpu")


def test_train_step_config_matches_reference_fields():
    assert dataclasses.asdict(tadamw.AdamWConfig()) == dataclasses.asdict(
        jadamw.AdamWConfig())
