"""The port's MXFP4 training numerics and its one-device train step
against the JAX reference, on the CPU (tiny h2o-danube-1.8b).

- ``mxfp4_ste`` (per-linear weight and activation fake-quant) and
  ``mxfp4_ste_prequant`` (weights quantized once by
  ``quantize_weights_tree``) against the reference's eager run, its layers
  unrolled (``unroll_layers``: the mode the port's loop over layers is;
  the port's forward is bitwise there): loss within 1e-4 relative, each
  gradient leaf >= 30 dB.
- ``launch.steps.make_train_step`` against a composition of the
  reference's pieces (``quantize_weights_tree`` + ``jax.vjp`` +
  ``lm_loss`` without a mesh + ``adamw.apply``, the body of the
  reference's ``make_train_step``, which itself needs a pod mesh), jitted
  with XLA's excess precision off, under ``mxfp4_ste`` with 1 and 2
  microbatches and ``none`` with 2: loss and grad norm within 1e-3
  relative, the learning rate equal, AdamW's first moment (the clipped
  gradient, back through the quant's VJP) >= 30 dB a leaf, the new
  parameters within twice the step's largest update (AdamW's first step
  is lr * sign(g) where |g| >> eps, so a gradient element that rounds
  across zero moves by 2 lr).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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
from test_torch_train import (  # noqa: E402
    ATTN,
    DANUBE_J,
    DANUBE_T,
    S,
    _NO_EXCESS,
    _batch,
    _check_grads,
    _jctx,
    _np,
    _paths,
    _port_grads,
    _sqnr_db,
)


@pytest.fixture(scope="module")
def danube():
    params, _ = jlm.init_model(jax.random.PRNGKey(5), DANUBE_J)
    return params, _batch(DANUBE_J, seed=1)


@pytest.mark.parametrize("quant", ["mxfp4_ste", "mxfp4_ste_prequant"])
def test_mxfp4_ste_loss_and_grads_match_reference_eager(danube, quant):
    params, batch = danube
    jctx = _jctx(quant)
    tparams = from_reference(_np(params), device="cpu")
    tctx = TCtx(quant=quant, **ATTN)
    if quant == "mxfp4_ste_prequant":
        def jloss_fn(p):
            return jlm.lm_loss(jcommon.quantize_weights_tree(p), DANUBE_J,
                               jctx, batch, chunk=16)

        nd = tlm.ref_ndim_tree(DANUBE_T, tparams)
        flat = [t.requires_grad_(True) for _, t in _paths(tparams)]
        loss = tlm.lm_loss(quantize_weights_tree(tparams, nd), DANUBE_T,
                           tctx, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, chunk=16)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        loss = float(loss.detach())
        grads = {p: g for (p, _), g in zip(_paths(tparams), gs)}
    else:
        def jloss_fn(p):
            return jlm.lm_loss(p, DANUBE_J, jctx, batch, chunk=16)

        loss, grads = _port_grads(tparams, DANUBE_T, tctx, batch)
    jloss, jgrads = jax.value_and_grad(jloss_fn)(params)  # eager
    assert loss == pytest.approx(float(jloss), rel=1e-4)
    _check_grads(jgrads, grads)


def _ref_train_step(params, opt_state, batch, quant: str, k: int, opt_cfg):
    """The reference's one-device train step from its pieces: the body of
    ``repro.launch.steps.make_train_step`` without a mesh."""
    prequant = quant == "mxfp4_ste"
    # make_train_step's context: RunCtx's default tiles of the online
    # softmax (1024 keys, 2048 queries)
    ctx = _jctx("mxfp4_ste_prequant" if prequant else quant,
                dense_attn_max=ATTN["dense_attn_max"])

    def loss_fn(p, mb):
        return jlm.lm_loss(p, DANUBE_J, ctx, mb)

    if prequant:
        cparams, qvjp = jax.vjp(jcommon.quantize_weights_tree, params)
    else:
        cparams, qvjp = params, None
    if k == 1:
        loss, grads = jax.value_and_grad(loss_fn)(cparams, batch)
    else:
        grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             cparams)
        loss = jnp.float32(0.0)
        for i in range(k):
            mb = jax.tree.map(
                lambda x: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i],
                batch)
            li, g = jax.value_and_grad(loss_fn)(cparams, mb)
            grads = jax.tree.map(lambda a, b: a + b.astype(jnp.float32),
                                 grads, g)
            loss = loss + li
        grads = jax.tree.map(lambda g: g / k, grads)
        loss = loss / k
    if qvjp is not None:
        grads = qvjp(jax.tree.map(lambda g, p: g.astype(p.dtype), grads,
                                  cparams))[0]
    new_params, new_state, met = jadamw.apply(opt_cfg, params, grads,
                                              opt_state)
    met["loss"] = loss
    return new_params, new_state, met


@pytest.mark.parametrize("quant,k", [("mxfp4_ste", 1), ("mxfp4_ste", 2),
                                     ("none", 2)])
def test_train_step_matches_reference_composition(danube, quant, k):
    params, _ = danube
    shape = tconfigs.Shape(S, 4, "train")
    rng = np.random.default_rng(3)
    batch = {"ids": rng.integers(0, 128, (4, S)).astype(np.int32),
             "labels": rng.integers(0, 128, (4, S)).astype(np.int32),
             "loss_mask": np.ones((4, S), np.float32)}
    opt = jadamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    jp, js, jmet = jax.jit(
        lambda p, s, b: _ref_train_step(p, s, b, quant, k, opt),
        compiler_options=_NO_EXCESS)(params, jadamw.init(params), batch)
    tparams = from_reference(_np(params), device="cpu")
    before = {p: t.clone() for p, t in _paths(tparams)}
    bundle = tsteps.make_train_step(
        DANUBE_T, shape, tadamw.AdamWConfig(lr=1e-2, warmup_steps=0),
        quant=quant, microbatches=k, device="cpu",
        dense_attn_max=ATTN["dense_attn_max"])
    assert bundle.microbatches == k
    assert bundle.ctx.quant == ("mxfp4_ste_prequant" if quant == "mxfp4_ste"
                                else quant)
    tp, ts, tmet = bundle.fn(tparams, tadamw.init(tparams),
                             {n: torch.from_numpy(v)
                              for n, v in batch.items()})
    assert int(ts.step) == int(js.step) == 1
    for name in ("loss", "grad_norm"):
        assert float(tmet[name]) == pytest.approx(float(jmet[name]),
                                                  rel=1e-3), name
    assert float(tmet["lr"]) == float(jmet["lr"])
    want_m = dict(_paths(from_reference(_np(js.m), device="cpu")))
    for path, m in _paths(ts.m):
        assert _sqnr_db(want_m[path].numpy(), m.numpy()) >= 30.0, path
    want_p = dict(_paths(from_reference(_np(jp), device="cpu")))
    for path, p in _paths(tp):
        upd = np.abs(want_p[path].numpy() - before[path].numpy()).max()
        np.testing.assert_allclose(p.detach().numpy(), want_p[path].numpy(),
                                   rtol=0, atol=2 * upd + 1e-7,
                                   err_msg=path)
