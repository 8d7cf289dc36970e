"""The port's Mamba2 (SSD) mixer against the JAX reference
(``repro.layers.ssm``), on inputs and weights from numpy seeds and
``jax.random`` carried by ``from_reference``:

- the causal depthwise conv (``_conv1d``, taps added in the reference's
  order, then SiLU) and the gates (``softplus`` of ``dt``,
  ``-exp(A_log)``) bitwise in f32, with ``torch.exp`` and
  ``torch.log1p`` computed by the reference's (``xla_math``): XLA's CPU
  backend evaluates them with its own polynomials, which differ from
  torch's by one ulp on about a tenth of f32 inputs, so what these cases
  hold bitwise is the order of the port's operations;
- ``ssm.cumsum`` bitwise ``jnp.cumsum`` in f32 (XLA's CPU backend sums in
  blocks of 16, and the decay factors exp(cumsum_i - cumsum_j) amplify a
  rounding of the sum);
- ``_ssd_chunked`` at chunk 8 and 32 over a 44-row sequence (both padded)
  at rtol = atol = 1e-5;
- ``mamba_apply`` in its three modes (prefill, prefill into a cache,
  one decode step from the reference's own prefilled cache) under float,
  ``mxfp4`` (the reference's packed tree) and ``cim`` (the reference's
  converted tree: the Mamba linears are never calibrated, so they stay
  bf16 on the digital MXFP4 W+A path): the new conv tail and state at
  rtol = atol = 1e-5 and the block output at SQNR >= 40 dB on the
  reference's injected input (the reference's block jitted, except under
  cim, where a fused bf16 chain would flip MXFP4 activation codes).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers import backends as jbackends  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.layers import ssm as jssm  # noqa: E402
from repro_torch.convert import _map, _tensor  # noqa: E402
from repro_torch.layers import ssm as tssm  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402

# tiny zamba2-1.2b's mixer (d 64, 8 heads of 16, state 16), chunk 8 so
# that a 12-row prefill spans two chunks and pads
MST = jssm.MambaStatic(d_model=64, n_heads=8, head_dim=16, d_state=16,
                       chunk=8)
TST = tssm.MambaStatic(d_model=64, n_heads=8, head_dim=16, d_state=16,
                       chunk=8)
B, S = 2, 12
QUANT = {"float": "none", "mxfp4": "mxfp4_wonly", "cim": "cim"}


# the reference's conversions compiled once (bitwise their eager runs;
# eagerly they compile op by op, ~10x slower)
_JMX = jax.jit(jcommon.convert_params_mxfp4, static_argnames="min_n")
_JCIM = jax.jit(jbackends.convert_params_cim, static_argnames="min_n")


def _t(tree):
    return _map(jax.tree.map(np.asarray, tree), lambda a: _tensor(a, "cpu"))


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def trees():
    """The mixer's float tree and the reference's mxfp4 and cim
    conversions of it, with the port's copies."""
    p, _ = jssm.mamba_init(jax.random.PRNGKey(0), MST)
    j = {"float": p, "mxfp4": _JMX(p, min_n=32),
         "cim": _JCIM(p, {}, min_n=32)}
    return {"j": j, "t": {k: _t(v) for k, v in j.items()}}


def _xla(fn):
    def run(t):
        return torch.from_numpy(np.array(fn(jnp.asarray(t.numpy()))))
    return run


@pytest.fixture
def xla_math(monkeypatch):
    """``torch.exp`` and ``torch.log1p`` replaced by the reference's."""
    monkeypatch.setattr(torch, "exp", _xla(jnp.exp))
    monkeypatch.setattr(torch, "log1p", _xla(jnp.log1p))


@pytest.mark.parametrize("what", ["conv1d", "softplus", "a"])
def test_conv_and_gates_bitwise_f32(what, trees, xla_math):
    rng = np.random.default_rng(1)
    jp, tp = trees["j"]["float"], trees["t"]["float"]
    if what == "conv1d":
        x = rng.standard_normal((B, S, MST.conv_dim)).astype(np.float32)
        ref = jssm._conv1d(MST, jp, jnp.asarray(x))
        got = tssm._conv1d(TST, tp, torch.from_numpy(x))
    elif what == "softplus":
        x = (rng.standard_normal((B, S, 64)) * 8).astype(np.float32)
        ref = jax.nn.softplus(jnp.asarray(x) + jp["dt_bias"][:1])
        got = tssm.softplus(torch.from_numpy(x) + tp["dt_bias"][:1])
    else:
        ref = -jnp.exp(jp["A_log"])
        got = -torch.exp(tp["A_log"])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [12, 16, 44, 300])
def test_cumsum_bitwise(n):
    x = (np.random.default_rng(4).standard_normal((2, n, 5)) * 20).astype(
        np.float32)
    np.testing.assert_array_equal(
        tssm.cumsum(torch.from_numpy(x), 1).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_reference(chunk):
    rng = np.random.default_rng(2)
    s, h, p, g, n = 44, 8, 16, 1, 16  # 44 rows pad at chunk 8 and 32
    x = rng.standard_normal((B, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, h)))).astype(np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    bm = rng.standard_normal((B, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((B, s, g, n)).astype(np.float32)
    ry, rs = jssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk)
    gy, gs = tssm._ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                               chunk)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
@pytest.mark.parametrize("mode", ["prefill", "into_cache", "decode"])
def test_mamba_apply_matches_reference(mode, backend, trees):
    rng = np.random.default_rng(3)
    jp, tp = trees["j"][backend], trees["t"][backend]
    # mxfp4: the reference's kernel (interpret mode), whose function the
    # port's wrapper computes: an f32 x (a decode's conv output) enters the
    # dot as f32, where the reference's jnp fallback rounds it to bf16
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), quant=QUANT[backend],
                          impl="pallas" if backend == "mxfp4" else "auto",
                          interpret=True)
    tctx = TCtx(quant=QUANT[backend])
    x = jnp.asarray(rng.standard_normal((B, S, 64)), jnp.bfloat16)
    # the reference's block compiled whole (op by op it compiles every op);
    # under cim eagerly: a fused bf16 chain flips MXFP4 activation codes
    japply = functools.partial(jssm.mamba_apply, jctx, MST)
    if backend != "cim":
        japply = jax.jit(japply)
    jcache = tcache = None
    if mode == "into_cache":
        jcache = jssm.mamba_cache_init(MST, B)
        tcache = tssm.mamba_cache_init(TST, B, device="cpu")
    elif mode == "decode":  # the reference's own prefilled cache
        _, jcache = japply(jp, x, jssm.mamba_cache_init(MST, B))
        tcache = _t(jcache)
        x = jnp.asarray(rng.standard_normal((B, 1, 64)), jnp.bfloat16)
    ry, rc = japply(jp, x, jcache)
    gy, gc = tssm.mamba_apply(tctx, TST, tp, _t(x), tcache)
    assert gy.dtype == torch.bfloat16 and gy.shape == ry.shape
    assert _sqnr_db(_f32(ry - x), (gy - _t(x)).float()) >= 40.0
    if mode == "prefill":
        assert rc is None and gc is None
        return
    assert sorted(gc) == sorted(rc)
    for k in rc:
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(rc[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
