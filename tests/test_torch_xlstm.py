"""The port's xLSTM blocks against the JAX reference
(``repro.layers.xlstm``), on inputs and weights from numpy seeds and
``jax.random`` carried by ``from_reference``:

- the gates bitwise in f32 (``log_sigmoid`` of the forget gate, sLSTM's
  sigmoid), with ``torch.exp`` and ``torch.log1p`` computed by the
  reference's, as in ``tests/test_torch_ssm.py`` (XLA's CPU polynomials
  differ from torch's by one ulp on about a tenth of f32 inputs);
- ``_mlstm_step`` from a state with m = -inf (``mlstm_cache_init``'s)
  and from a live one, ``_mlstm_chunkwise`` at chunk 16 over 50 rows
  (padded) from m = -1e30 (a cacheless prefill's start) and from -inf,
  and ``_slstm_step``: the new state at rtol = atol = 1e-5 against the
  reference's; ``_mlstm_chunkwise`` also against the port's own
  sequential scan of ``_mlstm_step`` at the reference's bound for that
  pair (``tests/test_archs.py``: rtol 2e-4, atol 2e-5);
- ``mlstm_apply`` and ``slstm_apply`` in their three modes (prefill,
  prefill into a cache, one decode step from the reference's own
  prefilled cache) under float, ``mxfp4`` (the reference's packed tree,
  its Pallas kernel in interpret mode: a decode step feeds ``wq`` / ``wk``
  an f32 x, which the kernel takes as f32; ``wv`` is packed and never
  applied, ``w_if`` at N = 8 stays bf16) and
  ``cim`` (no xLSTM linear is calibrated): the new cache at rtol = atol
  = 1e-5 and the block output at SQNR >= 40 dB on the reference's
  injected input (the reference's block jitted, except under cim, where a
  fused bf16 chain would flip MXFP4 activation codes).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers import backends as jbackends  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.layers import xlstm as jxl  # noqa: E402
from repro_torch.convert import _map, _tensor  # noqa: E402
from repro_torch.layers import xlstm as txl  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402

# tiny xlstm-125m's blocks: d 64, 4 heads (mLSTM d_inner 128, head_dim 32;
# sLSTM head_dim 16, post-FFN 85 wide: w_down's K = 85 stays float)
JST = jxl.XLSTMStatic(d_model=64, n_heads=4)
TST = txl.XLSTMStatic(d_model=64, n_heads=4)
B, S = 2, 12
QUANT = {"float": "none", "mxfp4": "mxfp4_wonly", "cim": "cim"}
KIND = {"mlstm": (jxl.mlstm_init, jxl.mlstm_apply, jxl.mlstm_cache_init,
                  txl.mlstm_apply, txl.mlstm_cache_init),
        "slstm": (jxl.slstm_init, jxl.slstm_apply, jxl.slstm_cache_init,
                  txl.slstm_apply, txl.slstm_cache_init)}


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


def _tensor_of(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol,
                               atol=tol, err_msg=msg)


def _xla(fn):
    def run(t):
        return torch.from_numpy(np.array(fn(jnp.asarray(t.numpy()))))
    return run


@pytest.fixture
def xla_math(monkeypatch):
    """``torch.exp`` and ``torch.log1p`` replaced by the reference's."""
    monkeypatch.setattr(torch, "exp", _xla(jnp.exp))
    monkeypatch.setattr(torch, "log1p", _xla(jnp.log1p))


@pytest.fixture(scope="module")
def trees():
    """Each block's float tree and the reference's mxfp4 and cim
    conversions of it, with the port's copies."""
    out = {}
    for kind, (init, *_) in KIND.items():
        p, _ = init(jax.random.PRNGKey(1), JST)
        j = {"float": p, "mxfp4": _JMX(p, min_n=32),
             "cim": _JCIM(p, {}, min_n=32)}
        out[kind] = {"j": j, "t": {k: _t(v) for k, v in j.items()}}
    return out


@pytest.mark.parametrize("gate", ["log_sigmoid", "sigmoid"])
def test_gates_bitwise_f32(gate, xla_math):
    x = (np.random.default_rng(5).standard_normal((B, S, 8)) * 6).astype(
        np.float32)
    if gate == "log_sigmoid":
        ref, got = jax.nn.log_sigmoid(jnp.asarray(x)), txl.log_sigmoid(
            torch.from_numpy(x))
    else:
        ref, got = jax.nn.sigmoid(jnp.asarray(x)), txl._sigmoid(
            torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _qkvif(b, s, h, dk, seed):
    rng = np.random.default_rng(seed)
    qf = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    kf = (rng.standard_normal((b, s, h, dk)) * dk ** -0.5).astype(np.float32)
    vf = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    ig = rng.standard_normal((b, s, h)).astype(np.float32)
    fg = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        rng.standard_normal((b, s, h)).astype(np.float32) + 1.0)))
    return qf, kf, vf, ig, fg


def _init(b, h, dk, m0, live: bool, seed=6):
    rng = np.random.default_rng(seed)
    if live:
        return (rng.standard_normal((b, h, dk, dk)).astype(np.float32),
                rng.standard_normal((b, h, dk)).astype(np.float32),
                rng.standard_normal((b, h)).astype(np.float32))
    return (np.zeros((b, h, dk, dk), np.float32),
            np.zeros((b, h, dk), np.float32),
            np.full((b, h), m0, np.float32))


@pytest.mark.parametrize("start", ["cache_init", "live"])
def test_mlstm_step_matches_reference(start):
    b, h, dk = 2, 3, 8
    qf, kf, vf, ig, fg = (a[:, 0] for a in _qkvif(b, 1, h, dk, 7))
    init = _init(b, h, dk, -np.inf, start == "live")
    scale = dk ** -0.5
    (rc, rn, rm), rh = jxl._mlstm_step(tuple(map(jnp.asarray, init)), tuple(
        map(jnp.asarray, (qf, kf, vf, ig, fg))), scale)
    (gc, gn, gm), gh = txl._mlstm_step(tuple(map(_tensor_of, init)),
                                       tuple(map(_tensor_of,
                                                 (qf, kf, vf, ig, fg))), scale)
    for got, ref, name in ((gc, rc, "C"), (gn, rn, "n"), (gm, rm, "m"),
                           (gh, rh, "h")):
        _close(got.numpy(), ref, msg=name)


@pytest.mark.parametrize("m0", [-1e30, -np.inf])
def test_mlstm_chunkwise_matches_reference_and_scan(m0):
    b, s, h, dk = 2, 50, 3, 8
    ins = _qkvif(b, s, h, dk, 8)
    init = _init(b, h, dk, m0, False)
    scale = dk ** -0.5
    rh, rst = jxl._mlstm_chunkwise(*map(jnp.asarray, ins),
                                   tuple(map(jnp.asarray, init)), scale,
                                   chunk=16)
    th = tuple(map(_tensor_of, ins))
    gh, gst = txl._mlstm_chunkwise(*th, tuple(map(_tensor_of, init)),
                                   scale, chunk=16)
    _close(gh.numpy(), rh, msg="h")
    for got, ref, name in zip(gst, rst, "Cnm"):
        _close(got.numpy(), ref, msg=name)
    # against the port's own sequential scan (the reference's bound)
    carry, hs = tuple(map(_tensor_of, init)), []
    for t in range(s):
        carry, h_t = txl._mlstm_step(carry, tuple(a[:, t] for a in th), scale)
        hs.append(h_t)
    np.testing.assert_allclose(gh.numpy(), torch.stack(hs, 1).numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gst[0].numpy(), carry[0].numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(gst[2].numpy(), carry[2].numpy(), rtol=2e-4)


def test_slstm_step_matches_reference(trees):
    rng = np.random.default_rng(9)
    b, h, dh = B, JST.n_heads, JST.s_head_dim
    carry = [rng.standard_normal((b, h, dh)).astype(np.float32)
             for _ in range(4)]
    wx = rng.standard_normal((b, h, 4 * dh)).astype(np.float32)
    for backend in ("float", "cim"):  # r f32, then bf16 after conversion
        jr = trees["slstm"]["j"][backend]["r"]
        tr = trees["slstm"]["t"][backend]["r"]
        rst, rh = jxl._slstm_step(tuple(map(jnp.asarray, carry)),
                                  jnp.asarray(wx), jr)
        gst, gh = txl._slstm_step(tuple(map(_tensor_of, carry)),
                                  torch.from_numpy(wx), tr)
        _close(gh.numpy(), rh, msg=backend)
        for got, ref in zip(gst, rst):
            _close(got.numpy(), ref, msg=backend)


@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
@pytest.mark.parametrize("mode", ["prefill", "into_cache", "decode"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_apply_matches_reference(kind, mode, backend, trees):
    _, jblock, jcinit, tapply, tcinit = KIND[kind]
    rng = np.random.default_rng(10)
    jp, tp = trees[kind]["j"][backend], trees[kind]["t"][backend]
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
    japply = functools.partial(jblock, jctx, JST)
    if backend != "cim":
        japply = jax.jit(japply)
    jcache = tcache = None
    if mode == "into_cache":
        jcache, tcache = jcinit(JST, B), tcinit(TST, B, device="cpu")
    elif mode == "decode":  # the reference's own prefilled cache
        _, jcache = japply(jp, x, jcinit(JST, B))
        tcache = _t(jcache)
        x = jnp.asarray(rng.standard_normal((B, 1, 64)), jnp.bfloat16)
    ry, rc = japply(jp, x, jcache)
    gy, gc = tapply(tctx, TST, tp, _t(x), tcache)
    assert gy.dtype == torch.bfloat16 and gy.shape == ry.shape
    ref_d = np.asarray((ry - x).astype(jnp.float32))
    assert _sqnr_db(ref_d, (gy - _t(x)).float()) >= 40.0
    if mode == "prefill":
        assert rc is None and gc is None
        return
    assert sorted(gc) == sorted(rc)
    for k in rc:
        _close(gc[k].numpy(), rc[k], msg=k)
