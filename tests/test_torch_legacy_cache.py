"""The legacy split K/V cache through the port against the JAX reference,
as the reference pins it (``src/repro/layers/attention.py``), and the
launcher's greedy decode of a dense arch on it.

- Prefill into a cache: K/V and, under the digital SDPA, the resident
  mirrors bitwise, below the window and past it (the ring roll).
- One decode step at a scalar position and at per-lane positions (one
  lane past the window: the ring has wrapped) under float, the digital
  MXFP4 SDPA by requant-per-step and from the resident mirrors: the new
  cache bitwise (written in place), the output SQNR >= 40 dB.
- The resident mirrors after a step bitwise a requant of the raw cache,
  and their decode bitwise requant-per-step's.
- Tiny starcoder2-7b's greedy tokens through ``greedy_decode`` equal the
  reference launcher's loop under float and mxfp4.
- ``attn_cache_init`` / ``init_cache`` without a device resolve to CUDA
  for the legacy layout and the recurrent states, as the fused ones do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import _map, _tensor, from_reference  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

_JMX = jax.jit(jcommon.convert_params_mxfp4, static_argnames="min_n")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return _map(_np(tree), lambda a: _tensor(a, "cpu"))


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


J_AST = jattn.AttnStatic(d_model=64, n_heads=4, n_kv=2, head_dim=16, window=8)
T_AST = tattn.AttnStatic(d_model=64, n_heads=4, n_kv=2, head_dim=16, window=8)


@pytest.fixture(scope="module")
def attn_params():
    p, _ = jattn.attn_init(jax.random.PRNGKey(3), J_AST)
    return p, _t(p)


def _attn_ctxs(mx: bool):
    q = "mxfp4_digital" if mx else "none"
    return (jcommon.RunCtx(shd=jcommon.ShardingCtx(), quant=q),
            TCtx(quant=q))


@pytest.mark.parametrize("s, mx", [(6, False), (12, True)])
def test_legacy_prefill_into_cache_bitwise(s, mx, attn_params):
    """Below the window in float; past it (rows rolled by 12 % 8) with the
    resident mirrors."""
    jp, tp = attn_params
    jctx, tctx = _attn_ctxs(mx)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((2, s, 64)),
                    jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (2, s))
    jc = jattn.attn_cache_init(J_AST, 2, 16, mx_digital=mx)
    tc = tattn.attn_cache_init(T_AST, 2, 16, mx_digital=mx, device="cpu")
    assert sorted(tc) == sorted(jc)
    ry, rc = jattn.attn_apply(jctx, J_AST, jp, x, pos, jc)
    gy, gc = tattn.attn_apply(tctx, T_AST, tp, _t(x),
                              torch.from_numpy(np.asarray(pos)), tc)
    assert sorted(gc) == sorted(rc)
    for k in rc:
        np.testing.assert_array_equal(gc[k].float().numpy(),
                                      np.asarray(rc[k].astype(jnp.float32)),
                                      err_msg=k)
    assert _sqnr_db(np.asarray(ry.astype(jnp.float32)), gy.float()) >= 40.0


def _filled_cache(resident: bool):
    """A legacy cache with every slot written (random K/V, the mirrors a
    requant of them), as the reference and the port hold it."""
    rng = np.random.default_rng(5)
    k, v = (jnp.asarray(rng.standard_normal((2, 8, 2, 16)), jnp.bfloat16)
            for _ in range(2))
    c = {"k": k, "v": v}
    if resident:
        c.update(jattn._quant_cache_full(k, v))
    return c


@pytest.mark.parametrize("sdpa", ["float", "mx_requant", "mx_resident"])
@pytest.mark.parametrize("pos", ["scalar", "per_lane"])
def test_legacy_decode_matches_reference(pos, sdpa, attn_params):
    """One decode step: at a scalar position 5, or per lane at 3 and 13
    (the ring has wrapped: slot 5, all 8 slots live)."""
    jp, tp = attn_params
    mx = sdpa != "float"
    jctx, tctx = _attn_ctxs(mx)
    jc = _filled_cache(sdpa == "mx_resident")
    p = np.int32(5) if pos == "scalar" else np.array([3, 13], np.int32)
    x = jnp.asarray(np.random.default_rng(6).standard_normal((2, 1, 64)),
                    jnp.bfloat16)
    jpos = jnp.broadcast_to(jnp.asarray(p).reshape(-1, 1), (2, 1))
    ry, rc = jattn.attn_apply(jctx, J_AST, jp, x, jpos, jc, jnp.asarray(p))
    tc = _t(jc)
    gy, gc = tattn.attn_apply(tctx, T_AST, tp, _t(x),
                              torch.from_numpy(np.asarray(jpos)), tc,
                              torch.from_numpy(np.asarray(p)))
    assert gc is tc  # written in place
    for k in rc:
        np.testing.assert_array_equal(gc[k].float().numpy(),
                                      np.asarray(rc[k].astype(jnp.float32)),
                                      err_msg=k)
    assert _sqnr_db(np.asarray((ry - x).astype(jnp.float32)),
                    (gy - _t(x)).float()) >= 40.0


@pytest.mark.parametrize("pos", [[5, 5], [3, 13]])
def test_legacy_resident_mirrors_equal_requant(pos, attn_params):
    """The resident mirrors after a step are bitwise a requant of the raw
    cache, and the step's output bitwise requant-per-step's."""
    _, tp = attn_params
    _, tctx = _attn_ctxs(True)
    x = _t(jnp.asarray(np.random.default_rng(7).standard_normal((2, 1, 64)),
                       jnp.bfloat16))
    p = torch.tensor(pos)
    out = {}
    for resident in (False, True):
        c = _t(_filled_cache(resident))
        y, c = tattn.attn_apply(tctx, T_AST, tp, x, p[:, None], c, p)
        out[resident] = (y, c)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    full = tattn._quant_cache_full(out[True][1]["k"], out[True][1]["v"])
    for k, v in full.items():
        torch.testing.assert_close(out[True][1][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["float", "mxfp4"])
def test_dense_greedy_decode_on_legacy_cache(backend):
    """Tiny starcoder2-7b: the port's greedy decode on the legacy cache
    against the reference launcher's loop (its jnp compositions on the
    CPU; the port under ``impl="ref"``), tokens equal."""
    cfg = jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"])
    params, _ = jlm.init_model(jax.random.PRNGKey(0), cfg)
    jparams = params if backend == "float" else _JMX(params, min_n=32)
    quant = {"float": "none", "mxfp4": "mxfp4_wonly"}[backend]
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256,
                          quant=quant, unroll_layers=True)
    prompt = np.random.default_rng(2).integers(0, 128, (2, 8))
    caches = jlm.init_cache(cfg, 2, 12)
    hidden, caches = jlm.forward(jparams, cfg, jctx,
                                 {"ids": jnp.asarray(prompt)}, caches=caches,
                                 return_hidden=True)
    ids = jnp.argmax(jlm._head(jctx, cfg, jparams, hidden[:, -1:])[:, -1]
                     .astype(jnp.float32), -1)[:, None]
    want = [ids]
    for t in range(3):
        logits, caches = jlm.decode_step(jparams, cfg, jctx, ids,
                                         jnp.int32(8 + t), caches)
        ids = jnp.argmax(logits.astype(jnp.float32), -1)[:, None]
        want.append(ids)
    got = tserve.greedy_decode(
        from_reference(_np(jparams), device="cpu"),
        tconfigs.tiny(tconfigs.ARCHS["starcoder2-7b"]),
        TCtx(quant=quant, dense_attn_max=256, impl="ref"),
        torch.from_numpy(prompt), 4)
    assert got["ids"].tolist() == np.asarray(
        jnp.concatenate(want, 1)).tolist()


def test_legacy_and_state_builders_default_to_cuda(monkeypatch):
    """Without a ``device`` the legacy cache, its mirrors and the
    recurrent states resolve to CUDA: without a GPU they raise before they
    allocate."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builders = [
        lambda: tattn.attn_cache_init(T_AST, 1, 16, mx_digital=True),
        lambda: tattn.quant_cache_init(1, 16, 2, 16),
        lambda: tlm.init_cache(tconfigs.tiny(tconfigs.ARCHS["zamba2-1.2b"]),
                               1, 16),
        lambda: tlm.init_cache(tconfigs.tiny(tconfigs.ARCHS["xlstm-125m"]),
                               1, 16),
    ]
    allocs = []
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: allocs.append(a))
    monkeypatch.setattr(torch, "full", lambda *a, **kw: allocs.append(a))
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert allocs == []
