"""The port's long-prompt attention against the JAX reference.

- ``_flash_attn`` (torch ops, tile for tile) against the reference's eager
  ``_flash_attn`` on the CPU, with ragged tiles (Sq = 40 over 16-key and
  24-query tiles) and a KV_PAD tail on one of two rows. Bounds: f32
  2e-5 and bf16 3e-2 (``tests/test_kernels.py``: the reference's own
  flash kernel against its oracle); the eager reference rounds P and each
  tile's PV to bf16, and ``test_bf16_tile_rounding_is_pinned`` shows the
  port doing the same bit for bit. Under the digital SDPA the port is
  bitwise the reference in bf16, and in f32 within SQNR >= 30 dB
  (``tests/test_torch_lm.py``): exp and the f32 sums differ between XLA
  and PyTorch in the last ulp, which the f32 output keeps.
- The kernel route (``_flash_kernel``: ``flash_attention`` on q reshaped
  to [B, S, H, D], KV_PAD rows zeroed; its plain version on the CPU)
  against ``_flash_attn``, at the bf16 bound.
- The tiny starcoder2-7b with ``dense_attn_max=8`` at S = 24 through the
  port and the reference's eager unrolled forward, under float, mxfp4 and
  cim: logits SQNR >= 30 dB.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import cim as jcim  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.models import calibrate as jcalibrate  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

B, S, HKV, G, D = 2, 40, 2, 2, 16
TAIL = 5  # KV_PAD rows at the end of batch row 0
CHUNKS = dict(attn_chunk=16, q_chunk=24)
JCFG = jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"])
TCFG = tconfigs.tiny(tconfigs.STARCODER2_7B)
SEQ = 24  # > dense_attn_max below: the flash path in every layer
IDS = np.random.default_rng(5).integers(0, JCFG.vocab_size, (1, SEQ))


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(t) -> np.ndarray:
    return (t.float().numpy() if torch.is_tensor(t)
            else np.asarray(t, np.float32))


def _inputs(seed: int, dtype):
    """q, k, v in ``dtype`` (numpy) and positions with a KV_PAD tail on row
    0; K/V are zero at KV_PAD rows, as ``attn_apply`` leaves them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, HKV, G, D))
    k = rng.standard_normal((B, S, HKV, D))
    v = rng.standard_normal((B, S, HKV, D))
    pos = np.tile(np.arange(S), (B, 1))
    pos[0, S - TAIL:] = tattn.KV_PAD
    live = (pos > tattn.KV_PAD // 2)[:, :, None, None]
    k, v = k * live, v * live
    return tuple(a.astype(dtype) for a in (q, k, v)) + (pos,)


def _both(dtype, mx: bool, causal: bool, window: int, seed: int = 0):
    q, k, v, pos = _inputs(seed, dtype)
    kw = dict(d_model=HKV * G * D, n_heads=HKV * G, n_kv=HKV, head_dim=D,
              causal=causal, window=window)
    ref = jattn._flash_attn(
        *map(jnp.asarray, (q, k, v, pos, pos)), jattn.AttnStatic(**kw),
        jcommon.RunCtx(shd=jcommon.ShardingCtx(), **CHUNKS), mx_digital=mx)
    got = tattn._flash_attn(
        *map(_to_torch, (q, k, v, pos, pos)), tattn.AttnStatic(**kw),
        TCtx(**CHUNKS), mx_digital=mx)
    return np.asarray(ref), got


DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attn_matches_reference(dtype, causal, window):
    ref, got = _both(DTYPES[dtype], False, causal, window)
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert got.shape == (B, S, HKV, G, D)
    tol = 2e-5 if dtype == "f32" else 3e-2
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol)
    assert not _f32(got)[0, S - TAIL:].any()  # no live key: zeros


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attn_mx_digital_matches_reference(dtype, causal, window):
    """Per-tile P/V re-quantization. bf16, the model's dtype: bitwise. f32:
    the output keeps the last-ulp differences of exp and of the f32 sums
    that the bf16 round absorbs, so SQNR >= 30 dB (measured ~150)."""
    ref, got = _both(DTYPES[dtype], True, causal, window)
    ref, got = _f32(ref), _f32(got)
    if dtype == "bf16":
        np.testing.assert_array_equal(got, ref)
    else:
        assert _sqnr_db(ref, got) >= 30.0
    assert not got[0, S - TAIL:].any()


def test_bf16_tile_rounding_is_pinned():
    """The eager reference on the CPU rounds each tile's PV to bf16 (XLA
    keeps the round here, unlike the Pallas float decode's): the port,
    which rounds there too, is bitwise the reference on bf16 inputs."""
    ref, got = _both(ml_dtypes.bfloat16, False, True, 0, seed=3)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))


@pytest.mark.parametrize("window", [0, 12])
def test_kernel_route_is_flash_attn(window):
    """``_flash_kernel``'s function (the kernel's plain version on the CPU,
    q as [B, S, H, D], KV_PAD rows zeroed) is ``_flash_attn``'s within the
    bf16 bound."""
    q, k, v, pos = map(_to_torch, _inputs(1, ml_dtypes.bfloat16))
    cfg = tattn.AttnStatic(d_model=HKV * G * D, n_heads=HKV * G, n_kv=HKV,
                           head_dim=D, window=window)
    ctx = TCtx(arange_positions=True, **CHUNKS)
    got = tattn._flash_kernel(ctx, cfg, q, k, v, pos)
    want = tattn._flash_attn(q, k, v, pos, pos, cfg, ctx)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2, atol=3e-2)
    assert not _f32(got)[0, S - TAIL:].any()


def test_prefill_routes_kernel_only_where_it_is_the_function():
    """The kernel takes a prefill past ``dense_attn_max`` only on CUDA,
    under ``impl="auto"``, without the digital SDPA, causally, at d^-0.5
    and with positions in the arange layout; the rest is ``_flash_attn``
    (the dense path below the limit)."""
    cfg = tattn.AttnStatic(d_model=64, n_heads=4, n_kv=2, head_dim=16)
    ctx = TCtx(dense_attn_max=8, arange_positions=True)
    take = tattn._takes_flash_kernel
    assert take(ctx, cfg, "cuda", False, 9)
    assert not take(ctx, cfg, "cuda", False, 8)  # dense
    assert not take(ctx, cfg, "cpu", False, 9)
    assert not take(ctx, cfg, "cuda", True, 9)  # digital SDPA
    assert not take(dataclasses.replace(ctx, impl="ref"), cfg, "cuda", False,
                    9)
    assert not take(dataclasses.replace(ctx, arange_positions=False), cfg,
                    "cuda", False, 9)
    assert not take(ctx, dataclasses.replace(cfg, causal=False), "cuda",
                    False, 9)
    assert not take(ctx, dataclasses.replace(cfg, softmax_scale=0.5), "cuda",
                    False, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 64])
def test_cuda_prefill_takes_the_kernel(window):
    """On the card a bf16 prefill past ``dense_attn_max`` (head_dim 128, a
    KV_PAD tail of 44 rows) launches ``flash_attention`` once, on the
    ``wgmma`` route, and gives ``_flash_attn``'s function within the bf16
    bound, with exact zeros on the pad rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import ops as tfa_ops

    b, s, hkv, g, d, n = 1, 300, 2, 3, 128, 256
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(
        torch.bfloat16).cuda() for shape in ((b, s, hkv, g, d),
                                             (b, s, hkv, d), (b, s, hkv, d)))
    pos = torch.arange(s).cuda()[None]
    pos = torch.where(pos < n, pos, tattn.KV_PAD)
    k[:, n:], v[:, n:] = 0, 0
    cfg = tattn.AttnStatic(d_model=hkv * g * d, n_heads=hkv * g, n_kv=hkv,
                           head_dim=d, window=window)
    ctx = TCtx(dense_attn_max=256, arange_positions=True)
    before = dict(tfa_ops.flash_attention.route_launches)
    got = tattn._prefill_attn(ctx, cfg, q, k, v, pos, False)
    after = tfa_ops.flash_attention.route_launches
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["fma"] == before["fma"]
    want = tattn._flash_attn(q, k, v, pos, pos, cfg, ctx)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    assert bool((got[:, n:] == 0).all())


@pytest.fixture(scope="module")
def models():
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=8)
    params, _ = jlm.init_model(jax.random.PRNGKey(0), JCFG)
    mx = jax.jit(jcommon.convert_params_mxfp4,
                 static_argnames="min_n")(params, min_n=32)
    cim, _ = jcalibrate.convert_model_cim(
        params, JCFG, jctx, [{"ids": jnp.asarray(IDS)}],
        cim_cfg=jcim.CIMConfig(), min_n=32)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"float": ("none", params), "mxfp4": ("mxfp4_wonly", mx),
            "cim": ("cim", cim), "jctx": jctx,
            "torch": {name: from_reference(to_np(tree), device="cpu")
                      for name, tree in (("float", params), ("mxfp4", mx),
                                         ("cim", cim))}}


@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
def test_tiny_model_past_dense_attn_max_matches_reference(backend, models):
    quant, jparams = models[backend]
    cim = dict(cim=jcim.CIMConfig()) if backend == "cim" else {}
    jctx = dataclasses.replace(models["jctx"], quant=quant,
                               unroll_layers=True, **cim)
    ref, _ = jlm.forward(jparams, JCFG, jctx, {"ids": jnp.asarray(IDS)})
    tcim_kw = dict(cim=tcim.CIMConfig()) if backend == "cim" else {}
    got, _ = tlm.forward(models["torch"][backend], TCFG,
                         TCtx(quant=quant, dense_attn_max=8, **tcim_kw),
                         {"ids": torch.from_numpy(IDS)})
    assert got.shape == (1, SEQ, JCFG.vocab_size)
    assert bool(torch.isfinite(got.float()).all())
    assert _sqnr_db(ref, got.float()) >= 30.0
