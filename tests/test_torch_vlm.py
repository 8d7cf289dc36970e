"""The port's vlm family against the JAX reference: qwen2-vl-7b (M-RoPE,
the vision front-end stub).

- ``apply_mrope`` on three distinct position components (temporal,
  height, width) against the reference's: bitwise in bf16, within 1e-6
  in f32; text-only positions are the reference's, and M-RoPE over them
  keeps each vector's norm.
- ``_qkv`` with M-RoPE (sections ``(hd//8, 3hd//16, 3hd//16)``) bitwise
  the reference's in bf16; the RoPE path of every other config is
  untouched (``tests/test_torch_lm.py``).
- ``embed_inputs`` with ``vis_emb``: ``front_proj`` (K = 24 at tiny
  size, 1176 at full: not 32-aligned, so no conversion touches it) on
  the patch embeddings replaces the first ``nv`` token embeddings,
  bitwise the reference's under float, mxfp4 and cim (where it runs on
  the digital MXFP4 W+A path with its last K block padded).
- Tiny qwen2-vl: a prefill into fused pages against the reference's
  eager ``unroll_layers`` forward, then teacher-forced decode steps
  against the reference with its Pallas kernels in interpret mode, and a
  prefill with ``vis_emb``, under float, mxfp4 and cim: logits SQNR >= 30
  dB; the launcher serves it on the CPU.
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
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import backends as jbackends  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.layers import rope as jrope  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import rope as trope  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

NAME = "qwen2-vl-7b"
JCFG = jconfigs.tiny(jconfigs.ARCHS[NAME])
TCFG = tconfigs.ArchConfig(**dataclasses.asdict(JCFG))
SEQ, PAGE, STEPS = 20, 24, 2
IDS = np.random.default_rng(0).integers(0, 128, (1, SEQ + STEPS))
VIS = (np.random.default_rng(1).standard_normal(
    (1, JCFG.n_vis_tokens, JCFG.frontend_dim)).astype(np.float32))
QUANT = {"float": "none", "mxfp4": "mxfp4_wonly", "cim": "cim"}


# the reference's conversions compiled once (bitwise their eager runs;
# eagerly they compile op by op, ~10x slower)
_JMX = jax.jit(jcommon.convert_params_mxfp4, static_argnames="min_n")
_JCIM = jax.jit(jbackends.convert_params_cim, static_argnames="min_n")

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16(a: np.ndarray):
    """(jax bf16 array, torch bf16 tensor) with identical bits."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j).view(np.int16)).view(torch.bfloat16)
    return j, t


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -------------------------------------------------------------- M-RoPE

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_mrope_matches_reference(dtype):
    """Three distinct position components (an image grid's t / h / w
    ids) over sections (4, 6, 6) of a 32-wide head, theta 1e6: bitwise in
    bf16, the served dtype; in f32 within 1e-6 (XLA fuses the f32 chain
    ``x1·cos - x2·sin``: last-ulp differences in about 8% of outputs)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.stack([rng.integers(0, 50, (2, 7)) for _ in range(3)])
    assert len({tuple(p.ravel()) for p in pos}) == 3
    if dtype == "bf16":
        jx, tx = _bf16(x)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    ref = jrope.apply_mrope(jx, jnp.asarray(pos), 1e6, (4, 6, 6))
    got = trope.apply_mrope(tx, torch.from_numpy(pos), 1e6, (4, 6, 6))
    assert got.dtype == tx.dtype
    if dtype == "bf16":
        np.testing.assert_array_equal(got.float().numpy(), _f32(ref))
    else:
        np.testing.assert_allclose(got.numpy(), _f32(ref), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        trope.apply_mrope(tx, torch.from_numpy(pos), 1e6, (4, 6, 5))


def test_text_mrope_positions_and_norm():
    """Text-only positions repeat the ids in all three components (the
    reference's), and M-RoPE over them keeps each vector's norm."""
    pos = torch.arange(6)[None]
    mp = trope.text_mrope_positions(pos)
    np.testing.assert_array_equal(
        mp.numpy(), np.asarray(jrope.text_mrope_positions(jnp.arange(6)[None])))
    x = torch.randn((1, 6, 1, 32), generator=torch.Generator().manual_seed(3))
    y = trope.apply_mrope(x, mp, sections=(4, 6, 6))
    np.testing.assert_allclose(x.norm(dim=-1).numpy(), y.norm(dim=-1).numpy(),
                               rtol=1e-5)


def test_qkv_mrope_matches_reference():
    """The attention sublayer's q / k / v with M-RoPE at head_dim 16
    (sections 2, 3, 3) on bf16 rows at arbitrary positions: bitwise."""
    params, _ = jlm.init_model(jax.random.PRNGKey(0), JCFG)
    jp = jax.tree.map(lambda a: a[0], params["segments"][0]["attn"])
    tp = from_reference({"segments": [], "a": _np(jp)}, device="cpu")["a"]
    jst = jlm.build_segments(JCFG)[0].attn
    tst = tlm.build_segments(TCFG)[0].attn
    assert tst.mrope and tst == tattn.AttnStatic(**dataclasses.asdict(jst))
    jx, tx = _bf16(np.random.default_rng(4).standard_normal(
        (2, 9, JCFG.d_model)).astype(np.float32))
    pos = np.random.default_rng(5).integers(0, 40, (2, 9))
    ref = jattn._qkv(jcommon.RunCtx(shd=jcommon.ShardingCtx()), jst, jp, jx,
                     jnp.asarray(pos))
    got = tattn._qkv(TCtx(), tst, tp, tx, torch.from_numpy(pos))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.float().numpy(), _f32(r))


# ------------------------------------------------------------ models

@pytest.fixture(scope="module")
def models():
    """The reference's float, mxfp4 and cim trees of tiny qwen2-vl and the
    port's carried copies (cim: the reference's conversion under the
    port's calibration of the same weights and tokens)."""
    params, _ = jlm.init_model(jax.random.PRNGKey(0), JCFG)
    mx = _JMX(params, min_n=32)
    fl = from_reference(_np(params), device="cpu")
    _, tcalibs = tcalibrate.convert_model_cim(
        fl, TCFG, TCtx(dense_attn_max=256),
        [{"ids": torch.from_numpy(IDS[:, :SEQ])}], cim_cfg=tcim.CIMConfig(),
        min_n=32)
    assert "front_proj" not in tcalibs  # K = 24: not analog-eligible
    calibs = {path: jcim.LayerCalib(jnp.int32(int(c.e_n)),
                                    jnp.float32(float(c.adc_fs)))
              for path, c in tcalibs.items()}
    cim = _JCIM(params, calibs, min_n=32)
    return {"j": {"float": params, "mxfp4": mx, "cim": cim},
            "t": {"float": fl, "mxfp4": from_reference(_np(mx), device="cpu"),
                  "cim": from_reference(_np(cim), device="cpu")}}


def _ctxs(backend: str):
    cim = {"cim": jcim.CIMConfig()} if backend == "cim" else {}
    tcim_kw = {"cim": tcim.CIMConfig()} if backend == "cim" else {}
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256,
                          quant=QUANT[backend], unroll_layers=True, **cim)
    return jctx, TCtx(quant=QUANT[backend], dense_attn_max=256, **tcim_kw)


@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
def test_embed_inputs_with_vis_emb(backend, models):
    """``front_proj`` on ``vis_emb`` replaces the first nv embeddings,
    bitwise the reference's; it stays a float linear after conversion."""
    jctx, tctx = _ctxs(backend)
    jp, tp = models["j"][backend], models["t"][backend]
    assert set(tp["front_proj"]) == {"w"}
    batch = {"ids": IDS[:, :SEQ], "vis_emb": VIS}
    ref = jlm.embed_inputs(jctx, JCFG, jp,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    got = tlm.embed_inputs(tctx, TCFG, tp,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (1, SEQ, JCFG.d_model)
    np.testing.assert_array_equal(got.float().numpy(), _f32(ref))
    text = tlm.embed_inputs(tctx, TCFG, tp,
                            {"ids": torch.from_numpy(IDS[:, :SEQ])})
    nv = JCFG.n_vis_tokens
    assert torch.equal(got[:, nv:], text[:, nv:])
    assert not torch.equal(got[:, :nv], text[:, :nv])


@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
def test_prefill_and_decode_logits_match_reference(backend, models):
    """A text prefill into fused pages against the reference's eager
    ``unroll_layers`` forward, teacher-forced decode steps against the
    reference with its Pallas kernels in interpret mode, and a prefill
    with ``vis_emb``: logits SQNR >= 30 dB."""
    jparams, tparams = models["j"][backend], models["t"][backend]
    jctx, tctx = _ctxs(backend)
    mx_dig = tctx.hybrid_digital_sdpa
    jc = jlm.init_cache(JCFG, 1, PAGE, mx_digital=mx_dig, fused=True)
    tc = tlm.init_cache(TCFG, 1, PAGE, mx_digital=mx_dig, fused=True,
                        device="cpu")
    ids = IDS[:, :SEQ]
    ref, jc = jlm.forward(jparams, JCFG, jctx, {"ids": jnp.asarray(ids)},
                          caches=jc)
    got, tc = tlm.forward(tparams, TCFG, tctx, {"ids": torch.from_numpy(ids)},
                          caches=tc)
    assert got.shape == (1, SEQ, JCFG.vocab_size)
    assert _sqnr_db(ref, got.float()) >= 30.0
    dctx = dataclasses.replace(jctx, impl="pallas", interpret=True)
    for p in range(SEQ, SEQ + STEPS):
        ref, jc = jlm.decode_step(jparams, JCFG, dctx,
                                  jnp.asarray(IDS[:, p:p + 1]), jnp.int32(p),
                                  jc)
        got, tc = tlm.decode_step(tparams, TCFG, tctx,
                                  torch.from_numpy(IDS[:, p:p + 1]), p, tc)
        assert _sqnr_db(ref, got.float()) >= 30.0, p
    ref, _ = jlm.forward(jparams, JCFG, jctx, {"ids": jnp.asarray(ids),
                                               "vis_emb": jnp.asarray(VIS)})
    got, _ = tlm.forward(tparams, TCFG, tctx, {
        "ids": torch.from_numpy(ids), "vis_emb": torch.from_numpy(VIS)})
    assert _sqnr_db(ref, got.float()) >= 30.0


@pytest.mark.parametrize("backend", ["mxfp4", "cim"])
def test_launcher_serves_vlm_on_cpu(backend):
    """``--arch qwen2-vl-7b`` through the launcher's engine run (text
    prompts) on the CPU."""
    res = tserve.main(["--arch", NAME, "--serve-trace", "--device", "cpu",
                       "--backend", backend, "--requests", "3", "--tokens",
                       "4", "--log-level", "warning"])
    assert len(res["out"]) == 3
    assert all(len(v) == 4 for v in res["out"].values())
