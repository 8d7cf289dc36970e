"""The port's other dense LM families against the JAX reference:
gemma3-1b (5:1 local:global, qk-norm, GeGLU, one KV head, tied head,
head_dim 256), h2o-danube-1.8b (sliding window, head_dim 80) and
nemotron-4-15b (full attention, squared-ReLU MLP without w3, LayerNorm,
untied head).

- Segments: ``build_segments`` of the full configs equals the
  reference's (kinds, layers, window and RoPE theta of each run); the
  launcher's page rule equals the reference's; so do the segments of the
  recurrent and audio configs (xlstm-125m, zamba2-1.2b, hubert-xlarge).
- Models: tiny gemma3 cut to 8 layers in both packages (segments L5 G1
  L2, so stacked and single-layer segments both come up) and tiny danube,
  and tiny danube and nemotron (2 layers), on weights carried by
  ``from_reference``: a prefill into fused pages against the reference's
  eager ``unroll_layers`` forward, then teacher-forced decode steps
  against the reference running its Pallas kernels in interpret mode,
  under float, mxfp4 and cim; logits SQNR >= 30 dB, the bound of
  ``tests/test_torch_lm.py``. Tiny gemma3's local layers have 16-slot
  windows, so their pages are 16-slot rings that wrap during the prompt.
  Row-Hist calibration of gemma3 gives the reference's paths and values;
  the GLU and squared-ReLU activations round as the reference's do; the
  engine's tokens of staggered requests equal each request's served
  alone.
- Head widths: ``tiny`` sets head_dim 16, so the real widths 80 (danube;
  MX-padded to 96) and 256 (gemma3) are held here on their own: the fused
  page layout and its quantized mirrors bitwise the reference's, the plain
  float and mx paged decodes against the reference's Pallas kernels in
  interpret mode at the bounds of ``tests/test_torch_paged_attention.py``,
  and ``_flash_attn`` against the reference's at the bounds of
  ``tests/test_torch_flash_prefill.py``. The kernels at these widths are
  held to their plain versions on the card (``cuda`` marker).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import cim as jcim  # noqa: E402
from repro.core import mx as jmx  # noqa: E402
from repro.kernels.paged_attention import kernel as jkernel  # noqa: E402
from repro.kernels.paged_attention import layout as jlayout  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import backends as jbackends  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.layers import ffn as jffn  # noqa: E402
from repro.models import calibrate as jcalibrate  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import _n_stacked, from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)
from repro_torch.kernels.paged_attention import layout as tlayout  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as tref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import ffn as tffn  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

ARCHS = ("gemma3-1b", "h2o-danube-1.8b", "nemotron-4-15b")
# tiny configs, gemma3 cut to 8 layers: segments L5 G1 L2
TINY = {name: dataclasses.replace(jconfigs.tiny(jconfigs.ARCHS[name]),
                                  **({"n_layers": 8} if name == "gemma3-1b"
                                     else {}))
        for name in ARCHS}
SEQ, PAGE, STEPS = 20, 24, 2
IDS = np.random.default_rng(0).integers(0, 128, (1, SEQ + STEPS))
QUANT = {"float": "none", "mxfp4": "mxfp4_wonly", "cim": "cim"}
WIDTHS = (80, 256)  # h2o-danube-1.8b, gemma3-1b


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _tcfg(name: str):
    return tconfigs.ArchConfig(**dataclasses.asdict(TINY[name]))


# ------------------------------------------------------------- segments

@pytest.mark.parametrize("name", ARCHS)
def test_build_segments_match_reference(name):
    """Full configs: the same runs of layers with the same window, RoPE
    theta and attention shape; gemma3-1b is L5 G1 L5 G1 L5 G1 L5 G1 L2."""
    jcfg, tcfg = jconfigs.ARCHS[name], tconfigs.ARCHS[name]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jsegs, tsegs = jlm.build_segments(jcfg), tlm.build_segments(tcfg)
    assert [(s.kind, s.n) for s in tsegs] == [(s.kind, s.n) for s in jsegs]
    for t, j in zip(tsegs, jsegs):
        for field in ("window", "rope_theta", "head_dim", "n_heads", "n_kv",
                      "qk_norm", "causal", "use_rope", "norm"):
            assert getattr(t.attn, field) == getattr(j.attn, field), field
    if name == "gemma3-1b":
        assert [(s.n, s.attn.window, s.attn.rope_theta) for s in tsegs] == (
            [(5, 512, 1e4), (1, 0, 1e6)] * 4 + [(2, 512, 1e4)])
    else:
        assert [(s.n, s.attn.window) for s in tsegs] == {
            "h2o-danube-1.8b": [(24, 4096)],
            "nemotron-4-15b": [(32, 0)]}[name]


@pytest.mark.parametrize("name", ("gemma3-1b", "h2o-danube-1.8b",
                                  "starcoder2-7b", "nemotron-4-15b",
                                  "mixtral-8x22b", "qwen3-moe-235b-a22b",
                                  "qwen2-vl-7b"))
def test_page_budget_matches_reference(name):
    """The launcher's page rule is the reference launcher's
    (``src/repro/launch/serve.py``, ``serve_trace``): prompt + tokens,
    kept inside the narrowest window; the prefill gets the rest."""
    jcfg = jconfigs.ARCHS[name]
    for prompt_len, tokens in ((12, 16), (384, 64), (2048, 32), (600, 8)):
        windows = [s.attn.window for s in jlm.build_segments(jcfg)
                   if s.attn is not None and s.attn.window > 0]
        page_len = prompt_len + tokens
        if windows:
            page_len = min(page_len, min(windows))
        want = (page_len, max(2, page_len - tokens))
        assert tserve.page_budget(tconfigs.ARCHS[name], prompt_len,
                                  tokens) == want
    assert tserve.page_budget(tconfigs.GEMMA3_1B, 384, 64) == (448, 384)


@pytest.mark.parametrize("name", ("xlstm-125m", "zamba2-1.2b",
                                  "hubert-xlarge"))
def test_recurrent_and_audio_segments_match_reference(name):
    """The families ported last: the port's full config is the
    reference's, and its segments are the reference's, kind, length and
    each block's static shape (xlstm-125m: mLSTM x3, sLSTM, mLSTM x5,
    sLSTM, mLSTM x2; zamba2-1.2b: six runs of 6 Mamba layers, each followed
    by a shared-block visit, then 2 Mamba layers and no visit; hubert-xlarge:
    one non-causal run without RoPE)."""
    jcfg, tcfg = jconfigs.ARCHS[name], tconfigs.ARCHS[name]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jsegs, tsegs = jlm.build_segments(jcfg), tlm.build_segments(tcfg)
    assert [(s.kind, s.n) for s in tsegs] == [(s.kind, s.n) for s in jsegs]
    for t, j in zip(tsegs, jsegs):
        for field in ("attn", "mamba", "xl"):
            tv, jv = getattr(t, field), getattr(j, field)
            assert (tv is None) == (jv is None), field
            if tv is not None:
                assert dataclasses.asdict(tv) == dataclasses.asdict(jv), field
    assert [(s.kind, s.n) for s in tsegs] == {
        "xlstm-125m": [("mlstm", 3), ("slstm", 1), ("mlstm", 5),
                       ("slstm", 1), ("mlstm", 2)],
        "zamba2-1.2b": [("mamba", 6), ("zshared", 1)] * 6 + [("mamba", 2)],
        "hubert-xlarge": [("attn", 48)]}[name]


# --------------------------------------------------------------- models

@pytest.fixture(scope="module")
def models():
    """Per arch: the reference's float, mxfp4 and Row-Hist cim trees and
    the port's carried copies. gemma3 calibrates in the reference (on the
    prompt's first SEQ tokens: eager JAX compiles each op, which takes most
    of this file's time); danube's and nemotron's cim trees are the
    reference's conversion under the port's own calibration of the same
    weights and tokens."""
    out = {}
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    batch = [{"ids": jnp.asarray(IDS[:, :SEQ])}]
    for name in ARCHS:
        jcfg = TINY[name]
        params, _ = jlm.init_model(jax.random.PRNGKey(0), jcfg)
        mx = jax.jit(jcommon.convert_params_mxfp4,
                     static_argnames="min_n")(params, min_n=32)
        if name == "gemma3-1b":
            cim, calibs = jcalibrate.convert_model_cim(
                params, jcfg, jctx, batch, cim_cfg=jcim.CIMConfig(), min_n=32)
        else:
            _, tcalibs = tcalibrate.convert_model_cim(
                from_reference(to_np(params), device="cpu"), _tcfg(name),
                TCtx(dense_attn_max=256),
                [{"ids": torch.from_numpy(IDS[:, :SEQ])}],
                cim_cfg=tcim.CIMConfig(), min_n=32)
            calibs = {path: jcim.LayerCalib(jnp.int32(int(c.e_n)),
                                            jnp.float32(float(c.adc_fs)))
                      for path, c in tcalibs.items()}
            cim = jbackends.convert_params_cim(params, calibs, min_n=32)
        out[name] = {"j": {"float": params, "mxfp4": mx, "cim": cim},
                     "t": {b: from_reference(to_np(tree), device="cpu")
                           for b, tree in (("float", params), ("mxfp4", mx),
                                           ("cim", cim))},
                     "calibs": calibs}
    return out


def _ctxs(backend: str, **jkw):
    cim = {"cim": jcim.CIMConfig()} if backend == "cim" else {}
    tcim_kw = {"cim": tcim.CIMConfig()} if backend == "cim" else {}
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256,
                          quant=QUANT[backend], unroll_layers=True, **cim,
                          **jkw)
    return jctx, TCtx(quant=QUANT[backend], dense_attn_max=256, **tcim_kw)


def test_from_reference_keeps_single_layer_segments(models):
    """The reference stacks runs of layers and keeps a single layer as it
    is (``src/repro/models/lm.py``: ``seg.n == 1``); the port carries both
    into one dict a layer."""
    jtree, ttree = models["gemma3-1b"]["j"]["cim"], models["gemma3-1b"]["t"]["cim"]
    assert [len(s) for s in ttree["segments"]] == [5, 1, 2]
    assert [_n_stacked(s) for s in jtree["segments"]] == [5, 0, 2]
    for i, j in ((0, 3), (1, None), (2, 1)):
        ref = jtree["segments"][i]["ffn"]["w3"]["e_n"]
        got = ttree["segments"][i][j or 0]["ffn"]["w3"]["e_n"]
        assert int(got) == int(ref if j is None else ref[j])
    assert "lm_head" not in ttree  # tied to the embedding


def test_calibration_matches_reference(models):
    """The port's Row-Hist calibration of tiny gemma3 from the same float
    weights and tokens: the reference's capture paths over its three
    segments (``segments/<i>/L<j>/...`` for a run, ``segments/<i>/...`` for
    the single global layer) and values."""
    name = "gemma3-1b"
    _, calibs = tcalibrate.convert_model_cim(
        models[name]["t"]["float"], _tcfg(name), TCtx(dense_attn_max=256),
        [{"ids": torch.from_numpy(IDS[:, :SEQ])}], cim_cfg=tcim.CIMConfig(),
        min_n=32)
    jcalibs = models[name]["calibs"]
    assert sorted(calibs) == sorted(jcalibs)
    # wq wo w1 w3 w2 of 8 layers: wk / wv (16 outputs) are under min_n,
    # and the head is tied to the embedding
    assert len(calibs) == 5 * 8
    assert "segments/1/attn/wq" in calibs
    assert "segments/2/L1/ffn/w3" in calibs
    for path, cal in calibs.items():
        assert int(cal.e_n) == int(jcalibs[path].e_n), path
        assert float(cal.adc_fs) == float(jcalibs[path].adc_fs), path


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_glu_activations_match_reference(kind, dtype):
    """danube's SwiGLU and gemma3's GeGLU activations, op by op as the
    reference's ``jax.nn.silu`` / ``jax.nn.gelu`` round them, and
    nemotron's squared ReLU: bitwise in bf16, the served dtype (a fused
    silu differs in about a third of outputs, a gelu that takes 0.044715
    as a Python float in 0.3%); in f32 within 1e-6 (XLA fuses the f32
    chain: last-ulp differences)."""
    x = (np.random.default_rng(0).standard_normal(4096) * 3).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16"
                                else jnp.float32)
    ref = np.asarray(jffn._act(kind, jx).astype(jnp.float32))
    got = tffn._act(kind, torch.from_numpy(np.asarray(
        jx.astype(jnp.float32))).to(torch.bfloat16 if dtype == "bf16"
                                    else torch.float32)).float().numpy()
    if dtype == "bf16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_logits_match_reference(name, backend, models):
    """A prefill into fused pages (quantized-resident under cim) against
    the reference's eager ``unroll_layers`` forward, then teacher-forced
    decode steps against the reference running its Pallas kernels in
    interpret mode: logits SQNR >= 30 dB."""
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


@pytest.mark.parametrize("backend", ["mxfp4", "cim"])
@pytest.mark.parametrize("name", ARCHS)
def test_engine_staggered_equals_solo(name, backend, models):
    """Staggered requests through the engine give each request the tokens
    it gets alone (page 16: within tiny gemma3's 16-slot window)."""
    cfg, params = _tcfg(name), models[name]["t"][backend]
    _, ctx = _ctxs(backend)
    ecfg = EngineConfig(lanes=2, num_slots=3, page_len=16, prefill_len=10)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab_size, int(n)).tolist(), int(m))
            for n, m in ((9, 6), (4, 7), (10, 5), (2, 8))]
    eng = Engine(params, cfg, ctx, ecfg)
    rids = []
    for prompt, n_new in reqs:
        rids.append(eng.add_request(prompt, max_new=n_new))
        eng.step()
    together = eng.run()
    for rid, (prompt, n_new) in zip(rids, reqs):
        solo = Engine(params, cfg, ctx, ecfg)
        solo.add_request(prompt, max_new=n_new)
        assert solo.run()[0] == together[rid], rid
        assert len(together[rid]) == n_new


# ---------------------------------------------------------- head widths

P, HKV, G = 5, 2, 2
LENS = ([0, 1, 31, 48], [32, 33, 47, 0])


def _bf16(a: np.ndarray):
    """(jax bf16 array, torch bf16 tensor) with identical bits."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j).view(np.int16)).view(torch.bfloat16)
    return j, t


def _pages(seed: int, dh: int, w: int = 48, lanes: int = 4):
    rng = np.random.default_rng(seed)
    k, v = (_bf16(rng.standard_normal((P, w, HKV, dh)).astype(np.float32)
                  * 0.7) for _ in range(2))
    q = _bf16(rng.standard_normal((lanes, HKV, G, dh)).astype(np.float32)
              * 0.7)
    return k, v, q


def _close(got, ref, live, sqnr_min, atol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert _sqnr_db(ref[live], got[live]) > sqnr_min
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0.0)
    np.testing.assert_array_equal(got[~live], 0.0)


@pytest.mark.parametrize("dh", WIDTHS)
def test_page_layout_bitwise_at_head_width(dh):
    """``padded_head_dim`` (96 at 80), the zero mirrors, ``quant_page_full``
    and the in-place ``quant_page_step`` bitwise the reference's."""
    assert tlayout.padded_head_dim(dh) == jlayout.padded_head_dim(dh)
    zj = jlayout.fused_quant_init(2, 40, HKV, dh)
    zt = tlayout.fused_quant_init(2, 40, HKV, dh, device="cpu")
    for name in ("kv_codes", "k_exps", "v_exps"):
        np.testing.assert_array_equal(zt[name].numpy(), np.asarray(zj[name]))
    k, v, _ = _pages(1, dh, w=50)
    jq = jax.jit(jlayout.quant_page_full)(k[0], v[0])
    tq = tlayout.quant_page_full(k[1], v[1])
    for name in ("kv_codes", "k_exps", "v_exps"):
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jq[name]))
    rng = np.random.default_rng(2)
    jnew, tnew = _bf16(rng.standard_normal((3, 2 * HKV, dh))
                       .astype(np.float32))
    rows, slot = np.array([4, 0, 2]), np.array([49, 0, 33])
    jkv = jlayout.fuse_kv(k[0], v[0]).at[rows, slot].set(jnew)
    tkv = tlayout.fuse_kv(k[1], v[1])
    tkv[torch.from_numpy(rows), torch.from_numpy(slot)] = tnew
    jout = jax.jit(jlayout.quant_page_step)(jq, jkv, jnp.asarray(rows),
                                            jnp.asarray(slot))
    tlayout.quant_page_step(tq, tkv, torch.from_numpy(rows),
                            torch.from_numpy(slot))
    for name in ("kv_codes", "k_exps", "v_exps"):
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jout[name]))


@pytest.mark.parametrize("dh", WIDTHS)
def test_plain_decodes_match_pallas_interpret_at_head_width(dh):
    """The plain versions of kernels B and D against the Pallas kernels
    they replace (interpret mode, W = 48, bk = 32: a clamped tail chunk),
    at the bounds of ``tests/test_torch_paged_attention.py``: mx SQNR > 40
    dB and atol 0.05, float atol 1e-2; empty lanes exactly zero."""
    k, v, q = _pages(4, dh)
    scale = dh ** -0.5
    jq, tq = jax.jit(jlayout.quant_page_full)(k[0], v[0]), \
        tlayout.quant_page_full(k[1], v[1])
    kvj, kvt = jlayout.fuse_kv(k[0], v[0]), tlayout.fuse_kv(k[1], v[1])
    qmx_j = jax.jit(jmx.fake_quant)(q[0]).astype(jnp.bfloat16)
    qmx_t = tmx.fake_quant(q[1])
    rows = np.array([4, 0, 2, 1])
    for lens in LENS:
        lens = np.array(lens)
        live = lens > 0
        jrows, jlens = jnp.asarray(rows, jnp.int32), jnp.asarray(lens,
                                                                 jnp.int32)
        trows, tlens = torch.from_numpy(rows), torch.from_numpy(lens)
        ref = jkernel.paged_flash_decode_mx(
            qmx_j, jq["kv_codes"], jq["k_exps"], jq["v_exps"], jrows, jlens,
            scale=scale, bk=32, interpret=True)
        got = tops.ragged_paged_decode(qmx_t, trows, tlens, quant=tq,
                                       scale=scale)
        _close(got.float(), ref, live, 40.0, 0.05)
        ref = jkernel.paged_flash_decode(q[0], kvj, jrows, jlens, scale=scale,
                                         bk=32, interpret=True)
        got = tops.ragged_paged_decode(q[1], trows, tlens, kv=kvt,
                                       scale=scale)
        _close(got.float(), ref, live, 40.0, 1e-2)


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dh", WIDTHS)
def test_flash_attn_matches_reference_at_head_width(dh, dtype):
    """``_flash_attn`` (ragged 16-key and 24-query tiles, a window, a
    KV_PAD tail on one row) against the reference's eager one: f32 2e-5,
    bf16 3e-2; and the kernel route's plain version (``_flash_kernel``)
    within the bf16 bound of it."""
    np_dt = np.float32 if dtype == "f32" else ml_dtypes.bfloat16
    b, s, tail = 2, 40, 5
    rng = np.random.default_rng(dh)
    q = rng.standard_normal((b, s, HKV, G, dh))
    k, v = (rng.standard_normal((b, s, HKV, dh)) for _ in range(2))
    pos = np.tile(np.arange(s), (b, 1))
    pos[0, s - tail:] = tattn.KV_PAD
    live = (pos > tattn.KV_PAD // 2)[:, :, None, None]
    q, k, v = (a.astype(np_dt) for a in (q, k * live, v * live))
    kw = dict(d_model=HKV * G * dh, n_heads=HKV * G, n_kv=HKV, head_dim=dh,
              causal=True, window=12)
    chunks = dict(attn_chunk=16, q_chunk=24)
    ref = jattn._flash_attn(
        *map(jnp.asarray, (q, k, v, pos, pos)), jattn.AttnStatic(**kw),
        jcommon.RunCtx(shd=jcommon.ShardingCtx(), **chunks))
    cfg, ctx = tattn.AttnStatic(**kw), TCtx(arange_positions=True, **chunks)
    tq, tk, tv, tpos = map(_to_torch, (q, k, v, pos))
    got = tattn._flash_attn(tq, tk, tv, tpos, tpos, cfg, ctx)
    tol = 2e-5 if dtype == "f32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)
    kern = tattn._flash_kernel(ctx, cfg, tq, tk, tv, tpos)
    np.testing.assert_allclose(kern.float().numpy(), got.float().numpy(),
                               rtol=3e-2, atol=3e-2)
    assert not kern.float()[0, s - tail:].any()


# ------------------------------------------------ the kernels on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


# (L, Hkv, G, head_dim, W): the serve shapes of gemma3-1b and
# h2o-danube-1.8b (page 448), a pool wider than a warp's keys, and the
# groups of qwen3-moe-235b-a22b (G 16, the kernels' G_MAX) and qwen2-vl-7b
# (G 7, odd) at page 448
_DECODE_SHAPES = [(4, 1, 4, 256, 448), (4, 8, 4, 80, 448), (3, 2, 5, 80, 48),
                  (3, 2, 3, 256, 64), (4, 4, 16, 128, 448),
                  (4, 4, 7, 128, 448)]


def _decode_inputs(l, hkv, g, dh, w, seed=0):
    rng = np.random.default_rng(seed)
    k, v = (torch.from_numpy(rng.standard_normal((6, w, hkv, dh))
                             .astype(np.float32) * 0.7).to(torch.bfloat16)
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((l, hkv, g, dh))
                         .astype(np.float32) * 0.7).to(torch.bfloat16)
    rows = torch.tensor([5, 0, 3, 1][:l], dtype=torch.int32)
    lens = torch.tensor([0, 1, w // 2, w][:l] if l == 4 else [w, 0, 17],
                        dtype=torch.int32)
    return k, v, q, rows, lens


@pytest.mark.cuda
@pytest.mark.parametrize("l,hkv,g,dh,w", _DECODE_SHAPES)
def test_cuda_decodes_match_plain_versions_at_head_width(l, hkv, g, dh, w):
    """Kernels D (float pages) and B (MXFP4 mirrors) at head widths 80 and
    256 against their plain versions on the card: SQNR > 40 dB, atol 1e-2
    (D) and 0.05 (B), exact zeros on empty lanes; one launch each."""
    _cuda()
    k, v, q, rows, lens = _decode_inputs(l, hkv, g, dh, w)
    scale, bk = dh ** -0.5, tops.pick_bk(w)
    kv = tlayout.fuse_kv(k, v).cuda()
    quant = {n: t.cuda() for n, t in tlayout.quant_page_full(k, v).items()}
    qc, qmx = q.cuda(), tmx.fake_quant(q).cuda()
    rows, lens = rows.cuda(), lens.cuda()
    live = (lens > 0).cpu().numpy()
    before = (tops.paged_flash_decode.launches,
              tops.paged_flash_decode_mx.launches)
    got = tops.ragged_paged_decode(qc, rows, lens, kv=kv, scale=scale)
    ref = tref.paged_flash_decode_ref(qc, kv, rows, lens, scale=scale, bk=bk)
    _close(got.float().cpu(), ref.float().cpu(), live, 40.0, 1e-2)
    got = tops.ragged_paged_decode(qmx, rows, lens, quant=quant, scale=scale)
    ref = tref.paged_flash_decode_mx_ref(
        qmx, quant["kv_codes"], quant["k_exps"], quant["v_exps"], rows, lens,
        scale=scale, bk=bk)
    _close(got.float().cpu(), ref.float().cpu(), live, 40.0, 0.05)
    assert (tops.paged_flash_decode.launches,
            tops.paged_flash_decode_mx.launches) == (before[0] + 1,
                                                     before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,hkv,dh,window", [(384, 4, 1, 256, 512),
                                               (300, 8, 2, 80, 100),
                                               (130, 8, 2, 256, 0)])
def test_cuda_flash_attention_at_head_width(s, h, hkv, dh, window, dtype):
    """Kernel E's fma route at head widths 80 and 256 (gemma3-1b's prefill
    heads, a window, a ragged length) against its plain version: |err| <=
    1e-2 + 1e-2 |ref|; one launch on ``fma``."""
    _cuda()
    rng = np.random.default_rng(dh + s)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dtype).cuda()
               for shape in ((1, s, h, dh), (1, s, hkv, dh), (1, s, hkv, dh)))
    assert tfa_ops.pick_route(s, s, dh, dtype) == "fma"
    before = tfa_ops.flash_attention.route_launches["fma"]
    got = tfa_ops.flash_attention(q, k, v, causal=True, window=window)
    assert tfa_ops.flash_attention.route_launches["fma"] == before + 1
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= 1e-2 + 1e-2 * ref.float().abs()).all())
