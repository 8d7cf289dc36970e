"""The port's MoE family against the JAX reference: mixtral-8x22b (8
experts, top-2, sliding window) and qwen3-moe-235b-a22b (128 experts,
top-8, qk-norm).

- ``moe_apply`` on injected bf16 inputs and weights carried by
  ``from_reference``: swiglu, gelu and relu2, top-k 1, 2 and 8 over 16
  experts, at capacity factor 1.25 and at 0.5 (which drops tokens), under
  bf16, weight-only MXFP4 (packed banks), the hybrid ``cim`` backend and
  the STE fake-quant backend: bitwise in bf16. The sort, the capacity, the
  drops and the combine's order of adds are the reference's.
- ``expert_weight`` per backend bitwise; unknown names raise.
- Conversion of tiny mixtral: the banks are packed digital MXFP4 with the
  reference's codes and exponents, the router stays a bf16 leaf, the
  attention projections go analog under ``cim``; ``from_reference``
  unstacks float and packed banks; Row-Hist calibration gives the
  reference's paths and values (the banks and the router are not tapped).
- ``build_segments`` equals the reference's.
- Whole tiny models and the engine: ``tests/test_torch_moe_models.py``.
- ``PagedKVCache`` admits ``moe_attn`` segments and refuses other kinds.
- On the card (``cuda`` marker): every expert product of a packed bank
  launches the ``mxfp4_matmul`` kernel (``3E`` a layer), the layer holds
  to its ``impl="ref"`` composition, and kernel C holds to its plain
  version at the full-width expert shapes.
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
from repro.layers import backends as jbackends  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import calibrate as jcalibrate  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.kernels.mxfp4_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.mxfp4_matmul.ref import mxfp4_matmul_ref  # noqa: E402
from repro_torch.layers import backends as tbackends  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.layers.common import RunCtx as TCtx  # noqa: E402
from repro_torch.layers.common import convert_params_mxfp4  # noqa: E402
from repro_torch.layers.common import norm_apply  # noqa: E402
from repro_torch.models import calibrate as tcalibrate  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving.kvcache import PagedKVCache  # noqa: E402

ARCHS = ("mixtral-8x22b", "qwen3-moe-235b-a22b")
TINY = {name: jconfigs.tiny(jconfigs.ARCHS[name]) for name in ARCHS}
SEQ = 12
IDS = np.random.default_rng(0).integers(0, 128, (1, SEQ))


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


def _tcfg(name: str, **over):
    return tconfigs.ArchConfig(**(dataclasses.asdict(TINY[name]) | over))


def _carry(tree):
    """A reference subtree (no segments) carried into the port."""
    return from_reference({"segments": [], "t": _np(tree)}, device="cpu")["t"]


# ----------------------------------------------------------- moe_apply

@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("top_k", [1, 2, 8])
@pytest.mark.parametrize("kind", ["swiglu", "gelu", "relu2"])
def test_moe_apply_matches_reference(kind, top_k, cf):
    """One MoE sublayer, 48 bf16 rows over 16 experts, bitwise the
    reference's under bf16, packed MXFP4 banks, the hybrid backend (float
    banks fake-quantized) and the STE backend (rows, banks and the hidden
    activations fake-quantized). At capacity factor 0.5 some expert gets
    more rows than it has slots: those are dropped in both."""
    e, d, f = 16, 64, 96
    params, _ = jmoe.moe_init(jax.random.PRNGKey(top_k), d, f, e, kind,
                              "rmsnorm")
    packed = _JMX(params, min_n=32)
    x = np.random.default_rng(top_k).standard_normal((2, 24, d)).astype(
        np.float32)
    jx, tx = _bf16(x)
    for quant, tree in (("none", params), ("mxfp4_wonly", packed),
                        ("cim", params), ("mxfp4_ste", params)):
        jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), quant=quant)
        ref = jmoe.moe_apply(jctx, kind, "rmsnorm", tree, jx, top_k, cf)
        got = tmoe.moe_apply(TCtx(quant=quant), kind, "rmsnorm",
                             _carry(tree), tx, top_k, cf)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)),
                                      err_msg=quant)
    # the capacity is the reference's, and at 0.5 it drops rows
    tp = _carry(params)
    xn = norm_apply("rmsnorm", tp["ln"], tx).reshape(-1, d)
    _, idx = tmoe.route(xn, tp["router"]["w"], top_k)
    cap = tmoe.capacity(48, top_k, e, cf)
    assert cap == int(max(1, -(-48 * top_k * cf // e)))
    most = int(torch.bincount(idx.reshape(-1), minlength=e).max())
    assert most > cap or cf != 0.5


def test_route_breaks_ties_to_the_lower_expert():
    """Equal router probabilities: top-k takes the lower expert ids, as
    ``lax.top_k`` does; the gates are renormalised over the k taken."""
    xn = torch.ones((3, 32))
    w = torch.zeros((32, 8))
    w[:, 5] = 1.0  # expert 5 first, then ties among the rest
    gate, idx = tmoe.route(xn, w, 3)
    assert idx.tolist() == [[5, 0, 1]] * 3
    assert torch.allclose(gate.sum(-1), torch.ones(3))
    jp = jax.nn.softmax(jnp.asarray(xn.numpy()) @ jnp.asarray(w.numpy()))
    _, jidx = jax.lax.top_k(jp, 3)
    assert np.asarray(jidx).tolist() == idx.tolist()


@pytest.mark.parametrize("quant", ["none", "mxfp4_wonly", "mxfp4_digital",
                                   "cim", "packed", "bogus"])
def test_expert_weight_per_backend(quant):
    """bf16 [E, K, N] the reference's bitwise: a packed bank dequantized
    exactly, fake-quantized along K under the STE and hybrid backends,
    cast otherwise; an unknown backend name raises in both."""
    w = (np.random.default_rng(5).standard_normal((4, 64, 48))
         .astype(np.float32) * 0.2)
    jw = jnp.asarray(w)
    tw = torch.from_numpy(w)
    if quant == "bogus":
        with pytest.raises(ValueError):
            jbackends.expert_weight(
                jcommon.RunCtx(shd=jcommon.ShardingCtx(), quant=quant), jw)
        with pytest.raises(ValueError):
            tbackends.expert_weight(TCtx(quant=quant), tw)
        return
    if quant == "packed":
        jw = jbackends._quantize_packed(jw)
        tw = _carry(jw)
        quant = "none"
    ref = jbackends.expert_weight(
        jcommon.RunCtx(shd=jcommon.ShardingCtx(), quant=quant), jw)
    got = tbackends.expert_weight(TCtx(quant=quant), tw)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 64, 48)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


# ------------------------------------------------------------ models

@pytest.fixture(scope="module")
def models():
    """Tiny mixtral: the reference's float, mxfp4 and cim trees and the
    port's carried copies. The cim tree is the reference's conversion
    under the port's own calibration of the same weights and tokens (the
    reference's calibration is held to it in
    ``test_calibration_matches_reference``)."""
    name = "mixtral-8x22b"
    params, _ = jlm.init_model(jax.random.PRNGKey(0), TINY[name])
    mx = _JMX(params, min_n=32)
    fl = from_reference(_np(params), device="cpu")
    _, tcalibs = tcalibrate.convert_model_cim(
        fl, _tcfg(name), TCtx(dense_attn_max=256),
        [{"ids": torch.from_numpy(IDS[:, :SEQ])}], cim_cfg=tcim.CIMConfig(),
        min_n=32)
    calibs = {path: jcim.LayerCalib(jnp.int32(int(c.e_n)),
                                    jnp.float32(float(c.adc_fs)))
              for path, c in tcalibs.items()}
    cim = _JCIM(params, calibs, min_n=32)
    return {name: {"j": {"float": params, "mxfp4": mx, "cim": cim},
                   "t": {"float": fl,
                         "mxfp4": from_reference(_np(mx), device="cpu")},
                   "calibs": tcalibs}}


@pytest.mark.parametrize("name", ARCHS + ("qwen2-vl-7b",))
def test_build_segments_match_reference(name):
    """Full configs: the same fields, and the same runs of layers (kind,
    count, window, RoPE theta, M-RoPE, qk-norm)."""
    jcfg, tcfg = jconfigs.ARCHS[name], tconfigs.ARCHS[name]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jsegs, tsegs = jlm.build_segments(jcfg), tlm.build_segments(tcfg)
    assert [(s.kind, s.n) for s in tsegs] == [(s.kind, s.n) for s in jsegs]
    for t, j in zip(tsegs, jsegs):
        for field in ("window", "rope_theta", "head_dim", "n_heads", "n_kv",
                      "qk_norm", "mrope", "causal", "use_rope", "norm"):
            assert getattr(t.attn, field) == getattr(j.attn, field), field
    assert [(s.kind, s.n, s.attn.window) for s in tsegs] == {
        "mixtral-8x22b": [("moe_attn", 56, 4096)],
        "qwen3-moe-235b-a22b": [("moe_attn", 94, 0)],
        "qwen2-vl-7b": [("attn", 28, 0)]}[name]


@pytest.mark.parametrize("backend", ["mxfp4", "cim"])
def test_conversion_packs_expert_banks(backend, models):
    """Tiny mixtral converted: every layer's w1 / w2 / w3 bank is packed
    digital MXFP4 [E, K//2, N] uint8 with the reference's codes and
    exponents (the counterparts of the reference's
    ``test_convert_packs_stacked_weights`` and
    ``test_moe_experts_stay_digital_under_cim_conversion``); the router
    stays a bf16 leaf; under cim the projections are analog."""
    name = "mixtral-8x22b"
    jseg = models[name]["j"][backend]["segments"][0]
    if backend == "mxfp4":
        tree = convert_params_mxfp4(models[name]["t"]["float"], min_n=32)
    else:
        tree = tbackends.convert_params_cim(
            models[name]["t"]["float"], models[name]["calibs"], min_n=32)
    cfg = TINY[name]
    for j, layer in enumerate(tree["segments"][0]):
        moe = layer["moe"]
        for w, (k, n) in (("w1", (cfg.d_model, cfg.d_ff)),
                          ("w3", (cfg.d_model, cfg.d_ff)),
                          ("w2", (cfg.d_ff, cfg.d_model))):
            assert set(moe[w]) == {"codes", "exps"}
            assert moe[w]["codes"].dtype == torch.uint8
            assert moe[w]["codes"].shape == (cfg.n_experts, k // 2, n)
            for leaf in ("codes", "exps"):
                np.testing.assert_array_equal(
                    moe[w][leaf].numpy(), np.asarray(jseg["moe"][w][leaf][j]))
        assert moe["router"]["w"].dtype == torch.bfloat16
        assert moe["router"]["w"].shape == (cfg.d_model, cfg.n_experts)
        assert ("e_n" in layer["attn"]["wq"]) == (backend == "cim")


def test_router_stays_bf16_at_any_expert_count():
    """A router with E >= min_n (qwen3-moe's 128 experts at the launcher's
    min_n of 32) stays a bf16 leaf: it is read as a raw weight. Converted
    with ``free`` (each float layer dropped once packed), the tree is the
    one converted whole."""
    cfg = _tcfg("qwen3-moe-235b-a22b", n_experts=64, n_layers=2)
    fparams = tlm.init_model(cfg, torch.Generator().manual_seed(0))
    params = convert_params_mxfp4(fparams, 32, free=True)
    assert fparams["segments"] == [[None, None]]
    moe = params["segments"][0][0]["moe"]
    assert set(moe["router"]) == {"w"}
    assert moe["router"]["w"].dtype == torch.bfloat16
    assert moe["w1"]["codes"].shape == (64, 32, 96)
    whole = convert_params_mxfp4(
        tlm.init_model(cfg, torch.Generator().manual_seed(0)), min_n=32)
    assert _equal_trees(params, whole)


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("backend", ["float", "mxfp4"])
def test_from_reference_unstacks_banks(backend, models):
    """Float banks [n, E, K, N] and packed banks (codes [n, E, K//2, N],
    exps [n, E, K//32, N]) become one [E, ...] bank a layer; each
    expert's slice is contiguous, the kernel's resident format."""
    name = "mixtral-8x22b"
    jseg = models[name]["j"][backend]["segments"][0]["moe"]
    layers = models[name]["t"][backend]["segments"][0]
    assert len(layers) == TINY[name].n_layers
    for j, layer in enumerate(layers):
        if backend == "float":
            np.testing.assert_array_equal(layer["moe"]["w2"].numpy(),
                                          np.asarray(jseg["w2"][j]))
            continue
        for leaf in ("codes", "exps"):
            got = layer["moe"]["w1"][leaf]
            assert got[1].is_contiguous()
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jseg["w1"][leaf][j]))


def test_calibration_matches_reference(models):
    """Row-Hist calibration of tiny mixtral: the reference's paths (the
    attention projections and the head; no router, no bank) and values."""
    name = "mixtral-8x22b"
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), dense_attn_max=256)
    _, jcalibs = jcalibrate.convert_model_cim(
        models[name]["j"]["float"], TINY[name], jctx,
        [{"ids": jnp.asarray(IDS[:, :SEQ])}], cim_cfg=jcim.CIMConfig(),
        min_n=32)
    calibs = models[name]["calibs"]
    assert sorted(calibs) == sorted(jcalibs)
    assert "segments/0/L1/attn/wo" in calibs and "lm_head" in calibs
    assert not any("moe" in p for p in calibs)
    for path, cal in calibs.items():
        assert int(cal.e_n) == int(jcalibs[path].e_n), path
        assert float(cal.adc_fs) == float(jcalibs[path].adc_fs), path


def test_paged_cache_admits_moe_and_refuses_other_kinds(monkeypatch):
    """The reference's guard: attention-only segments (``attn`` and
    ``moe_attn``) take a paged pool; any other kind raises."""
    cfg = _tcfg("qwen3-moe-235b-a22b")
    kv = PagedKVCache(cfg, num_slots=2, lanes=1, page_len=8, device="cpu")
    assert len(kv.pool[0]) == cfg.n_layers
    seg = tlm.build_segments(cfg)[0]
    monkeypatch.setattr(tlm, "build_segments", lambda c: [
        dataclasses.replace(seg, kind="mamba")])
    with pytest.raises(NotImplementedError, match="attention-only"):
        PagedKVCache(cfg, num_slots=2, lanes=1, page_len=8, device="cpu")


def test_launcher_serves_moe_on_cpu():
    """``--arch`` takes the MoE archs: tiny qwen3-moe through the
    launcher's engine run on the CPU."""
    from repro_torch.launch import serve as tserve

    res = tserve.main(["--arch", "qwen3-moe-235b-a22b", "--serve-trace",
                       "--device", "cpu", "--backend", "mxfp4",
                       "--requests", "3", "--tokens", "4", "--log-level",
                       "warning"])
    assert len(res["out"]) == 3
    assert all(len(v) == 4 for v in res["out"].values())


# ------------------------------------------------ the kernels on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["swiglu", "relu2"])
def test_cuda_expert_products_launch_kernel_c(kind):
    """A packed-bank MoE layer on the card: one ``mxfp4_matmul`` launch an
    expert a bank (``3E`` with a GLU, ``2E`` without), and its output
    against the ``impl="ref"`` composition: SQNR >= 40 dB (kernel C
    accumulates in f32 in another order than the einsum)."""
    _cuda()
    e, d, f = 16, 256, 384
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = convert_params_mxfp4(tmoe.moe_init(gen, d, f, e, kind, "rmsnorm"),
                             min_n=32)
    x = torch.randn((2, 40, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    before = mm_ops.mxfp4_matmul.launches
    got = tmoe.moe_apply(TCtx(quant="mxfp4_wonly"), kind, "rmsnorm", p, x, 2)
    banks = 3 if kind == "swiglu" else 2
    assert mm_ops.mxfp4_matmul.launches == before + banks * e
    ref = tmoe.moe_apply(TCtx(quant="mxfp4_wonly", impl="ref"), kind,
                         "rmsnorm", p, x, 2)
    assert mm_ops.mxfp4_matmul.launches == before + banks * e
    assert _sqnr_db(ref.float().cpu() - x.float().cpu(),
                    got.float().cpu() - x.float().cpu()) >= 40.0


# (cap, K, N): the expert products of mixtral-8x22b (w1 / w3, w2) at
# decode and at a [1, 384] prefill, and of qwen3-moe-235b-a22b
EXPERT_SHAPES = [(2, 6144, 16384), (120, 6144, 16384), (2, 16384, 6144),
                 (120, 16384, 6144), (1, 4096, 1536), (30, 4096, 1536),
                 (1, 1536, 4096), (30, 1536, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", EXPERT_SHAPES)
def test_cuda_kernel_c_at_expert_shapes(m, k, n):
    """Kernel C on one expert's slice of a packed bank, at the shapes the
    served MoE layers give it, against its plain version: |err| <= 1e-2 +
    1e-2 |ref| (f32 sums in another order, one bf16 rounding)."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(m + k)
    bank = tbackends.quantize_bank(
        torch.randn((2, k, n), generator=gen, device="cuda") * k ** -0.5)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    got = mm_ops.mxfp4_matmul(x, bank["codes"][1], bank["exps"][1])
    ref = mxfp4_matmul_ref(x, bank["codes"][1], bank["exps"][1])
    err = (got.float() - ref.float()).abs()
    assert bool((err <= 1e-2 + 1e-2 * ref.float().abs()).all())


def test_fidelity_probes_analog_linears_only():
    """``--fidelity`` on tiny mixtral under cim: the probe covers the
    analog linears (the attention projections and the head) and the
    output; no router and no expert bank."""
    from repro_torch import obs as obs_lib
    from repro_torch.launch import serve as tserve

    args = tserve.build_parser().parse_args(
        ["--arch", "mixtral-8x22b", "--serve-trace", "--device", "cpu",
         "--backend", "cim", "--log-level", "warning"])
    obs = obs_lib.Obs()
    cfg, fparams, dev = tserve.init_lm(args)
    params, ctx = tserve.build_backend(args, cfg, fparams, dev, obs=obs)
    rep = tserve.run_fidelity(args, cfg, fparams, params, ctx, obs,
                              tserve.fidelity_batch(args, cfg, dev))
    want = {f"segments/0/L{j}/attn/{w}" for j in range(cfg.n_layers)
            for w in ("wq", "wk", "wv", "wo")} | {"lm_head"}
    assert set(rep["layers"]) - {"output"} == want
    assert rep["drift"]["n_drifted"] == 0
