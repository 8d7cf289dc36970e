"""``launch.steps.make_paged_decode_step`` in the port, against the
reference's own builder and the port's engine, on the CPU (tiny
starcoder2-7b).

- The reference's ``make_paged_decode_step`` on an Auto-axes 1 x 1
  ``jax.sharding.Mesh`` (``jax.make_mesh``'s Explicit axes break its
  sharding constraints), lowered and compiled with XLA's excess precision
  off, and the port's bundle, on the same weights (``from_reference``),
  pool (random K/V in every row), rows (a lane on a request page, a lane
  parked on its scratch row), ids and positions: both KV layouts, under
  ``quant="none"`` and ``"mxfp4_wonly"``. The port's bundle is the one
  it serves with (on the CPU its kernels' plain versions: under
  ``fused`` the chunked online softmax of the paged decode kernels,
  which rounds otherwise than the reference's dense decode, and a
  layer's attention output feeds the next layer's K/V row). Next ids
  equal; every pool leaf's change from the step's input at >= 30 dB
  against the reference's change (the repo's gate), and an unchanged
  leaf bitwise.
- The port's bundle against the engine's own steps
  (``serving.engine._decode_step`` / ``_legacy_decode_step``) on one pool:
  ids and pool bitwise, under ``cim`` too (the quantized-resident pool).
- The bundle's arguments, pool specs and an unknown layout's
  ``ValueError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.layers.common import RunCtx  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import engine as eng_mod  # noqa: E402
from test_torch_train import _NO_EXCESS, _np, _sqnr_db  # noqa: E402

CFG = C.tiny(C.STARCODER2_7B)
JCFG = jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"])
LANES, SLOTS, PAGE = 2, 3, 8
SHAPE = C.Shape(PAGE, LANES, "decode")
ROWS = np.array([1, SLOTS + 1], np.int32)  # lane 0 slot 1, lane 1 parked
IDS = np.array([[17], [5]], np.int32)
POS = np.array([5, 0], np.int32)


def _random_pool(pool) -> list:
    """Random values of each leaf's dtype (numpy), one rng for all."""
    rng = np.random.default_rng(11)
    out = []
    for seg in pool:
        leaves = {}
        for k, v in seg.items():
            a = np.asarray(v)
            if np.issubdtype(a.dtype, np.integer):
                leaves[k] = rng.integers(0, 16, a.shape).astype(a.dtype)
            else:
                leaves[k] = (rng.standard_normal(a.shape) * 0.5).astype(
                    a.dtype)
        out.append(leaves)
    return out


def _tensor(a) -> torch.Tensor:
    a = np.array(a)  # a copy: the port's step writes its pool in place
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_port(pool_np, cfg) -> list:
    """The reference's pool (a layer axis in front of a segment of several
    layers) as the port's: one dict a layer."""
    out = []
    for seg, leaves in zip(lm.build_segments(cfg), pool_np):
        if seg.n > 1:
            out.append([{k: _tensor(np.asarray(v)[j])
                         for k, v in leaves.items()} for j in range(seg.n)])
        else:
            out.append([{k: _tensor(np.asarray(v))
                         for k, v in leaves.items()}])
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.fixture(scope="module")
def ref_params():
    params, _ = jlm.init_model(jax.random.PRNGKey(0), JCFG)
    return params


@pytest.mark.parametrize("quant", ["none", "mxfp4_wonly"])
@pytest.mark.parametrize("layout", ["legacy", "fused"])
def test_paged_step_matches_reference_builder(ref_params, quant, layout):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jb = jsteps.make_paged_decode_step(JCFG, mesh, jconfigs.Shape(
        PAGE, LANES, "decode"), SLOTS, quant=quant, kv_layout=layout)
    fn = jb.fn.lower(*jb.args).compile(compiler_options=_NO_EXCESS)
    params = ref_params
    if quant == "mxfp4_wonly":  # the bundle's structure: the default min_n
        params = jax.jit(jsteps.convert_params_mxfp4)(params)
    pool_np = _random_pool(jlm.init_cache(
        JCFG, SLOTS + LANES, PAGE, fused=layout == "fused"))
    port_pool = _to_port(pool_np, CFG)
    j_ids, j_pool = fn(params, pool_np, ROWS, IDS, POS)

    tb = steps.make_paged_decode_step(CFG, make_local_mesh(1, 1, "cpu"),
                                      SHAPE, SLOTS, quant=quant,
                                      kv_layout=layout, device="cpu")
    t_ids, t_pool = tb.fn(from_reference(_np(params), device="cpu"),
                          port_pool, torch.from_numpy(ROWS),
                          torch.from_numpy(IDS), torch.from_numpy(POS))
    assert t_ids.dtype == torch.int32
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    want = _to_port(jax.tree.map(np.asarray, j_pool), CFG)
    before = _to_port(pool_np, CFG)
    for seg_t, seg_w, seg_0 in zip(t_pool, want, before):
        for lay_t, lay_w, lay_0 in zip(seg_t, seg_w, seg_0):
            for k in lay_w:
                w0 = lay_w[k].float() - lay_0[k].float()
                if not w0.any():
                    assert torch.equal(_bits(lay_t[k]), _bits(lay_w[k])), k
                    continue
                t0 = lay_t[k].float() - lay_0[k].float()
                assert _sqnr_db(w0.numpy(), t0.numpy()) >= 30.0, k


@pytest.mark.parametrize("quant,layout", [("none", "legacy"),
                                          ("mxfp4_wonly", "fused"),
                                          ("cim", "fused")])
def test_paged_step_is_the_engines_step(quant, layout):
    """The bundle's step and the engine's on copies of one pool (float
    weights from seed 0; under ``cim`` unconverted, so the linears run
    the digital path and the pool is quantized-resident)."""
    tb = steps.make_paged_decode_step(CFG, make_local_mesh(1, 1, "cpu"),
                                      SHAPE, SLOTS, quant=quant,
                                      kv_layout=layout, device="cpu")
    params, pool = tb.args[:2]
    rng = np.random.default_rng(2)
    for seg in pool:
        for layer in seg:
            for k, v in layer.items():
                if v.is_floating_point():
                    v.copy_(torch.from_numpy(rng.standard_normal(
                        tuple(v.shape)).astype(np.float32) * 0.5))
                else:
                    v.copy_(torch.from_numpy(rng.integers(
                        0, 16, tuple(v.shape))))
    copy = [[{k: v.clone() for k, v in layer.items()} for layer in seg]
            for seg in pool]
    specs = lm.cache_specs(CFG, mx_digital=tb.ctx.hybrid_digital_sdpa,
                           fused=layout == "fused")
    step_in = torch.from_numpy(np.stack([ROWS, IDS[:, 0], POS])).long()
    ctx = RunCtx(quant=quant)
    if layout == "fused":
        want = eng_mod._decode_step(params, CFG, ctx, copy, step_in)
    else:
        want = eng_mod._legacy_decode_step(params, CFG, ctx, copy, specs,
                                           step_in)
    got, pool = tb.fn(params, pool, torch.from_numpy(ROWS),
                      torch.from_numpy(IDS), torch.from_numpy(POS))
    assert torch.equal(got.long(), want)
    for seg_a, seg_b in zip(pool, copy):
        for la, lb in zip(seg_a, seg_b):
            for k in la:
                assert torch.equal(_bits(la[k]), _bits(lb[k])), k


def test_paged_step_bundle_arguments():
    mesh = make_local_mesh(1, 1, "cpu")
    tb = steps.make_paged_decode_step(CFG, mesh, SHAPE, SLOTS,
                                      kv_layout="fused", device="meta")
    params, pool, rows, ids, pos = tb.args
    assert tuple(rows.shape) == (LANES,) and tuple(ids.shape) == (LANES, 1)
    assert rows.dtype == ids.dtype == pos.dtype == torch.int32
    leaf = pool[0][0]["kv"]
    assert leaf.device.type == "meta" and leaf.shape[0] == SLOTS + LANES
    assert tb.shardings[1][0][0]["kv"][0] == "data"  # the slot axis: batch
    with pytest.raises(ValueError, match="layout"):
        steps.make_paged_decode_step(CFG, mesh, SHAPE, SLOTS,
                                     kv_layout="split", device="meta")
