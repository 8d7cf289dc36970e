"""The port's sharded train step over ``torch.distributed`` (FSDP
parameters, ZeRO-1 moments, the batch over the data axes), reshard-on-load
checkpoints and the sharded trainer, on the CPU: gloo ranks spawned by
``torch_dist.spawn`` (a ``FileStore`` under ``tmp_path``), tiny
h2o-danube-1.8b at [4, 32] under ``mxfp4_ste`` (the prequant), AdamW at lr
1e-2 with no warmup. Two spawns run every check of their world size
(``torch_fsdp_ranks.world2`` / ``world4``, the latter also world 1); each
test reads its part.

- World 1: the sharded step is bitwise the one-device step (every
  collective a copy).
- World 2 with clipping off: parameters, m, v and loss bitwise the
  one-device step with k = 2 (each rank's rows are one microbatch there;
  its loss is normalised by the global count, twice its own, an exact
  halving, and a sum of two terms is exact in either order).
- World 2 with the default clip, and world 4: grad norm within 1e-6
  relative (its squares are summed in another order), m >= 100 dB a
  leaf, parameters within twice the step's largest update, and each
  leaf's move (p - p0) >= 100 dB against the one-device move.
- A ragged ``loss_mask`` (a different count on each rank in each
  microbatch) against the one-device step with the same k, whose loss is
  one normalisation over all of a microbatch's rows, as GSPMD computes
  it: the loss within f32 rounding (1e-6 relative), m (the gradient)
  >= 40 dB a leaf (bf16 rounding of each rank's weight gradient, ~49
  dB). A mean of the ranks' own means misses both by far more, which
  the test shows too.
- The parameters cut over ``pod`` x ``data`` and the moments over
  ``data`` only (a 2 x 1 x 1 mesh: the two layouts differ) give the
  world-2 result bitwise; on a 2 x 2 x 1 mesh (the moments' blocks not in
  rank order) the world-4 tolerances hold.
- The reference's own ``make_train_step`` on an Auto-axes 1 x 1 ``Mesh``,
  lowered and compiled with XLA's excess precision off, against the
  port's world-2 step from the same converted init, both at lr 1, eps 1
  (Adam's first update then follows g, not its sign): PR 28's tolerances
  (loss and grad norm 1e-3 relative, lr equal, m >= 30 dB a leaf,
  parameters within twice the step's largest update, each leaf's move
  >= 30 dB against the reference's move).
- Shard shapes: each of 4 ranks' blocks of the ten archs' parameters and
  moments have ``shard_shape``'s shapes; ``lm.ref_ndim_tree`` pairs with
  the parameters leaf by leaf on the ten archs (the weight decay's ndim).
- Collectives: the recorded counts and bytes are those the shard shapes
  give, with the ring model's wire bytes.
- A model axis larger than 1 under a family it does not cover (tiny
  mixtral-8x22b: experts on ``model``) raises ``NotImplementedError``
  (``tests/test_torch_tp.py`` holds the covered ones); a mesh whose size
  is not the world size, and a mesh over the group without a GPU and
  without ``device="cpu"``, raise.
- Checkpoints: saved at world 2, restored at worlds 1 and 4, the global
  arrays bitwise; a world-2 ``Trainer`` killed and restarted is bitwise
  the uninterrupted one; a SIGTERM on one rank stops both after the same
  step.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import torch_dist  # noqa: E402
import torch_fsdp_ranks as R  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.distributed import roofline  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_train import _NO_EXCESS, _np, _paths, _sqnr_db  # noqa: E402

JCFG = jconfigs.tiny(jconfigs.ARCHS["h2o-danube-1.8b"])
# a different mask count on each rank in each microbatch (k = 2, rows
# 0-1 and 2-3; rank 0 takes rows 0 and 2, rank 1 rows 1 and 3)
RAGGED_COUNTS = (32, 5, 12, 29)
LM_ARCHS = sorted(C.ARCHS)


def _ragged_mask() -> np.ndarray:
    mask = np.zeros((R.SHAPE.batch, R.SHAPE.seq), np.float32)
    rng = np.random.default_rng(7)
    for row, n in enumerate(RAGGED_COUNTS):
        mask[row, rng.choice(R.SHAPE.seq, n, replace=False)] = 1.0
    return mask


def _ref_batch() -> dict:
    rng = np.random.default_rng(3)
    b, s = R.SHAPE.batch, R.SHAPE.seq
    return {"ids": rng.integers(0, 128, (b, s)).astype(np.int32),
            "labels": rng.integers(0, 128, (b, s)).astype(np.int32),
            "loss_mask": np.ones((b, s), np.float32)}


@pytest.fixture(scope="module")
def ref_init():
    params, _ = jlm.init_model(jax.random.PRNGKey(5), JCFG)
    return params


@pytest.fixture(scope="module")
def world2(tmp_path_factory, ref_init):
    tmp = tmp_path_factory.mktemp("world2")
    init = from_reference(_np(ref_init), device="cpu")
    out = torch_dist.spawn(R.world2, 2, tmp, str(tmp), init, _ref_batch(),
                           _ragged_mask())[0]
    return out, tmp


@pytest.fixture(scope="module")
def world4(world2, tmp_path_factory):
    _, tmp = world2
    return torch_dist.spawn(R.world4, 4, tmp, str(tmp),
                            str(tmp_path_factory.mktemp("w1") / "store"))[0]


def one_device(k: int, clip: float = 1.0, batch=None) -> dict:
    """The one-device step (``make_train_step(cfg, shape, ...)``) from
    the sharded bundles' init (seed 0) on their global batch."""
    params, _ = steps.param_structs(R.CFG, device="cpu")
    b = steps.make_train_step(R.CFG, R.SHAPE, R.opt(clip), microbatches=k,
                              device="cpu", dense_attn_max=R.DENSE)
    if batch is None:
        rows = C.concrete_inputs(R.CFG, R.SHAPE, device="cpu")
    else:
        rows = {n: torch.from_numpy(v) for n, v in batch.items()}
    before = [t.detach().clone() for t in adamw.leaves(params)]
    p, s, met = b.fn(params, adamw.init(params), rows)
    return {"params": [t.detach() for t in adamw.leaves(p)],
            "m": adamw.leaves(s.m), "v": adamw.leaves(s.v), "met": met,
            "before": before}


def _bitwise(want: dict, got: dict) -> None:
    for name in ("params", "m", "v"):
        assert len(want[name]) == len(got[name])
        for i, (a, b) in enumerate(zip(want[name], got[name])):
            assert torch.equal(a, b), (name, i)
    assert torch.equal(want["met"]["loss"], got["met"]["loss"])


def _close(want: dict, got: dict, grad_norm_rel: float = 1e-6) -> None:
    """grad norm within ``grad_norm_rel``, m >= 100 dB a leaf, the
    parameters within twice the step's largest update of each leaf and
    each leaf's move from the init >= 100 dB (a step that left a leaf
    where it was, or moved it the wrong way, fails the move)."""
    assert float(got["met"]["grad_norm"]) == pytest.approx(
        float(want["met"]["grad_norm"]), rel=grad_norm_rel)
    for i, (a, b) in enumerate(zip(want["m"], got["m"])):
        assert _sqnr_db(a.numpy(), b.numpy()) >= 100.0, i
    for i, (a, b, p0) in enumerate(zip(want["params"], got["params"],
                                       want["before"])):
        upd = float((a - p0).abs().max())
        torch.testing.assert_close(b, a, rtol=0, atol=2 * upd + 1e-7)
        assert _sqnr_db((a - p0).numpy(), (b - p0).numpy()) >= 100.0, i


# ------------------------------------------------------- the train step

def test_world1_bitwise_one_device(world4):
    _bitwise(one_device(1), world4["step1"])


def test_world2_clip_off_bitwise_k2(world2):
    out, _ = world2
    want = one_device(2, R.CLIP_OFF)
    _bitwise(want, out["clip_off"])
    # the norm is summed in another order: not asked to be bitwise
    assert float(out["clip_off"]["met"]["grad_norm"]) == pytest.approx(
        float(want["met"]["grad_norm"]), rel=1e-6)


def test_world2_clipped_and_world4(world2, world4):
    out, _ = world2
    _close(one_device(2), out["clip"])
    want = one_device(4)
    _close(want, world4["step"])
    _close(want, world4["pod"])  # pod x data, 2 x 2


def test_ragged_loss_mask_global_normalisation(world2):
    """Loss within f32 rounding; m (0.1 x the gradient) >= 40 dB a leaf:
    each rank's weight gradient leaves its backward's matmuls rounded to
    bf16 (the prequant's weights are bf16) before the f32 sum over the
    ranks, where the one-device step rounds the sum over both ranks' rows
    once (measured 48.4-62.7 dB, 146.7 on the f32 norm). The one-device
    step with k = 4 normalises each row, the part of a microbatch a rank
    holds, by its own count: a mean of the ranks' means, off by far more
    (1.4-4.1 dB; the loss 0.7% off)."""
    out, _ = world2
    batch = {n: t.numpy() for n, t in C.concrete_inputs(
        R.CFG, R.SHAPE, device="cpu").items()}
    batch["loss_mask"] = _ragged_mask()
    want = one_device(2, R.CLIP_OFF, batch=batch)
    got = out["ragged"]
    loss, ref = float(got["met"]["loss"]), float(want["met"]["loss"])
    assert loss == pytest.approx(ref, rel=1e-6)
    for i, (a, b) in enumerate(zip(want["m"], got["m"])):
        assert _sqnr_db(a.numpy(), b.numpy()) >= 40.0, i
    wrong = one_device(4, R.CLIP_OFF, batch=batch)
    assert abs(float(wrong["met"]["loss"]) - ref) > 1e-3 * ref
    for i, (a, b) in enumerate(zip(want["m"], wrong["m"])):
        assert _sqnr_db(a.numpy(), b.numpy()) < 10.0, i


def test_pod_layouts_differ_and_agree(world2):
    out, _ = world2
    mesh = Mesh(("pod", "data", "model"), (2, 1, 1),
                (torch.device("cpu"),) * 2)
    params, specs = steps.param_structs(R.CFG, device="meta")
    rules = shd.zero_rules(shd.make_rules(R.CFG, mesh, "train"), mesh)
    pctx = shd.ShardingCtx(mesh=mesh, rules=steps.param_rules(rules, mesh))
    p = shd.spec_leaves(params, shd.resolve_with_divisibility(
        specs, params, pctx, mesh))
    m = shd.spec_leaves(params, shd.resolve_with_divisibility(
        shd.opt_state_specs(specs), params, pctx, mesh))
    assert any(a != b for a, b in zip(p, m))
    _bitwise(out["clip_off"], out["pod"])


def test_reference_builder_on_auto_mesh(world2, ref_init):
    out, _ = world2
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    shape = jconfigs.Shape(R.SHAPE.seq, R.SHAPE.batch, "train")
    opt = jadamw.AdamWConfig(**R.REF_ADAM)
    b = jsteps.make_train_step(JCFG, mesh, shape, opt, quant="mxfp4_ste")
    assert jsteps.pick_microbatches(mesh, shape) == 1
    fn = b.fn.lower(*b.args).compile(compiler_options=_NO_EXCESS)
    before = dict(_paths(from_reference(_np(ref_init), device="cpu")))
    jp, js, jmet = fn(ref_init, jadamw.init(ref_init), _ref_batch())
    got = out["reference"]
    for name in ("loss", "grad_norm"):
        assert float(got["met"][name]) == pytest.approx(float(jmet[name]),
                                                        rel=1e-3), name
    assert float(got["met"]["lr"]) == float(jmet["lr"])
    # the bundle's leaves are in the port's init order
    paths = [path for path, _ in _paths(steps.param_structs(
        R.CFG, device="meta")[0])]
    want_m = dict(_paths(from_reference(_np(js.m), device="cpu")))
    for path, g in zip(paths, got["m"]):
        assert _sqnr_db(want_m[path].numpy(), g.numpy()) >= 30.0, path
    want_p = dict(_paths(from_reference(_np(jp), device="cpu")))
    for path, g in zip(paths, got["params"]):
        move = want_p[path] - before[path]
        upd = float(move.abs().max())
        np.testing.assert_allclose(g.numpy(), want_p[path].numpy(), rtol=0,
                                   atol=2 * upd + 1e-7, err_msg=path)
        assert _sqnr_db(move.numpy(),
                        (g - before[path]).numpy()) >= 30.0, path


# ------------------------------------------------- layouts, collectives

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_shard_shapes_at_4x1(arch):
    cfg = C.ARCHS[arch]
    meshes = [Mesh(("data", "model"), (4, 1), (torch.device("meta"),) * 4,
                   rank=r) for r in range(4)]
    mesh = meshes[0]
    params, specs = steps.param_structs(cfg, device="meta")
    rules = shd.zero_rules(shd.make_rules(cfg, mesh, "train"), mesh)
    pctx = shd.ShardingCtx(mesh=mesh, rules=steps.param_rules(rules, mesh))
    for tree_specs in (specs, shd.opt_state_specs(specs)):
        resolved = shd.spec_leaves(params, shd.resolve_with_divisibility(
            tree_specs, params, pctx, mesh))
        for t, spec in zip(adamw.leaves(params), resolved):
            want = shd.shard_shape(spec, t.shape, mesh)
            blocks = [shd.take_shard(t, spec, m) for m in meshes]
            assert all(tuple(b.shape) == want for b in blocks)
            assert shd.global_shape(spec, want, mesh) == tuple(t.shape)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_ref_ndim_tree_pairs_with_leaves(arch):
    """``lm.ref_ndim_tree`` keeps the tree's key order, so
    ``adamw.leaves`` pairs each parameter with its reference ndim (the
    weight decay's rule): one more inside a segment of several layers."""
    cfg = C.ARCHS[arch]
    params, _ = steps.param_structs(cfg, device="meta")
    want = []
    for key, v in params.items():
        if key != "segments":
            want += [t.ndim for t in adamw.leaves(v)]
            continue
        for seg, layers in zip(lm.build_segments(cfg), v):
            want += [t.ndim + (seg.n > 1) for t in adamw.leaves(layers)]
    assert adamw.leaves(lm.ref_ndim_tree(cfg, params)) == want


def test_collectives_match_shard_shapes(world2, world4):
    out, _ = world2
    mesh = Mesh(("data", "model"), (2, 1), (torch.device("meta"),) * 2,
                rank=0)
    params, specs = steps.param_structs(R.CFG, device="meta")
    rules = shd.zero_rules(shd.make_rules(R.CFG, mesh, "train"), mesh)
    pctx = shd.ShardingCtx(mesh=mesh, rules=steps.param_rules(rules, mesh))
    p = shd.spec_leaves(params, shd.resolve_with_divisibility(
        specs, params, pctx, mesh))
    m = shd.spec_leaves(params, shd.resolve_with_divisibility(
        shd.opt_state_specs(specs), params, pctx, mesh))
    leaves = adamw.leaves(params)

    def cut(spec):  # a block of the data axes
        return any(a in ("pod", "data") for e in spec
                   for a in shd.dim_axes(e))

    for world, got in ((2, out["clip_off"]), (4, world4["step"]),
                       (1, world4["step1"])):
        gathers = [t.numel() * 4 for t, s in zip(leaves, p) if cut(s)]
        scatters = [t.numel() * 4 // world for t, s in zip(leaves, m)
                    if cut(s)]
        reduces = [t.numel() * 4 for t, s in zip(leaves, m) if not cut(s)]
        reduces += [4, 4, 4]  # the mask counts (k = 1), loss, grad norm
        want = {"all-gather": [len(gathers), sum(gathers) * (world - 1)
                               / world, sum(gathers)],
                "reduce-scatter": [len(scatters),
                                   sum(scatters) * (world - 1),
                                   sum(scatters)],
                "all-reduce": [len(reduces), 2 * sum(reduces) * (world - 1)
                               / world, sum(reduces)]}
        assert got["collectives"] == want, world


def test_ring_model_and_link_time():
    st = roofline.CollectiveStats()
    st.add("all-gather", 800.0, 4)
    st.add("reduce-scatter", 200.0, 4)
    st.add("all-reduce", 100.0, 4)
    st.add("collective-permute", 50.0)
    assert st.by_kind == {"all-gather": [1, 600.0, 800.0],
                          "reduce-scatter": [1, 600.0, 200.0],
                          "all-reduce": [1, 150.0, 100.0],
                          "collective-permute": [1, 50.0, 50.0]}
    assert st.wire_bytes == 1400.0 and st.count == 4
    assert st.link_s() == 1400.0 / roofline.LINK_BW == 1400.0 / 450e9
    assert roofline.ring_wire_bytes("all-reduce", 8.0, 1) == 0.0
    with pytest.raises(ValueError):
        roofline.ring_wire_bytes("all-gather", 8.0, None)


def test_model_axis_world_size_and_no_gpu_raise(world2):
    out, _ = world2
    assert "model axis" in out["model_axis"]
    assert "ROADMAP.md" in out["model_axis"]
    assert out["world_size"][0] == "ValueError"
    assert "world size" in out["world_size"][1]
    if not torch.cuda.is_available():  # the ranks run on this host
        assert out["no_gpu"][0] == "RuntimeError"
        assert "device='cpu'" in out["no_gpu"][1]


# ------------------------------------------------ checkpoints, trainer

def test_reshard_on_load_worlds_1_and_4(world2, world4):
    out, _ = world2
    for restored in (world4["restore1"], world4["restore4"]):
        for name in ("params", "m", "v"):
            for a, b in zip(out["saved"][name], restored[name]):
                assert torch.equal(a, b), name


def test_trainer_kill_restart_and_sigterm_world2(world2):
    out, _ = world2
    assert out["trainer_full"] == 6 and out["trainer_start"] == 3
    full, resumed = out["kill_restart"]
    for name in ("params", "m", "v"):
        for a, b in zip(full[name], resumed[name]):
            assert torch.equal(a, b), name
    assert out["sigterm"] == (2, True, 2)


def test_loss_count_is_lm_loss_normaliser():
    """``lm.loss_count`` is the count ``lm_loss`` divides by: passing it
    as ``count`` gives the loss bitwise, on a ragged mask and a sequence
    that is not a whole number of chunks."""
    params, _ = steps.param_structs(R.CFG, device="cpu")
    batch = {n: torch.from_numpy(v) for n, v in _ref_batch().items()}
    batch["loss_mask"] = torch.from_numpy(_ragged_mask())
    ctx = dataclasses.replace(steps.make_train_step(
        R.CFG, R.SHAPE, device="cpu", dense_attn_max=R.DENSE).ctx,
        quant="none")
    with torch.no_grad():
        own = lm.lm_loss(params, R.CFG, ctx, batch, chunk=12)
        given = lm.lm_loss(params, R.CFG, ctx, batch, chunk=12,
                           count=lm.loss_count(batch, chunk=12))
    assert torch.equal(own, given)
    assert float(lm.loss_count(batch)) == sum(RAGGED_COUNTS)
