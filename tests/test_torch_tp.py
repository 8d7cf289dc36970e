"""The model axis of the port's sharded train step (tensor parallelism
over ``heads``, ``qkv_fused`` / ``kv_fused``, ``mlp`` and ``vocab`` on
``torch.distributed``), on the CPU: gloo ranks spawned by
``torch_dist.spawn``, the tiny dense and vlm configs (``configs.tiny``:
h2o-danube-1.8b, starcoder2-7b with biases and layernorm, gemma3-1b's 12
layers with kv 1, qk-norm and tied embeddings, nemotron-4-15b,
qwen2-vl-7b with its vision front end) at [4, 32] under ``mxfp4_ste``
(the prequant), AdamW at lr 1, eps 1 (Adam's first update then follows
g, so each leaf's move has meaning). One world-2 spawn runs every check
on a (data, model) = (1, 2) mesh; one world-4 spawn runs (2, 2) then
(1, 4), the checkpoint's restores, the launcher's pod mesh, and, on rank
0 alone, (1, 1) on a group of one (``torch_tp_ranks``).

- Each config at (1, 2), (2, 2) and (1, 4) against the one-device step
  (k = the data size, so each data rank's rows are one microbatch):
  loss and grad norm within 1e-3 relative, each leaf's m (the gradient)
  and move >= 40 dB, parameters within twice the step's largest update
  of each leaf + 1e-7. The sums over the model ranks run in f32 and
  round once, where the one-device products round (measured: danube and
  qwen2-vl >= 93 dB, starcoder2-7b and nemotron >= 50, gemma3-1b >= 41:
  its qk-norm amplifies the f32 order of the sums of the attention's
  products over fewer heads).
- (1, 1) on a group of one is ``torch.equal`` to the one-device step.
- The step-boundary fake-quant of each rank's model shards is bitwise
  that shard of the one-device quant, on both branches: ``w2``'s K
  shard of 48 rows (d_ff 96: gathered over the model ranks, quantized,
  cut) and of 64 (d_ff 128: quantized on the shard).
- The gradients of the leaves replicated over ``model`` (norms, the
  biases of row-parallel outputs, the qk-norm gammas) are bitwise equal
  on the two model ranks.
- The vocab-parallel embedding is bitwise the one-device lookup.
- The reference's own ``make_train_step`` on an Auto-axes 1 x 1 JAX
  mesh (the same function) against the port's (1, 2) step from the same
  converted init, for danube, gemma3-1b (its KV head cut inside, qk-norm,
  tied vocab-parallel head) and qwen2-vl-7b (its gathered front end): ``tests/test_torch_fsdp.py``'s gates (loss and grad
  norm 1e-3, m and moves >= 30 dB, parameters within twice the update).
- Collectives: the counts and bytes on each axis are those the leaves'
  shapes and specs and the layers' shapes give, with the ring model's
  wire bytes over that axis's group size.
- ``sharding.owns`` counts a block replicated over ``model`` on model
  coordinate 0 only, and ``adamw.global_norm`` over the ranks' owned
  blocks is the whole tree's norm.
- Families and layouts the model axis does not cover raise
  ``NotImplementedError`` naming ``ROADMAP.md``; ``--mesh single`` in a
  group of 4 raises the ``ValueError`` that names its 256 ranks.
- Checkpoints: saved at (2, 2), restored at (4, 1), (1, 4) and on one
  rank, the global arrays bitwise; a (1, 2) ``Trainer`` killed and
  restarted is bitwise the uninterrupted one.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import torch_dist  # noqa: E402
import torch_fsdp_ranks as F  # noqa: E402
import torch_tp_ranks as R  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.mesh import axis_members  # noqa: E402
from repro_torch.distributed.roofline import ring_wire_bytes  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.layers.common import (  # noqa: E402
    embed_apply,
    quantize_weights_tree,
)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_fsdp import _ref_batch  # noqa: E402
from test_torch_train import _NO_EXCESS, _np, _paths, _sqnr_db  # noqa: E402

MESHES = ((1, 2), (2, 2), (1, 4))
MIN_DB = 40.0


def _jcfg(arch: str):
    return jconfigs.tiny(jconfigs.ARCHS[arch])


def _ref_rows(arch: str) -> dict:
    """``_ref_batch``'s rows, with the vision front end's embeddings for
    a vlm config."""
    rows = _ref_batch()
    cfg = R.config(arch)
    if cfg.frontend != "none":
        shp = tuple(C.concrete_inputs(cfg, R.SHAPE, device="cpu")
                    ["vis_emb"].shape)
        rows["vis_emb"] = np.random.default_rng(4).standard_normal(
            shp).astype(np.float32)
    return rows


@pytest.fixture(scope="module")
def ref_init():
    return {arch: jlm.init_model(jax.random.PRNGKey(5), _jcfg(arch))[0]
            for arch in R.REF_ARCHS}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, ref_init):
    tmp = tmp_path_factory.mktemp("tp2")
    ref = {arch: (from_reference(_np(init), device="cpu"), _ref_rows(arch))
           for arch, init in ref_init.items()}
    return torch_dist.spawn(R.world2, 2, tmp, str(tmp), ref)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp4")
    return torch_dist.spawn(R.world4, 4, tmp, str(tmp),
                            str(tmp_path_factory.mktemp("tp1") / "store"))[0]


_ONE: dict = {}


def one_device(arch: str, k: int) -> dict:
    """The one-device step (seed 0's init, the bundles' global batch) of
    the tiny ``arch`` with k microbatches, once per (arch, k)."""
    if (arch, k) not in _ONE:
        cfg = R.config(arch)
        params, _ = steps.param_structs(cfg, device="cpu")
        b = steps.make_train_step(cfg, R.SHAPE, F.opt(**R.ADAM),
                                  microbatches=k, device="cpu",
                                  dense_attn_max=R.DENSE)
        rows = C.concrete_inputs(cfg, R.SHAPE, device="cpu")
        before = [t.detach().clone() for t in adamw.leaves(params)]
        p, s, met = b.fn(params, adamw.init(params), rows)
        _ONE[arch, k] = {"params": [t.detach() for t in adamw.leaves(p)],
                         "m": adamw.leaves(s.m), "v": adamw.leaves(s.v),
                         "met": met, "before": before}
    return _ONE[arch, k]


def _got(world2, world4, arch: str, mesh: tuple) -> dict:
    if mesh == (1, 2):
        return world2[0]["steps"][arch]
    return world4["22" if mesh == (2, 2) else "14"][arch]


# ------------------------------------------------------- the train step

@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", R.ARCHS)
def test_step_against_one_device(world2, world4, arch, mesh):
    want, got = one_device(arch, mesh[0]), _got(world2, world4, arch, mesh)
    for name in ("loss", "grad_norm"):
        assert float(got["met"][name]) == pytest.approx(
            float(want["met"][name]), rel=1e-3), name
    paths = [p for p, _ in _paths(steps.param_structs(
        R.config(arch), device="meta")[0])]
    assert len(paths) == len(want["m"]) == len(got["m"])
    for path, a, b in zip(paths, want["m"], got["m"]):
        assert _sqnr_db(a.numpy(), b.numpy()) >= MIN_DB, path
    for path, a, b, p0 in zip(paths, want["params"], got["params"],
                              want["before"]):
        upd = float((a - p0).abs().max())
        torch.testing.assert_close(b, a, rtol=0, atol=2 * upd + 1e-7,
                                   msg=path)
        assert _sqnr_db((a - p0).numpy(), (b - p0).numpy()) >= MIN_DB, path


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "gemma3-1b"))
def test_group_of_one_bitwise_one_device(world4, arch):
    want, got = one_device(arch, 1), world4["11"][arch]
    for name in ("params", "m", "v"):
        for i, (a, b) in enumerate(zip(want[name], got[name])):
            assert torch.equal(a, b), (name, i)
    assert torch.equal(want["met"]["loss"], got["met"]["loss"])


def _tp_mesh(data: int, model: int, rank: int = 0) -> Mesh:
    return Mesh(("data", "model"), (data, model),
                (torch.device("meta"),) * (data * model), rank=rank)


def _specs(cfg, mesh) -> tuple[list, list, list]:
    """(leaves on ``meta``, parameter specs, moment specs) on ``mesh``."""
    params, specs = steps.param_structs(cfg, device="meta")
    rules = shd.zero_rules(shd.make_rules(cfg, mesh, "train"), mesh)
    pctx = shd.ShardingCtx(mesh=mesh, rules=steps.param_rules(rules, mesh))
    p = shd.spec_leaves(params, shd.resolve_with_divisibility(
        specs, params, pctx, mesh))
    m = shd.spec_leaves(params, shd.resolve_with_divisibility(
        shd.opt_state_specs(specs), params, pctx, mesh))
    return adamw.leaves(params), p, m


@pytest.mark.parametrize("d_ff", (96, 128))
def test_quantized_shards_bitwise(world2, d_ff):
    cfg = R.config("h2o-danube-1.8b", d_ff)
    params, _ = steps.param_structs(cfg, device="cpu")
    whole = adamw.leaves(quantize_weights_tree(
        params, lm.ref_ndim_tree(cfg, params)))
    _, p_specs, _ = _specs(cfg, _tp_mesh(1, 2))
    w2 = [i for i, (path, _) in enumerate(_paths(params))
          if path.endswith("ffn/w2/w")]
    for rank in (0, 1):
        got = world2[rank]["quant"][d_ff]
        assert len(got) == len(whole)
        for i, (a, b, s) in enumerate(zip(whole, got, p_specs)):
            assert torch.equal(shd.take_shard(a, s, _tp_mesh(1, 2, rank)),
                               b), i
        # the K shard of w2: 48 rows (gathered branch) or 64 (local)
        assert {tuple(got[i].shape) for i in w2} == {(d_ff // 2, 64)}
        assert all(got[i].dtype == torch.bfloat16 for i in w2)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_model_replicated_grads_bitwise_across_ranks(world2, arch):
    g0, g1 = world2[0]["grads"][arch], world2[1]["grads"][arch]
    rep = [i for i, s in enumerate(g0["specs"]) if shd.model_dim(s) is None]
    assert rep and g0["specs"] == g1["specs"]
    for i in rep:
        assert torch.equal(g0["grads"][i], g1["grads"][i]), i
        assert float(g0["grads"][i].abs().max()) > 0, i


def test_vocab_parallel_embedding_bitwise(world2):
    cfg = R.config("h2o-danube-1.8b")
    params, _ = steps.param_structs(cfg, device="cpu")
    ids = C.concrete_inputs(cfg, R.SHAPE, device="cpu")["ids"]
    want = embed_apply(params["embed"], ids)
    for rank in (0, 1):
        assert torch.equal(world2[rank]["embed"], want)


@pytest.mark.parametrize("arch", R.REF_ARCHS)
def test_reference_builder_on_auto_mesh(world2, ref_init, arch):
    got = world2[0]["reference"][arch]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    shape = jconfigs.Shape(R.SHAPE.seq, R.SHAPE.batch, "train")
    b = jsteps.make_train_step(_jcfg(arch), mesh, shape,
                               jadamw.AdamWConfig(**R.ADAM),
                               quant="mxfp4_ste")
    fn = b.fn.lower(*b.args).compile(compiler_options=_NO_EXCESS)
    init = ref_init[arch]
    before = dict(_paths(from_reference(_np(init), device="cpu")))
    jp, js, jmet = fn(init, jadamw.init(init), _ref_rows(arch))
    for name in ("loss", "grad_norm"):
        assert float(got["met"][name]) == pytest.approx(float(jmet[name]),
                                                        rel=1e-3), name
    assert float(got["met"]["lr"]) == float(jmet["lr"])
    paths = [p for p, _ in _paths(steps.param_structs(
        R.config(arch), device="meta")[0])]
    want_m = dict(_paths(from_reference(_np(js.m), device="cpu")))
    want_p = dict(_paths(from_reference(_np(jp), device="cpu")))
    for path, m, p in zip(paths, got["m"], got["params"]):
        assert _sqnr_db(want_m[path].numpy(), m.numpy()) >= 30.0, path
        move = want_p[path] - before[path]
        np.testing.assert_allclose(p.numpy(), want_p[path].numpy(), rtol=0,
                                   atol=2 * float(move.abs().max()) + 1e-7,
                                   err_msg=path)
        assert _sqnr_db(move.numpy(), (p - before[path]).numpy()) >= 30.0, \
            path


# ------------------------------------------------- layouts, collectives

def _ring(kind: str, sizes: list, n: int) -> list:
    return [len(sizes), sum(ring_wire_bytes(kind, b, n) for b in sizes),
            float(sum(sizes))]


def _model_collectives(cfg, data: int, model: int) -> dict:
    """The model axis's collectives of one k = 1 step at [4, 32]: per
    layer the f32 sums after ``wo`` and ``w2`` (forward) and of each
    column-parallel linear's input gradient (backward); the embedding's
    sum; a max and a (sum of exps, gold) sum a loss chunk and the head's
    input gradient; a K shard of a row-parallel linear that is not a
    whole number of 32-blocks gathers its activations (each microbatch)
    and its weight (each step); a KV head cut inside gathers k and v
    (bf16) and sums their f32 gradients; the qk-norm gammas' sums."""
    rows, s, d, hd = R.SHAPE.batch // data, R.SHAPE.seq, cfg.d_model, cfg.hd
    act = rows * s * d * 4
    sums, gathers = [act], []
    glu = cfg.ffn_kind in ("swiglu", "geglu")
    kv_local = cfg.n_kv_heads % model == 0
    for _ in range(cfg.n_layers):
        sums += [act] * (2 + 3 + 1 + glu)
        if not kv_local:
            gathers += [rows * s * cfg.n_kv_heads * hd * 2] * 2
            sums += [rows * s * cfg.n_kv_heads * hd * 4] * 2
        if cfg.qk_norm:
            sums += [hd * 4] * (1 + kv_local)
        for k in (cfg.n_heads * hd, cfg.d_ff):
            if (k // model) % 32:
                gathers.append(rows * s * k * 4)
                if k % 32 == 0:
                    gathers.append(k * d * 4)
    sums += [rows * s * 4, 2 * rows * s * 4, act]  # one chunk of 32
    return {"all-reduce": _ring("all-reduce", sums, model),
            "all-gather": _ring("all-gather", gathers, model)}


def _data_collectives(cfg, data: int, model: int) -> dict:
    """The data axes' collectives: the FSDP gathers and ZeRO-1 scatters of
    each leaf's model shard, the all-reduces of the moments whose leaves
    no data axis cuts, the mask count and the loss."""
    mesh = _tp_mesh(data, model)
    leaves, p, m = _specs(cfg, mesh)

    def cut(spec):
        return any(a in ("pod", "data") for e in spec
                   for a in shd.dim_axes(e))

    def nbytes(t, s):
        return math.prod(shd.model_shard_shape(s, t.shape, mesh)) * 4

    gathers = [nbytes(t, s) for t, s in zip(leaves, p) if cut(s)]
    scatters = [nbytes(t, s) // data for t, s in zip(leaves, m) if cut(s)]
    reduces = [nbytes(t, s) for t, s in zip(leaves, m) if not cut(s)]
    return {"all-gather": _ring("all-gather", gathers, data),
            "reduce-scatter": _ring("reduce-scatter", scatters, data),
            "all-reduce": _ring("all-reduce", reduces + [4, 4], data)}


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "gemma3-1b"))
def test_collectives_by_axis(world2, world4, arch):
    cfg = R.config(arch)
    for (data, model), got in (((1, 2), world2[0]["steps"][arch]),
                               ((1, 4), world4["14"][arch])):
        coll = got["collectives"]
        assert set(coll) == {"data", "model", "world"}
        assert coll["model"] == _model_collectives(cfg, data, model), model
        assert coll["data"] == _data_collectives(cfg, data, model), model
        assert coll["world"] == {"all-reduce": _ring("all-reduce", [4],
                                                     data * model)}


def test_owns_and_global_norm_on_2x2():
    """A block replicated over ``model`` (a norm gamma, FSDP over data)
    counts on model coordinate 0 only, one replicated over the data axes
    (a column bias) on data coordinate 0 only; the ranks' owned sums of
    squares add up to the whole tree's."""
    ranks = [_tp_mesh(2, 2, r) for r in range(4)]
    assert [shd.owns(("data",), m) for m in ranks] == [True, False, True,
                                                       False]
    assert [shd.owns(("model",), m) for m in ranks] == [True, True, False,
                                                        False]
    assert all(shd.owns(("data", "model"), m) for m in ranks)
    assert [shd.owns((None,), m) for m in ranks] == [True, False, False,
                                                     False]
    gen = torch.Generator().manual_seed(0)
    tree = {"gamma": torch.randn(8, generator=gen),
            "w": torch.randn(8, 6, generator=gen),
            "b": torch.randn(6, generator=gen),
            "s": torch.randn(3, generator=gen)}
    specs = [("data",), ("data", "model"), ("model",), (None,)]
    total = 0.0
    for mesh in ranks:
        blocks = [shd.take_shard(t, s, mesh)
                  for t, s in zip(tree.values(), specs)]
        owned = [shd.owns(s, mesh) for s in specs]
        total += float(adamw.global_norm(blocks, owned)) ** 2
    assert total == pytest.approx(float(adamw.global_norm(tree)) ** 2,
                                  rel=1e-6)


def test_mesh_subgroups():
    two = _tp_mesh(2, 2)
    assert [axis_members(two, "data", r) for r in range(4)] == [
        (0, 2), (1, 3), (0, 2), (1, 3)]
    assert [axis_members(two, "model", r) for r in range(4)] == [
        (0, 1), (0, 1), (2, 3), (2, 3)]
    pod = Mesh(("pod", "data", "model"), (2, 2, 2))
    assert axis_members(pod, "data", 5) == (1, 3, 5, 7)
    assert axis_members(pod, "model", 5) == (4, 5)


_OUT_OF_SCOPE = {
    "moe-ep": ("mixtral-8x22b", (1, 2)),
    "moe-tp": ("qwen3-moe-235b-a22b", (1, 2)),
    "hybrid": ("zamba2-1.2b", (1, 2)),
    "ssm": ("xlstm-125m", (1, 2)),
    "audio": ("hubert-xlarge", (1, 2)),
    "heads-not-divisible": ("h2o-danube-1.8b", (1, 3)),
}


@pytest.mark.parametrize("case", sorted(_OUT_OF_SCOPE))
def test_uncovered_layouts_raise(case):
    arch, (data, model) = _OUT_OF_SCOPE[case]
    mesh = Mesh(("data", "model"), (data, model),
                (torch.device("cpu"),) * (data * model), rank=0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.make_train_step(R.config(arch), mesh, R.SHAPE, device="cpu")


def test_unsupported_backend_raises():
    mesh = Mesh(("data", "model"), (1, 2), (torch.device("cpu"),) * 2,
                rank=0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.make_train_step(R.config("h2o-danube-1.8b"), mesh, R.SHAPE,
                              quant="cim", device="cpu")


def test_launcher_pod_mesh_names_its_ranks(world4):
    assert "256 ranks" in world4["launcher"]


# ------------------------------------------------ checkpoints, trainer

def test_reshard_on_load_across_layouts(world4):
    saved = world4["22"]["h2o-danube-1.8b"]
    for key in ("restore41", "restore14", "restore1"):
        for name in ("params", "m", "v"):
            assert len(saved[name]) == len(world4[key][name])
            for a, b in zip(saved[name], world4[key][name]):
                assert torch.equal(a, b), (key, name)


def test_trainer_kill_restart_1x2(world2):
    out = world2[0]
    assert out["trainer_full"] == 4 and out["trainer_start"] == 2
    full, resumed = out["kill_restart"]
    for name in ("params", "m", "v"):
        for a, b in zip(full[name], resumed[name]):
            assert torch.equal(a, b), name
