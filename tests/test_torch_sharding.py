"""The port's sharding rules, meshes, parameter specs and per-device
argument bytes against the JAX reference, exactly, on the CPU.

The reference's meshes are ``jax.sharding.AbstractMesh``es (no devices);
the port's are ``launch.mesh.Mesh``es of the same axes and sizes: 1x1,
the single pod 16x16 and the two pods 2x16x16.

- ``make_rules`` for every arch x mode (train; prefill; decode at batch 1
  and 128) x mesh.
- ``ShardingCtx.resolve`` and ``resolve_with_divisibility`` (axis reuse,
  a dropped axis that does not divide, tuple rules) as the reference's
  ``PartitionSpec``s, entry for entry.
- ``opt_state_specs``, ``zero_rules`` and ``param_rules``.
- ``lm.param_specs`` (plain and serve-quantized) equals the reference's
  ``param_structs`` spec tree with its stacked ``layers`` axis taken off,
  one spec a layer, for all ten LM archs.
- The dry-run's per-device ``argument_bytes`` (``launch.steps.args_bytes``
  over ``make_step``'s arguments on ``meta``) of every cell of
  ``all_cells()`` on both production meshes equals the sum of
  ``NamedSharding.shard_shape`` bytes over the reference's (params, opt
  state, batch) or (params, caches, ids, pos) trees.
- ``applicable_shapes``, ``all_cells``, ``skipped_cells`` and
  ``input_specs``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.layers import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

LM_ARCHS = sorted(jconfigs.ARCHS)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = [("train", None), ("prefill", None), ("decode", 1),
         ("decode", 128)]


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), tmesh.Mesh(axes, sizes)


def _tuple(spec) -> tuple:
    return tuple(P() if spec is None else spec)


@pytest.fixture(scope="module")
def ref_structs():
    """The reference's (params struct, specs) per arch, plain and
    serve-quantized (``jax.eval_shape``: nothing allocated)."""
    return {(a, q): jsteps.param_structs(jconfigs.ARCHS[a], serve_quant=q)
            for a in LM_ARCHS for q in (False, True)}


def test_production_meshes_match_reference():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.size, single.name) == (
        ("data", "model"), {"data": 16, "model": 16}, 256, "16x16")
    assert (multi.axis_names, multi.shape, multi.size, multi.name) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, 512,
        "2x16x16")
    assert not single.devices and not multi.devices
    local = tmesh.make_local_mesh(1, 2, device="cpu")
    assert local.shape == {"data": 1, "model": 2}
    assert local.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="devices"):
        tmesh.Mesh(("data",), (2,), (torch.device("cpu"),))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_make_rules_match_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    for arch in LM_ARCHS:
        jc, tc = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
        for mode, bs in MODES:
            want = jshd.make_rules(jc, jm, mode, batch_size=bs)
            got = tshd.make_rules(tc, tm, mode, batch_size=bs)
            assert got == want, (arch, mode, bs)
            assert (tshd.zero_rules(got, tm)
                    == jshd.zero_rules(want, jm)), (arch, mode)
            assert (tshd.zero_rules(got, tm, enabled=False)
                    == jshd.zero_rules(want, jm, enabled=False))
            for fsdp in (True, False):
                assert (tsteps.param_rules(got, tm, fsdp)
                        == jsteps.param_rules(want, jm, fsdp))
    assert tcommon.DEFAULT_RULES == jcommon.DEFAULT_RULES


# logical specs that exercise axis reuse (batch twice, the second and a
# later model axis dropped), tuple rules, None, a name with no rule and
# a rule naming an axis the mesh lacks (pod on the single pod)
SPECS = [("batch", "seq", "embed"), ("batch", "batch"), ("vocab", "embed"),
         ("embed", "mlp"), ("mlp", "heads", "kv_heads"), (None, "mlp"),
         ("exp_group", "experts", "expert_mlp"), ("zero", "mlp"),
         ("cache_seq", "kv_seq"), ("unknown", "batch"), ()]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_resolve_matches_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    for arch in ("h2o-danube-1.8b", "gemma3-1b", "qwen3-moe-235b-a22b"):
        for mode, bs in MODES:
            jr = jshd.zero_rules(jshd.make_rules(
                jconfigs.ARCHS[arch], jm, mode, batch_size=bs), jm)
            jr = jsteps.param_rules(jr, jm, True)
            tr = tsteps.param_rules(tshd.zero_rules(tshd.make_rules(
                tconfigs.ARCHS[arch], tm, mode, batch_size=bs), tm), tm)
            jctx = jcommon.ShardingCtx(mesh=jm, rules=jr)
            tctx = tcommon.ShardingCtx(mesh=tm, rules=tr)
            for spec in SPECS:
                assert tctx.resolve(spec) == _tuple(jctx.resolve(spec)), (
                    arch, mode, spec)
    for spec in SPECS:  # no mesh: tuple rules drop, names stay
        assert tcommon.ShardingCtx().resolve(spec) == _tuple(
            jcommon.ShardingCtx().resolve(spec))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_resolve_with_divisibility_matches_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    jr = jsteps.param_rules(jshd.zero_rules(jshd.make_rules(
        jconfigs.ARCHS["starcoder2-7b"], jm, "train"), jm), jm)
    tr = tsteps.param_rules(tshd.zero_rules(tshd.make_rules(
        tconfigs.ARCHS["starcoder2-7b"], tm, "train"), tm), tm)
    jctx = jcommon.ShardingCtx(mesh=jm, rules=jr)
    tctx = tcommon.ShardingCtx(mesh=tm, rules=tr)
    # 48 divides by 16 but not by 32 (pod x data): the tuple rule keeps
    # what divides; 49 divides by nothing; 2 by the pod axis only
    shapes = [(48, 4608), (49, 4608), (512, 7), (2, 16, 3), (32, 32),
              (2, 18432), (4608,), ()]
    specs = [("embed", "mlp"), ("embed", "mlp"), ("batch", "vocab"),
             ("batch", "heads", "zero"), ("zero", "zero"), ("batch", "mlp"),
             ("embed",), ()]
    for shape, spec in zip(shapes, specs):
        want = jshd.resolve_with_divisibility(
            spec, jax.ShapeDtypeStruct(shape, jnp.float32), jctx, jm)
        got = tshd.resolve_with_divisibility(
            spec, torch.empty(shape, device="meta"), tctx, tm)
        assert got == _tuple(want.spec), (shape, spec)
        assert tshd.shard_shape(got, shape, tm) == want.shard_shape(shape)


def _unstacked(cfg, ref_specs):
    """The reference's spec tree laid out as the port's: a stacked
    segment's spec (leading ``layers``) taken off and repeated a layer;
    a ``zshared`` visit one empty dict."""
    out = {k: v for k, v in ref_specs.items() if k != "segments"}
    out["segments"] = []
    for seg, s in zip(tlm.build_segments(cfg), ref_specs["segments"]):
        if seg.kind == "zshared":
            out["segments"].append([{}])
            continue
        if seg.n > 1:
            def strip(sp):
                assert sp[0] == "layers"
                return sp[1:]
            s = jax.tree.map(strip, s, is_leaf=tcommon.spec_leaf)
        out["segments"].append([s] * seg.n)
    return out


@pytest.mark.parametrize("serve_quant", [False, True])
def test_param_specs_match_reference(ref_structs, serve_quant):
    for arch in LM_ARCHS:
        tc = tconfigs.ARCHS[arch]
        _, want = ref_structs[(arch, serve_quant)]
        params, got = tsteps.param_structs(tc, serve_quant=serve_quant)
        assert got == _unstacked(tc, want), arch
        # each spec names one axis a dim of its leaf
        tshd.resolve_tree(got, tcommon.ShardingCtx())
        flat_p = jax.tree.leaves(params)
        flat_s = jax.tree.leaves(got, is_leaf=tcommon.spec_leaf)
        assert len(flat_p) == len(flat_s), arch
        for t, s in zip(flat_p, flat_s):
            assert t.is_meta and t.ndim == len(s), (arch, t.shape, s)


def test_opt_state_specs_match_reference(ref_structs):
    for arch in ("h2o-danube-1.8b", "gemma3-1b", "mixtral-8x22b",
                 "zamba2-1.2b", "xlstm-125m"):
        _, jspecs = ref_structs[(arch, False)]
        tspecs = tlm.param_specs(tconfigs.ARCHS[arch])
        for zero1 in (True, False):
            want = _unstacked(tconfigs.ARCHS[arch], jshd.opt_state_specs(
                jspecs, None, None, zero1=zero1))
            assert tshd.opt_state_specs(tspecs, zero1=zero1) == want


def test_cells_and_input_specs_match_reference():
    for arch in LM_ARCHS:
        assert (tconfigs.applicable_shapes(tconfigs.ARCHS[arch])
                == jconfigs.applicable_shapes(jconfigs.ARCHS[arch]))
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert tconfigs.skipped_cells() == jconfigs.skipped_cells()
    for arch in LM_ARCHS:
        for name in tconfigs.SHAPES:
            want = jconfigs.input_specs(jconfigs.ARCHS[arch], name)
            got = tconfigs.input_specs(tconfigs.ARCHS[arch], name)
            assert list(got) == list(want), (arch, name)
            for k, v in want.items():
                assert got[k].is_meta and tuple(got[k].shape) == v.shape
                assert got[k].dtype == getattr(torch, np.dtype(v.dtype).name)
    inputs = tconfigs.concrete_inputs(tconfigs.ARCHS["qwen2-vl-7b"],
                                      tconfigs.Shape(8, 2, "train"),
                                      device="cpu")
    assert set(inputs) == {"ids", "vis_emb", "labels", "loss_mask"}
    assert int(inputs["ids"].max()) < 152064 and bool(
        (inputs["loss_mask"] == 1).all())


def _ns_bytes(shardings, structs) -> int:
    """Per-device bytes of ``structs`` under the reference's NamedSharding
    tree."""
    total = 0
    for ns, st in zip(jax.tree.leaves(shardings), jax.tree.leaves(structs)):
        total += math.prod(ns.shard_shape(st.shape)) * np.dtype(
            st.dtype).itemsize
    return total


def _ref_arg_bytes(cfg, shape, mesh, structs) -> int:
    """The reference's per-device argument bytes of a cell: its step
    builders' argument trees and shardings, rebuilt without the jit."""
    if shape.kind == "train":
        rules = jshd.zero_rules(jshd.make_rules(cfg, mesh, "train"), mesh)
        ctx = jcommon.ShardingCtx(mesh=mesh, rules=rules)
        pctx = jcommon.ShardingCtx(mesh=mesh,
                                   rules=jsteps.param_rules(rules, mesh))
        pstruct, specs = structs[(cfg.name, False)]
        bstruct = jconfigs.input_specs(cfg, shape)
        p_shard = jshd.resolve_with_divisibility(specs, pstruct, pctx, mesh)
        m_shard = jshd.resolve_with_divisibility(
            jshd.opt_state_specs(specs, cfg, mesh), pstruct, pctx, mesh)
        ostruct = jax.eval_shape(jadamw.init, pstruct)
        return (_ns_bytes(p_shard, pstruct) + 2 * _ns_bytes(m_shard, pstruct)
                + np.dtype(ostruct.step.dtype).itemsize
                + _ns_bytes(jsteps.batch_shardings(bstruct, mesh, ctx),
                            bstruct))
    pstruct, specs = structs[(cfg.name, True)]
    if shape.kind == "prefill":
        ctx = jshd.make_ctx(cfg, mesh, "prefill")
        bstruct = jconfigs.input_specs(cfg, shape)
        return (_ns_bytes(jshd.resolve_with_divisibility(
            specs, pstruct, ctx, mesh), pstruct)
            + _ns_bytes(jsteps.batch_shardings(bstruct, mesh, ctx), bstruct))
    ctx = jshd.make_ctx(cfg, mesh, "decode", batch_size=shape.batch)
    cstruct = jax.eval_shape(
        lambda: jlm.init_cache(cfg, shape.batch, shape.seq))
    inp = jconfigs.input_specs(cfg, shape)
    c_shard = jshd.resolve_with_divisibility(jlm.cache_specs(cfg), cstruct,
                                             ctx, mesh)
    ids = jshd.resolve_with_divisibility(("batch", "seq"), inp["ids"], ctx,
                                         mesh)
    return (_ns_bytes(jshd.resolve_with_divisibility(specs, pstruct, ctx,
                                                     mesh), pstruct)
            + _ns_bytes(c_shard, cstruct) + _ns_bytes(ids, inp["ids"])
            + np.dtype(inp["pos"].dtype).itemsize)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_argument_bytes_match_reference(ref_structs, multi_pod):
    name = "2x16x16" if multi_pod else "16x16"
    jm, tm = _meshes(name)
    assert tmesh.make_production_mesh(multi_pod=multi_pod) == tm
    for arch, shape_name in tconfigs.all_cells():
        shape = tconfigs.SHAPES[shape_name]
        bundle = tsteps.make_step(tconfigs.ARCHS[arch], tm, shape,
                                  device="meta")
        got = tsteps.args_bytes(bundle.args, bundle.shardings, tm)
        want = _ref_arg_bytes(jconfigs.ARCHS[arch], shape, jm, ref_structs)
        assert got == want, (arch, shape_name, name)
