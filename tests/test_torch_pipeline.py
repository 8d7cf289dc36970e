"""The port's stage-parallel FWS pipeline
(``repro_torch.distributed.pipeline_exec``) on the CPU, held to the
port's one-device forward and to the JAX reference.

The reference initialises the tiny models (starcoder2-7b at 4 layers,
ViT-B/16 at 4 layers, the shapes of ``tests/test_pipeline_exec.py``);
their trees cross into the port through ``convert.from_reference`` and
the inputs come from a numpy seed. Grids repeat the CPU device
(``make_pipeline_mesh(devices=[cpu] * n)``), the port's counterpart of
the reference's forced host device count.

- Against the port's forward: S in {1, 2, 4} stages, microbatch grids
  (1, 3), (2, 2), (3, 1): bitwise in float; bitwise or > 60 dB under
  ``mxfp4`` and ``cim`` (the reference's own bounds).
- Against the reference's pipeline at one stage (the only stage count its
  tier-1 run sees): logits >= 30 dB, the bound ``tests/test_torch_lm.py``
  holds ``lm.forward`` to.
- The pure-Python copies (``serve_layer_costs``, ``active_params``,
  ``model_flops``) equal the reference's; the transfer guard, the replica
  router, the errors, the launcher's flags and gauges and the vision
  engine's pipelined stream.
"""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import blockwise as jblockwise  # noqa: E402
from repro.distributed import pipeline_exec as jpex  # noqa: E402
from repro.distributed import roofline as jroofline  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.layers.common import RunCtx as JCtx, ShardingCtx  # noqa: E402
from repro.layers.common import (  # noqa: E402
    convert_params_mxfp4 as jconvert_mxfp4,
)
from repro.models import lm as jlm  # noqa: E402
from repro.models import vit as jvit  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.distributed import blockwise, roofline  # noqa: E402
from repro_torch.distributed import pipeline_exec as pex  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers.common import RunCtx, convert_params_mxfp4  # noqa: E402
from repro_torch.models import calibrate, lm, vit  # noqa: E402
from repro_torch.obs import MetricsRegistry, Obs  # noqa: E402
from repro_torch.serving import VisionEngine  # noqa: E402

CPU = torch.device("cpu")
CTX = RunCtx(dense_attn_max=256)
B, S = 3, 16
GRIDS = [(1, 3), (2, 2), (3, 1)]  # (microbatches, mb_size): the reference's
STAGES = [1, 2, 4]
rng = np.random.default_rng(0)
IDS = rng.integers(0, 128, (B, S))
IMGS = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)


def _sqnr_db(ref, got) -> float:
    ref = np.asarray(torch.as_tensor(ref).float(), np.float64)
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _mesh(stages, replicas=1):
    return pex.make_pipeline_mesh(stages, replicas,
                                  devices=[CPU] * (stages * replicas))


def _same_or_60db(ref, got) -> bool:
    return torch.equal(ref, got) or _sqnr_db(ref, got) > 60.0


@pytest.fixture(scope="module")
def lm_setup():
    jcfg = dataclasses.replace(jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"]),
                               n_layers=4)
    cfg = dataclasses.replace(C.tiny(C.STARCODER2_7B), n_layers=4)
    jparams, _ = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    assert IDS.max() < cfg.vocab_size
    return jcfg, jparams, cfg, params, {"ids": torch.from_numpy(IDS)}


@pytest.fixture(scope="module")
def vit_setup():
    jcfg = dataclasses.replace(jconfigs.tiny_vit(
        jconfigs.VISION_ARCHS["vit-b16"]), n_layers=4)
    cfg = dataclasses.replace(C.tiny_vit(C.VIT_B16), n_layers=4)
    jparams, _ = jvit.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params, {"images": torch.from_numpy(IMGS)}


@pytest.fixture(scope="module")
def lm_cim(lm_setup):
    """The port's own Row-Hist calibration and CIM conversion of the tiny
    LM (two seeded token batches)."""
    _, _, cfg, params, _ = lm_setup
    cim_cfg = tcim.CIMConfig()
    gen = torch.Generator().manual_seed(7)
    batches = [{"ids": torch.randint(0, cfg.vocab_size, (2, S),
                                     generator=gen)} for _ in range(2)]
    conv, _ = calibrate.convert_model_cim(params, cfg, CTX, batches,
                                          cim_cfg=cim_cfg, min_n=32)
    return conv, dataclasses.replace(CTX, quant="cim", cim=cim_cfg)


# ------------------------------------------- against the port's forward

@pytest.mark.parametrize("stages", STAGES)
@pytest.mark.parametrize("microbatches,mb_size", GRIDS)
def test_lm_pipeline_float_bitwise(lm_setup, stages, microbatches, mb_size):
    _, _, cfg, params, batch = lm_setup
    ref, _ = lm.forward(params, cfg, CTX, batch)
    out, runner = lm.forward_pipelined(
        params, cfg, CTX, batch, stages=stages, microbatches=microbatches,
        mb_size=mb_size, mesh=_mesh(stages))
    assert runner.bounds == [tuple(b) for b in
                             pex.stage_partition(cfg.n_layers, stages)]
    assert out.shape == ref.shape
    assert torch.equal(out, ref), f"sqnr {_sqnr_db(ref, out)} dB"


@pytest.mark.parametrize("stages", STAGES)
def test_lm_pipeline_mxfp4(lm_setup, stages):
    _, _, cfg, params, batch = lm_setup
    qparams = convert_params_mxfp4(params, min_n=32)
    qctx = dataclasses.replace(CTX, quant="mxfp4_wonly")
    ref, _ = lm.forward(qparams, cfg, qctx, batch)
    out, _ = lm.forward_pipelined(qparams, cfg, qctx, batch, stages=stages,
                                  microbatches=2, mb_size=2,
                                  mesh=_mesh(stages))
    assert _same_or_60db(ref, out)


@pytest.mark.parametrize("stages", STAGES)
def test_lm_pipeline_cim(lm_setup, lm_cim, stages):
    _, _, cfg, _, batch = lm_setup
    conv, cctx = lm_cim
    ref, _ = lm.forward(conv, cfg, cctx, batch)
    out, _ = lm.forward_pipelined(conv, cfg, cctx, batch, stages=stages,
                                  microbatches=2, mb_size=2,
                                  mesh=_mesh(stages))
    assert _same_or_60db(ref, out)


@pytest.mark.parametrize("stages", STAGES)
@pytest.mark.parametrize("microbatches,mb_size", GRIDS)
def test_vit_pipeline_float_bitwise(vit_setup, stages, microbatches,
                                    mb_size):
    _, _, cfg, params, batch = vit_setup
    ref, _ = vit.forward(params, cfg, CTX, batch)
    out, runner = vit.forward_pipelined(
        params, cfg, CTX, batch, stages=stages, microbatches=microbatches,
        mb_size=mb_size, mesh=_mesh(stages))
    assert runner.n_stages == stages and out.shape == ref.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("stages", STAGES)
def test_vit_pipeline_mxfp4(vit_setup, stages):
    _, _, cfg, params, batch = vit_setup
    qparams = convert_params_mxfp4(params, min_n=32)
    qctx = dataclasses.replace(CTX, quant="mxfp4_wonly")
    ref, _ = vit.forward(qparams, cfg, qctx, batch)
    out, _ = vit.forward_pipelined(qparams, cfg, qctx, batch, stages=stages,
                                   microbatches=2, mb_size=2,
                                   mesh=_mesh(stages))
    assert _same_or_60db(ref, out)


def test_balanced_cuts_parity(lm_setup):
    """Imbalanced synthetic costs force unequal cuts (1 + 3 layers): no
    padding or mask, and the logits stay bitwise."""
    _, _, cfg, params, batch = lm_setup
    ref, _ = lm.forward(params, cfg, CTX, batch)
    runner = pex.build_lm_pipeline(
        params, cfg, CTX, stages=2, microbatches=2, mb_size=2,
        mode="balanced", costs=[10.0, 1.0, 1.0, 1.0], mesh=_mesh(2))
    assert runner.bounds == [(0, 1), (1, 4)]
    assert runner.lengths == [1, 3]
    assert torch.equal(runner.forward(batch), ref)


def test_stage_paths_are_the_forward_paths(lm_setup):
    """Each stage keeps the whole segment's capture paths, so a tap (the
    calibration capture) records the same paths through the pipeline as
    through ``lm.forward``."""
    _, _, cfg, params, batch = lm_setup
    runner = pex.build_lm_pipeline(params, cfg, CTX, stages=4, mesh=_mesh(4))
    assert runner._paths == [[f"segments/0/L{j}"] for j in range(4)]


# ----------------------------------------------- against the reference

@pytest.mark.parametrize("backend", ["float", "mxfp4"])
def test_lm_pipeline_matches_reference_pipeline(lm_setup, backend):
    jcfg, jparams, cfg, params, batch = lm_setup
    jctx = JCtx(shd=ShardingCtx(), dense_attn_max=256)
    if backend == "mxfp4":
        jparams = jconvert_mxfp4(jparams, min_n=32)
        params = convert_params_mxfp4(params, min_n=32)
        jctx = dataclasses.replace(jctx, quant="mxfp4_wonly")
    ctx = dataclasses.replace(CTX, quant=jctx.quant)
    ref = jpex.build_lm_pipeline(jparams, jcfg, jctx, stages=1,
                                 microbatches=2, mb_size=2).forward(
        {"ids": jax.numpy.asarray(IDS)})
    got, _ = lm.forward_pipelined(params, cfg, ctx, batch, stages=1,
                                  microbatches=2, mb_size=2, mesh=_mesh(1))
    assert _sqnr_db(np.asarray(ref, np.float32), got) >= 30.0


def test_vit_pipeline_matches_reference_pipeline(vit_setup):
    jcfg, jparams, cfg, params, batch = vit_setup
    jctx = JCtx(shd=ShardingCtx(), dense_attn_max=256)
    ref = jpex.build_vit_pipeline(jparams, jcfg, jctx, stages=1,
                                  microbatches=2, mb_size=2).forward(
        {"images": jax.numpy.asarray(IMGS)})
    got, _ = vit.forward_pipelined(params, cfg, CTX, batch, stages=1,
                                   microbatches=2, mb_size=2, mesh=_mesh(1))
    assert _sqnr_db(np.asarray(ref, np.float32), got) >= 30.0


# ---------------------------------------------------- pure-Python copies

@pytest.mark.parametrize("n_tokens", [145, 4096])
@pytest.mark.parametrize("name", sorted(C.ARCHS) + sorted(C.VISION_ARCHS))
def test_serve_layer_costs_match_reference(name, n_tokens):
    if name in C.VISION_ARCHS:
        tcfg, jcfg = C.VISION_ARCHS[name], jconfigs.VISION_ARCHS[name]
    else:
        tcfg, jcfg = C.ARCHS[name], jconfigs.ARCHS[name]
    got = blockwise.serve_layer_costs(tcfg, n_tokens)
    assert got == jblockwise.serve_layer_costs(jcfg, n_tokens)
    segs = (vit.build_segments(tcfg) if name in C.VISION_ARCHS
            else lm.build_segments(tcfg))
    assert len(got) == sum(seg.n for seg in segs)  # zamba: + shared visits


@pytest.mark.parametrize("name", sorted(C.ARCHS))
def test_active_params_and_model_flops_match_reference(name):
    tcfg, jcfg = C.ARCHS[name], jconfigs.ARCHS[name]
    assert roofline.active_params(tcfg) == jroofline.active_params(jcfg)
    for shape in jconfigs.SHAPES.values():
        assert roofline.model_flops(tcfg, shape) == jroofline.model_flops(
            jcfg, shape)


def test_collective_stats_fields_match_reference():
    assert [f.name for f in dataclasses.fields(roofline.CollectiveStats)] \
        == [f.name for f in dataclasses.fields(jroofline.CollectiveStats)]


# ------------------------------------------------------- transfer guard

@pytest.mark.parametrize("stages,replicas", [(2, 1), (4, 1), (2, 2)])
def test_transfer_guard_weights_never_move(lm_setup, stages, replicas):
    _, _, cfg, params, batch = lm_setup
    mb, m = 2, 2
    runner = pex.build_lm_pipeline(params, cfg, CTX, stages=stages,
                                   replicas=replicas, microbatches=m,
                                   mb_size=mb, mesh=_mesh(stages, replicas))
    assert runner.trunk_resident()
    stats = runner.collectives(batch)
    assert set(stats.by_kind) == {"collective-permute"}
    want = (stages - 1) * m * replicas * mb * S * cfg.d_model * 2  # bf16
    assert stats.wire_bytes == want
    assert stats.count == (stages - 1) * m * replicas
    assert stats.wire_bytes < runner.trunk_bytes / 10
    runner.forward(batch)
    runner.forward(batch)
    assert runner.trunk_resident()
    # a weight handed to the hop raises: weights never move
    w = runner.trunk[0][0][0]["ffn"]["w1"]["w"]
    with pytest.raises(RuntimeError, match="never move"):
        runner._hop(w, None, CPU, roofline.CollectiveStats())


# ------------------------------------------------------- replica router

def test_replica_router_round_robin(lm_setup):
    _, _, cfg, params, batch = lm_setup
    ref, _ = lm.forward(params, cfg, CTX, batch)
    runner = pex.build_lm_pipeline(params, cfg, CTX, stages=2, replicas=2,
                                   microbatches=2, mb_size=1,
                                   mesh=_mesh(2, 2))
    router = pex.ReplicaRouter(runner)
    ids = batch["ids"]
    t1 = router.submit({"ids": ids[:2]})
    t2 = router.submit({"ids": ids[2:]})  # ragged: 1 row in a 2-row slot
    t3 = router.submit({"ids": ids[:1]})
    outs = router.flush()
    assert torch.equal(outs[t1], ref[:2])
    assert torch.equal(outs[t2], ref[2:])
    assert torch.equal(outs[t3], ref[:1])
    assert router.dispatched == [2, 1]
    assert not router._pending
    with pytest.raises(ValueError):
        router.submit({"ids": ids})  # 3 rows > the 2-row slot


# ---------------------------------------------------------- validation

def test_capacity_and_model_validation(lm_setup):
    _, _, cfg, params, batch = lm_setup
    runner = pex.build_lm_pipeline(params, cfg, CTX, stages=1,
                                   microbatches=1, mb_size=2, mesh=_mesh(1))
    with pytest.raises(ValueError, match="capacity"):
        runner.forward(batch)  # B=3 > capacity 2
    het = dataclasses.replace(cfg, attn_pattern="local_global", lg_ratio=1)
    with pytest.raises(NotImplementedError):
        pex.build_lm_pipeline(params, het, CTX, stages=1, mesh=_mesh(1))
    with pytest.raises(ValueError, match="stage cuts"):
        pex.StagePipeline(mesh=_mesh(2), bounds=[(0, 4)],
                          trunk=params["segments"][0], front={}, back={},
                          embed_fn=None, stage_fn=None, head_fn=None,
                          microbatches=1, mb_size=1)


def test_mesh_needs_devices():
    """Without ``devices=`` the grid takes one CUDA device a place and
    raises with fewer (none here); a repeated device is only ever asked
    for."""
    with pytest.raises(ValueError, match="devices="):
        pex.make_pipeline_mesh(2)
    with pytest.raises(ValueError, match="devices="):
        pex.make_pipeline_mesh(2, 2, devices=[CPU] * 3)
    mesh = _mesh(2, 2)
    assert mesh.shape == {"replica": 2, "stage": 2} and mesh.size == 4
    assert mesh.axis_names == ("replica", "stage")


# ------------------------------------------------------------ launcher

def test_pipeline_shape_matches_reference():
    for kw in ({"mesh": None, "stages": 0}, {"mesh": None, "stages": 4},
               {"mesh": "2x4", "stages": 0}, {"mesh": "2X2", "stages": 3}):
        ns = argparse.Namespace(**kw)
        assert tserve.pipeline_shape(ns) == jserve.pipeline_shape(ns)
    for bad in ("bogus", "0x2", "2x"):
        ns = argparse.Namespace(mesh=bad, stages=0)
        with pytest.raises(SystemExit):
            jserve.pipeline_shape(ns)
        with pytest.raises(SystemExit):
            tserve.pipeline_shape(ns)


def _gauge_shape(snap: dict) -> dict:
    return {name: sorted(tuple(sorted(s["labels"].items()))
                         for s in fam["series"])
            for name, fam in snap.items()
            if name.startswith("pipeline_measured")}


def test_launcher_pipelined_lm_and_gauges(lm_setup):
    out = tserve.main(["--device", "cpu", "--stages", "2",
                       "--microbatches", "2", "--batch", "3",
                       "--prompt-len", "8", "--layers", "4",
                       "--backend", "float", "--log-level", "warning"])
    assert out["parity"] == "bitwise"
    assert out["runner"].bounds == [(0, 2), (2, 4)]
    assert out["logits"].shape[:2] == (3, 8)
    reg = MetricsRegistry()
    out["report"].publish(reg)
    jrep = jpex.MeasuredReport(**dataclasses.asdict(out["report"]))
    jreg = JRegistry()
    jrep.publish(jreg)
    assert _gauge_shape(reg.snapshot()) == _gauge_shape(jreg.snapshot())
    assert {s["labels"]["stage"] for s in reg.snapshot()[
        "pipeline_measured_stage_wall_seconds"]["series"]} == {"0", "1"}


@pytest.mark.parametrize("backend", ["mxfp4", "cim"])
def test_launcher_pipelined_vision(backend):
    """``serve_vision`` with ``--stages 2`` on the geometry-true tiny
    ViT-L/32 (12 + 12 layers) and a CPU grid: frames through the runner,
    the measured gauges published beside the FWS model's."""
    args = tserve.build_parser().parse_args(
        ["--arch", "vit-l32", "--backend", backend, "--device", "cpu",
         "--stages", "2", "--microbatches", "2", "--frames", "3",
         "--log-level", "warning"])
    obs = Obs()
    cfg, params, ctx, dev = tserve.build_vision_model(args, obs=obs)
    out = tserve.serve_vision(args, cfg, params, ctx, obs, dev,
                              mesh=_mesh(2))
    runner = out["runner"]
    assert runner.bounds == [(0, 12), (12, 24)] and runner.capacity == 4
    assert out["frames"] == 3 and len(out["top1"]) == 3
    assert out["measured"]["stages"] == 2
    assert len(out["measured"]["stage_wall_ms"]) == 2
    snap = obs.registry.snapshot()
    assert "pipeline_measured_bubble_fraction" in snap
    assert snap["vision_frames_total"]["series"][0]["value"] == 3
    # the chain on the same frames gives the same labels
    chain = VisionEngine(params, cfg, ctx)
    assert chain.stream(out["images"]) == out["top1"]


# -------------------------------------------------------- vision engine

def test_vision_engine_with_runner(vit_setup):
    _, _, cfg, params, batch = vit_setup
    runner = pex.build_vit_pipeline(params, cfg, CTX, stages=2,
                                    microbatches=2, mb_size=1,
                                    mesh=_mesh(2))
    eng = VisionEngine(params, cfg, CTX, runner=runner)
    assert eng.chips == 2
    frames = batch["images"]
    chain = VisionEngine(params, cfg, CTX, chips=2)
    labels = eng.stream(frames)  # 3 frames: one slab of 2, one of 1
    assert labels == chain.stream(frames)
    assert eng.trace == [cfg.seq_len] * 3
    assert [e.kind for e in eng.obs.steps] == ["frame"] * 3
    assert eng.classify_frame(frames[0]) == labels[0]
    rep = eng.measured_report(frames, reps=1)
    assert rep.n_stages == 2 and rep.step_wall_s > 0
