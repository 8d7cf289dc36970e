"""The port's training substrate against the JAX reference, case for case
with ``tests/test_substrate.py``: the data pipeline, AdamW, checkpoints
and the fault-tolerant trainer.

- ``make_batch`` is bitwise the reference's for the LM, audio and vision
  branches (the same numpy stream); ``Pipeline`` prefetches in step
  order.
- AdamW against ``repro.optim.adamw.apply`` over 3 steps on tiny
  gemma3-1b's tree (segments of 5, 1, 5 and 1 layers: a norm gamma is
  decayed in a stacked segment and not in a single-layer one), with the
  reference's gradients drawn from numpy and carried across like the
  parameters. Bounds: parameters and both moments within 1e-6 relative
  plus 1e-8, about one f32 ulp of a parameter of 0.1 (the f32 ops are
  the reference's in its order; XLA's pow, cos and fused multiplies may
  round another way in the last bit); the grad norm within 1e-6 relative
  (the leaves are summed in another order).
- Checkpoints: round trip, keep-last-k, crash safety (a half-written
  step never shadows the committed one), restore onto another device,
  bf16 leaves bit for bit, and the host snapshot taken before ``save``
  returns.
- The trainer's kill-restart is bitwise; the straggler monitor; the
  port's ``Trainer`` against the reference's ``Trainer`` from the same
  converted init (tiny xlstm-125m, 2 layers, seed 3), 2 steps of AdamW
  at lr 1 with eps 1 and no warmup, where the update is ~lr times the
  gradient: losses per step within 1e-3 relative (the reference's step
  is jitted with XLA's default fusions, which round bf16 chains another
  way), and each leaf's move from the init and both moments >= 30 dB.
  At lr 1e-2 with the default eps, Adam's first update is lr * sign(g):
  gradients that agree at ~40 dB flip the sign of their smallest
  elements, the moves agree at ~15 dB and the runs part after a step.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import _paths, _sqnr_db  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.data.pipeline import Pipeline, make_batch  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    HeartbeatMonitor,
    Trainer,
    TrainerConfig,
)

SHAPE = tconfigs.Shape(seq=16, batch=4, kind="train")
JSHAPE = jconfigs.Shape(seq=16, batch=4, kind="train")


def _tiny():
    return dataclasses.replace(tconfigs.tiny(tconfigs.XLSTM_125M),
                               n_layers=2, slstm_at=(1,))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return adamw.leaves(tree)


# ----------------------------------------------------------- data pipeline

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "hubert-xlarge",
                                  "qwen2-vl-7b"])
def test_make_batch_bitwise_reference(arch):
    tcfg = tconfigs.tiny(tconfigs.ARCHS[arch])
    jcfg = jconfigs.tiny(jconfigs.ARCHS[arch])
    want = jpipeline.make_batch(jcfg, JSHAPE, seed=7, step=3)
    got = make_batch(tcfg, SHAPE, seed=7, step=3, device="cpu")
    assert want.keys() == got.keys()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_batch_deterministic_per_step():
    cfg = _tiny()
    b1 = make_batch(cfg, SHAPE, seed=7, step=3, device="cpu")
    b2 = make_batch(cfg, SHAPE, seed=7, step=3, device="cpu")
    b3 = make_batch(cfg, SHAPE, seed=7, step=4, device="cpu")
    assert torch.equal(b1["ids"], b2["ids"])
    assert not torch.equal(b1["ids"], b3["ids"])


def test_pipeline_prefetch_order():
    cfg = _tiny()
    pipe = Pipeline(cfg, SHAPE, seed=1, start_step=5, device="cpu")
    s0, b0 = pipe.get()
    s1, _ = pipe.get()
    pipe.close()
    assert (s0, s1) == (5, 6)
    assert not pipe._t.is_alive()
    assert torch.equal(b0["ids"],
                       make_batch(cfg, SHAPE, seed=1, step=5,
                                  device="cpu")["ids"])


# -------------------------------------------------------------- optimizer

def test_adamw_matches_reference():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.0,
                            clip_norm=1e9)
    p = {"w": torch.tensor([[1.0, 2.0]]), "b": torch.tensor([0.5])}
    g = {"w": torch.tensor([[0.1, -0.2]]), "b": torch.tensor([0.3])}
    st = adamw.init(p)
    p2, st2, _ = adamw.apply(cfg, p, g, st)
    # step 1: mhat = g, vhat = g^2 -> update = lr * g/(|g|+eps) = lr*sign(g)
    np.testing.assert_allclose(p2["w"].numpy(), [[1.0 - 1e-2, 2.0 + 1e-2]],
                               rtol=1e-4)
    assert int(st2.step) == 1


def test_grad_clip_applied():
    cfg = adamw.AdamWConfig(lr=0.0, clip_norm=1.0)
    p = {"w": torch.ones((4,))}
    g = {"w": torch.full((4,), 100.0)}
    _, st2, met = adamw.apply(cfg, p, g, adamw.init(p))
    assert float(met["grad_norm"]) > 1.0
    # m = (1-b1) * clipped grad; clipped norm == 1
    assert np.linalg.norm(st2.m["w"].numpy()) <= (1 - cfg.b1) + 1e-5


def test_schedule_warmup_cosine():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                            min_lr_frac=0.1)
    jcfg = jadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                              min_lr_frac=0.1)
    assert float(adamw.schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(adamw.schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(adamw.schedule(cfg, torch.tensor(110))) == pytest.approx(
        0.1)
    for s in (0, 5, 10, 37, 60, 109, 110, 200):
        assert float(adamw.schedule(cfg, torch.tensor(s))) == pytest.approx(
            float(jadamw.schedule(jcfg, jnp.int32(s))), rel=1e-6, abs=1e-9)


def test_adamw_three_steps_match_reference_stacked_and_single():
    jcfg = jconfigs.tiny(jconfigs.ARCHS["gemma3-1b"])
    tcfg = tconfigs.tiny(tconfigs.GEMMA3_1B)
    params, _ = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    # gradients large enough to clip, gammas away from 1 so decay shows
    params = jax.tree.map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    grads = [jax.tree.map(
        lambda p: (0.05 * rng.standard_normal(p.shape)).astype(np.float32),
        params) for _ in range(3)]
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jp, js = params, jadamw.init(params)
    tp = from_reference(_np(params), device="cpu")
    ts = adamw.init(tp)
    nd = tlm.ref_ndim_tree(tcfg, tp)
    for g in grads:
        jp, js, jmet = jadamw.apply(jopt, jp, g, js)
        tp, ts, tmet = adamw.apply(opt, tp, from_reference(_np(g), "cpu"),
                                   ts, nd)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-6)
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for w, t in zip(_leaves(from_reference(_np(want), "cpu")),
                        _leaves(got)):
            np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-8)
    # trap 1: a stacked gamma is decayed, a single-layer one is not
    ln = lambda p, i: p["segments"][i][0]["attn"]["ln"]["gamma"]  # noqa
    no_decay = from_reference(_np(params), "cpu")
    st = adamw.init(no_decay)
    adamw.apply(dataclasses.replace(opt, weight_decay=0.0), no_decay,
                from_reference(_np(grads[0]), "cpu"), st, nd)
    t1 = adamw.init(tp)
    one = from_reference(_np(params), "cpu")
    adamw.apply(opt, one, from_reference(_np(grads[0]), "cpu"), t1, nd)
    assert not torch.equal(ln(one, 0), ln(no_decay, 0))  # stacked
    assert torch.equal(ln(one, 1), ln(no_decay, 1))  # single layer


# ------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip_and_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": tree["a"] + step, "b": {"c": tree["b"]["c"]
                                                     + step}},
                 blocking=True)
    assert mgr.latest_step() == 3
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000002", "step_00000003"]
    out = mgr.restore(3, tree)
    assert torch.equal(out["a"], tree["a"] + 3)
    assert out["a"].dtype == torch.int64


def test_checkpoint_crash_safety(tmp_path):
    """A half-written step dir never corrupts the committed checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.ones((3, 3))}
    mgr.save(1, tree, blocking=True)
    os.makedirs(tmp_path / "step_00000002.tmp")
    with open(tmp_path / "step_00000002.tmp" / "leaf_00000.npy", "wb") as f:
        f.write(b"garbage")
    with open(tmp_path / "LATEST", "w") as f:
        f.write("step_00000002")  # committed dir missing
    mgr2 = CheckpointManager(str(tmp_path), keep=3)
    assert mgr2.latest_step() == 1  # falls back to newest valid
    assert torch.equal(mgr2.restore(1, tree)["w"], torch.ones((3, 3)))


def test_checkpoint_restore_onto_another_device(tmp_path):
    """Leaves go to the device asked for, whatever the template's (the
    counterpart of the reference's reshard-on-load); ``meta`` stands in
    for a second device here."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    tree = {"w": torch.arange(8.0), "opt": adamw.init({"w": torch.ones(8)})}
    mgr.save(5, tree, blocking=True)
    out = mgr.restore(5, tree, device="meta")
    assert out["w"].device.type == "meta" and out["w"].shape == (8,)
    assert isinstance(out["opt"], adamw.OptState)
    assert mgr.restore(5, tree)["w"].device.type == "cpu"


def test_checkpoint_bf16_bits_and_manifest(tmp_path):
    import json

    bits = torch.tensor([0x3F80, 0x7FC1, 0x0001, -0x8000, 0x7F80],
                        dtype=torch.int16)
    tree = {"q": bits.view(torch.bfloat16), "step": torch.tensor(
        7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(2, tree, blocking=True)
    with open(tmp_path / "step_00000002" / "MANIFEST.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["q"]["dtype"] == "bfloat16"
    assert leaves["step"]["dtype"] == "int32"
    out = mgr.restore(2, tree)
    assert out["q"].dtype == torch.bfloat16
    assert torch.equal(out["q"].view(torch.int16), bits)


def test_checkpoint_save_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    w = torch.zeros(1 << 16)
    mgr.save(1, {"w": w})
    w.add_(1.0)  # the next step changes the tensor in place
    mgr.wait()
    assert not mgr.restore(1, {"w": w})["w"].any()


# ------------------------------------------------- fault-tolerant trainer

def test_trainer_kill_restart_bitwise(tmp_path):
    cfg = _tiny()

    def tc(d, n):
        return TrainerConfig(total_steps=n, ckpt_every=2,
                             ckpt_dir=str(tmp_path / d), seed=3)

    t_full = Trainer(cfg, SHAPE, tc("a", 6), device="cpu")
    r_full = t_full.run()
    assert r_full["final_step"] == 6
    assert r_full["losses"][0] > r_full["losses"][-1] * 0.5

    Trainer(cfg, SHAPE, tc("b", 3), device="cpu").run()
    t_resume = Trainer(cfg, SHAPE, tc("b", 6), device="cpu")
    assert t_resume.start_step == 3
    t_resume.run()
    for a, b in zip(_leaves(t_full.params), _leaves(t_resume.params)):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(t_full.opt_state), _leaves(t_resume.opt_state)):
        assert torch.equal(a, b)


def test_trainer_sigterm_saves_and_stops(tmp_path):
    import signal

    cfg = _tiny()
    tcfg = TrainerConfig(total_steps=6, ckpt_every=100,
                         ckpt_dir=str(tmp_path), seed=3)
    trainer = Trainer(cfg, SHAPE, tcfg, device="cpu")
    step_fn = trainer.step_fn

    def preempt_after_two(p, s, b):
        out = step_fn(p, s, b)
        if int(out[1].step) == 2:
            signal.raise_signal(signal.SIGTERM)
        return out

    trainer.step_fn = preempt_after_two
    result = trainer.run()
    assert result["preempted"] and result["final_step"] == 2
    assert trainer.ckpt.latest_step() == 2


def test_trainer_straggler_monitor():
    mon = HeartbeatMonitor(factor=3.0)
    for i in range(10):
        mon.record(i, 0.1)
    mon.record(10, 1.0)  # 10x median
    assert mon.slow_steps and mon.slow_steps[-1][0] == 10


def test_trainer_tracks_reference_trainer(tmp_path):
    jcfg = dataclasses.replace(jconfigs.tiny(jconfigs.ARCHS["xlstm-125m"]),
                               n_layers=2, slstm_at=(1,))
    params, _ = jlm.init_model(jax.random.PRNGKey(3), jcfg)
    steps = 2
    # no warmup, and Adam's update linear in the gradient (eps 1 against
    # gradients ~1e-3), so each step moves the params by ~lr * g and a
    # wrong update shows in the deltas
    opt = dict(lr=1.0, eps=1.0, warmup_steps=0)
    jt = jtrainer.Trainer(
        jcfg, JSHAPE, jtrainer.TrainerConfig(
            total_steps=steps, ckpt_every=100, ckpt_dir=str(tmp_path / "j"),
            seed=3), params=params, opt_cfg=jadamw.AdamWConfig(**opt))
    want = jt.run()["losses"]
    init = from_reference(_np(params), "cpu")
    tt = Trainer(_tiny(), SHAPE, TrainerConfig(
        total_steps=steps, ckpt_every=100, ckpt_dir=str(tmp_path / "t"),
        seed=3), params=adamw.tree_map(init, lambda t: t.clone()),
        opt_cfg=adamw.AdamWConfig(**opt), device="cpu")
    got = tt.run()["losses"]
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert int(tt.opt_state.step) == int(jt.opt_state.step) == steps
    paths = [p for p, _ in _paths(init)]
    for name, w_tree, g_tree, base in (
            ("params - init", jt.params, tt.params, init),
            ("m", jt.opt_state.m, tt.opt_state.m, None),
            ("v", jt.opt_state.v, tt.opt_state.v, None)):
        wl = _leaves(from_reference(_np(w_tree), "cpu"))
        gl = _leaves(g_tree)
        bl = _leaves(base) if base is not None else [0.0] * len(wl)
        for path, w, g, b in zip(paths, wl, gl, bl):
            db = _sqnr_db((w - b).numpy(), (g.detach() - b).numpy())
            assert db >= 30.0, (name, path, db)
