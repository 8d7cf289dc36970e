"""The port's serving engine, its host-side pieces and the package's
isolation from JAX.

- A staggered multi-request run through ``Engine`` on the fused
  quantized-resident pool produces, token for token, what each request
  produces alone (the reference's isolation invariant, inside the port).
  (The legacy pool: ``tests/test_torch_legacy_pool.py``.)
- Allocator and scheduler behave as the reference's (same host code).
  (The FWS pipeline model behind ``trace_report`` is held to the
  reference in ``tests/test_torch_vision.py``.)
- ``repro_torch`` imports without JAX and imports nothing of ``repro``.
- The launcher serves every backend on the CPU when asked and refuses to
  fall back to the CPU silently; so does every public builder of device
  state.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

from repro.serving.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.kernels.paged_attention import layout  # noqa: E402
from repro_torch.layers import attention as tattention  # noqa: E402
from repro_torch.layers.common import RunCtx, convert_params_mxfp4  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import calibrate, lm  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.kvcache import (  # noqa: E402
    PagedKVCache,
    PoolExhausted,
    SlotAllocator,
    gather_rows,
    scatter_rows,
)
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = C.tiny(C.STARCODER2_7B)
ECFG = EngineConfig(lanes=3, num_slots=4, page_len=40, prefill_len=16,
                    kv_layout="fused")


@pytest.fixture(scope="module")
def cim_model():
    gen = torch.Generator().manual_seed(0)
    params = lm.init_model(CFG, gen)
    batches = calibrate.calibration_batches(CFG, n_batches=2, batch=2, seq=16,
                                            device="cpu")
    conv, _ = calibrate.convert_model_cim(
        params, CFG, RunCtx(dense_attn_max=256), batches,
        cim_cfg=tcim.CIMConfig(), min_n=32)
    return conv, RunCtx(quant="cim", cim=tcim.CIMConfig(), dense_attn_max=256)


@pytest.fixture(scope="module")
def mxfp4_model():
    params = lm.init_model(CFG, torch.Generator().manual_seed(1))
    return (convert_params_mxfp4(params, min_n=32),
            RunCtx(quant="mxfp4_wonly", dense_attn_max=256))


def _requests():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, CFG.vocab_size, int(n)).tolist(), int(m))
            for n, m in zip(rng.integers(2, 17, 5), rng.integers(3, 12, 5))]


@pytest.mark.parametrize("backend", ["cim", "mxfp4"])
def test_staggered_batching_equals_solo_runs(backend, request):
    """cim: quantized-resident pool; mxfp4: float pool, no code mirrors."""
    params, ctx = request.getfixturevalue(f"{backend}_model")
    eng = Engine(params, CFG, ctx, ECFG)
    assert eng.kv.mx_digital == (backend == "cim")
    assert ("kv_codes" in eng.kv.pool[0][0]) == (backend == "cim")
    for i, (prompt, n_new) in enumerate(_requests()):
        eng.add_request(prompt, max_new=n_new)
        for _ in range(i % 3):  # staggered arrivals mid-flight
            eng.step()
    together = eng.run()
    assert eng.slot_utilization < 1.0 or len(together) <= ECFG.lanes
    for rid, (prompt, n_new) in enumerate(_requests()):
        solo = Engine(params, CFG, ctx, ECFG)
        solo.add_request(prompt, max_new=n_new)
        assert solo.run()[0] == together[rid], rid
        assert len(together[rid]) == n_new


def test_engine_rejects_unported_modes(cim_model):
    """An unknown KV layout raises, as in the reference; chunked prefill
    and the prefix cache take the reference's checks; ``trace_report`` of
    an engine that ran nothing is the pipeline model of no jobs."""
    params, ctx = cim_model
    with pytest.raises(ValueError, match="prefix_cache requires chunk_len"):
        Engine(params, CFG, ctx, dataclasses.replace(ECFG, prefix_cache=True))
    for bad in (1, ECFG.page_len + 1):
        with pytest.raises(ValueError, match=r"chunk_len must be in \[2"):
            Engine(params, CFG, ctx, dataclasses.replace(ECFG, chunk_len=bad))
    with pytest.raises(ValueError, match="unknown KV layout 'paged'"):
        Engine(params, CFG, ctx, dataclasses.replace(ECFG, kv_layout="paged"))
    rep = Engine(params, CFG, ctx, ECFG).trace_report()
    assert rep.request_latency == {} and rep.pipeline.makespan == 0.0
    with pytest.raises(ValueError, match="prompt length"):
        Engine(params, CFG, ctx, ECFG).add_request(list(range(17)), 2)


def test_slot_allocator_refcounts():
    a = SlotAllocator(3)
    assert sorted(a.alloc() for _ in range(3)) == [0, 1, 2]
    assert a.try_alloc() is None and a.num_free == 0
    with pytest.raises(PoolExhausted):
        a.alloc()
    a.retain(1)
    a.release(1)
    assert a.refcount(1) == 1 and a.num_free == 0
    a.free(1)
    assert a.num_free == 1 and a.alloc() == 1


@pytest.mark.parametrize("layout", ["fused", "legacy"])
def test_gather_scatter_rows_roundtrip(layout):
    kv = PagedKVCache(CFG, num_slots=3, lanes=2, page_len=32, mx_digital=True,
                      layout=layout, device="cpu")
    raw = "kv" if layout == "fused" else "k"
    rows = torch.tensor([4, 1])
    vals = gather_rows(kv.pool, kv.specs, rows)
    for layer in vals[0]:
        layer[raw].fill_(1.5)
        layer["k_exps"].fill_(3)
    scatter_rows(kv.pool, kv.specs, rows, vals)
    for layer in kv.pool[0]:
        assert bool((layer[raw][rows] == 1.5).all())
        assert bool((layer[raw][[0, 2, 3]] == 0).all())
        assert bool((layer["k_exps"][rows] == 3).all())
    bad = [[{**layer, raw: layer[raw].float()} for layer in vals[0]]]
    with pytest.raises(TypeError, match=raw):
        scatter_rows(kv.pool, kv.specs, rows, bad)


@pytest.mark.parametrize("policy", ["prefill", "decode", "chunked"])
def test_scheduler_plans_like_reference(policy):
    """The same admission sequence through the port's and the reference's
    scheduler yields the same plan at every step."""
    scheds = (Scheduler(2, policy), JScheduler(2, policy))
    for i in range(4):
        for s in scheds:
            s.add(Request(rid=i, prompt=[1, 2], max_new=2))
    plans = [[], []]
    for step in range(12):
        for k, s in enumerate(scheds):
            act = s.plan(free_slots=2)
            plans[k].append(act)
            if act == "prefill":
                s.admit(slot=step, step=step)
            elif act == "decode" and step % 3 == 2:
                s.finish(next(iter(s.running.values())), step)
    assert plans[0] == plans[1]


def test_port_imports_no_jax_and_nothing_of_repro():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.kernels.cim_linear.ops, "
            "repro_torch.kernels.paged_attention.ops, "
            "repro_torch.kernels.mxfp4_matmul.ops, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.models.vit, repro_torch.serving.vision, "
            "repro_torch.serving.pipeline, repro_torch.hwmodel.perf, "
            "repro_torch.serving.load, repro_torch.obs.export, "
            "repro_torch.distributed.pipeline_exec, "
            "repro_torch.distributed.blockwise, "
            "repro_torch.optim.adamw, repro_torch.data.pipeline, "
            "repro_torch.checkpoint.ckpt, repro_torch.runtime.trainer, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.launch.dryrun, repro_torch.launch.mesh, "
            "repro_torch.distributed.sharding, repro_torch.obs.cost; "
            "import runpy; runpy.run_path('chip_smoke.py', run_name='x'); "
            "assert not [m for m, v in sys.modules.items() "
            "if v is not None and m.split('.')[0] in ('jax', 'repro')]")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        assert not bad.search(f.read_text()), f


@pytest.mark.parametrize("backend", ["mxfp4", "float", "cim"])
def test_launcher_serves_on_cpu_and_never_falls_back(backend):
    out = tserve.main(["--serve-trace", "--backend", backend, "--device",
                       "cpu", "--requests", "3", "--prompt-len", "8",
                       "--tokens", "4", "--log-level", "warning"])
    assert out["requests"] == 3 and out["tokens"] > 0
    assert all(0 <= t < CFG.vocab_size for v in out["out"].values() for t in v)
    assert out["ecfg"].kv_layout == "legacy"  # the reference's default
    assert tserve.build_parser().parse_args([]).backend == "mxfp4"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.main(["--serve-trace", "--backend", backend])


@pytest.mark.parametrize("layout", ["legacy", "fused"])
def test_launcher_serves_chunked_with_prefix_cache_on_cpu(layout):
    """``--chunk-len``, ``--policy chunked`` and ``--prefix-cache`` serve to
    the end on either ``--kv-layout``, and a prompt past
    ``dense_attn_max`` (256) takes the online-softmax prefill."""
    out = tserve.main(["--serve-trace", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "8", "--tokens", "4", "--chunk-len",
                       "4", "--policy", "chunked", "--prefix-cache",
                       "--kv-layout", layout, "--log-level", "warning"])
    assert out["requests"] == 3 and out["tokens"] > 0
    assert out["ecfg"].kv_layout == layout
    assert out["prefix"]["verify_failures"] == 0
    assert out["prefix"]["hits"] + out["prefix"]["misses"] == 3
    out = tserve.main(["--serve-trace", "--device", "cpu", "--requests", "1",
                       "--prompt-len", "300", "--tokens", "2", "--kv-layout",
                       layout, "--log-level", "warning"])
    assert out["prefill_len"] == 300 and out["tokens"] == 2
    with pytest.raises(SystemExit):  # argparse's choices
        tserve.main(["--serve-trace", "--device", "cpu", "--policy", "lifo"])


def test_public_builders_default_to_cuda(monkeypatch):
    """Without a ``device`` every public builder of device state resolves
    to CUDA: on a machine with no GPU it raises before it allocates, and
    never quietly builds CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg = lm.build_segments(CFG)[0]
    builders = [
        lambda **kw: lm.init_cache(CFG, 1, 32, fused=True, **kw),
        lambda **kw: tattention.attn_cache_init(seg.attn, 1, 32, fused=True,
                                                mx_digital=True, **kw),
        lambda **kw: layout.fused_cache_init(1, 32, 2, 16, **kw),
        lambda **kw: layout.fused_quant_init(1, 32, 2, 16, **kw),
        lambda **kw: PagedKVCache(CFG, 2, 2, 32, **kw),
        lambda **kw: calibrate.calibration_batches(CFG, 1, 1, 8, **kw),
    ]
    allocs = []
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: allocs.append(a))
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert not allocs
    monkeypatch.undo()
    cache = lm.init_cache(CFG, 1, 32, fused=True, device="cpu")
    assert cache[0][0]["kv"].device.type == "cpu"
