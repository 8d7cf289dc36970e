"""The captured engine and frame steps (``repro_torch/serving/graphs.py``)
and what capture needed of the code around them.

On the CPU:
- The launch-counter bookkeeping a replay does (``read_counts``,
  ``counts_delta``, ``add_counts``, ``set_counts``): the wrappers'
  counters by kernel and route and an ``Obs``'s ``kernel_calls_total``.
- RoPE frequencies are computed once per (dim, theta, device): the
  tables are bitwise the formula computed afresh.
- ``quant_page_step`` writes a partial end block (W % 32 != 0) with no
  data-dependent shape: bitwise the reference's.
- ``Engine.add_request`` rejects token ids outside the vocabulary.
- The prefill step (``engine._prefill_step``, one int64 input: ids,
  positions, row, last) gives the id and pool leaves of the eager path it
  replaced, bitwise, under float, mxfp4 and cim, into a fused or a legacy
  pool; run twice on one input it writes what one run writes (a graph's
  warm-up runs it so).
- On the CPU the engines run their steps eagerly: ``cuda_graphs`` changes
  nothing there, and a ``StepGraph`` refuses a CPU tensor.

On the card (``cuda`` marker): each of the five kernel wrappers captured
alone and replayed bitwise its eager launch; a tiny engine's tokens, on
a fused and on a legacy pool, captured == eager under cim, mxfp4 and
float, staggered and solo, with launch counts exact; its prefill, chunk,
clone and decode steps (the legacy decode: gather, decode, scatter)
captured == eager (ids and pool bytes; the prefill past
``dense_attn_max`` through ``flash_attention``) with exact counts after
replays, and none of the four steps syncs with the host; the decode
graph still replays bitwise
after a [1, 2048] prefill graph grew the kernels' scratch; a tiny ViT
frame and the two-chip chain captured == eager; a capture that fails
raises, a prefill step that syncs too.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import layout as jlayout  # noqa: E402
from repro.layers import rope as jrope  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import obs as obs_lib  # noqa: E402
from repro_torch.kernels.cim_linear import ops as cim_ops  # noqa: E402
from repro_torch.kernels.paged_attention import layout as tlayout  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers import rope as trope  # noqa: E402
from repro_torch.obs.profile import profiled_call  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, EngineConfig, graphs  # noqa: E402
from repro_torch.serving import VisionEngine  # noqa: E402
from repro_torch.serving import engine as eng_mod  # noqa: E402
from repro_torch.serving.kvcache import scatter_rows  # noqa: E402

ECFG = EngineConfig(lanes=2, num_slots=3, page_len=24, prefill_len=10,
                    kv_layout="fused")
REQS = ((9, 6), (4, 7), (10, 5), (2, 8))  # (prompt length, new tokens)


def _tiny_lm(backend: str, device: str = "cpu",
             arch: str = "starcoder2-7b"):
    """A tiny LM (default starcoder2-7b) through the launcher's
    ``build_model`` on the CPU, its parameters moved to ``device``."""
    args = tserve.build_parser().parse_args(
        ["--arch", arch, "--serve-trace", "--backend", backend, "--device",
         "cpu", "--log-level", "warning"])
    cfg, params, ctx, _ = tserve.build_model(args)
    return cfg, _to(params, device), ctx


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _serve(cfg, params, ctx, ecfg, staggered: bool = True) -> list:
    """REQS through one engine (staggered arrivals), or each alone."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in REQS]
    if not staggered:
        out = []
        for prompt, (_, m) in zip(prompts, REQS):
            eng = Engine(params, cfg, ctx, ecfg)
            eng.add_request(prompt, max_new=m)
            out.append(eng.run()[0])
        return out
    eng = Engine(params, cfg, ctx, ecfg)
    rids = []
    for prompt, (_, m) in zip(prompts, REQS):
        rids.append(eng.add_request(prompt, max_new=m))
        eng.step()
    done = eng.run()
    return [done[r] for r in rids]


# ------------------------------------------------- counter bookkeeping

def test_counter_bookkeeping_moves_every_counter_by_its_delta():
    """A replay moves each counter by what the capture moved it: the
    wrappers' ``launches`` and ``route_launches`` and the Obs's
    ``kernel_calls_total`` by label; ``set_counts`` puts them back."""
    obs = obs_lib.Obs()
    wrappers = graphs._wrappers()
    saved = graphs.read_counts(None)
    try:
        before = graphs.read_counts(obs)
        cim_ops.cim_linear.launches += 3
        cim_ops.cim_linear.route_launches["splitk"] += 3
        wrappers["paged_decode_mx"].launches += 1
        for _ in range(2):
            profiled_call("cim_linear", obs, lambda: None)
        after = graphs.read_counts(obs)
        delta = graphs.counts_delta(before, after)
        calls = ("obs", (("kernel", "cim_linear"), ("mode", "eager")))
        assert delta == {("launches", "cim_linear"): 3,
                         ("route", "cim_linear", "splitk"): 3,
                         ("launches", "paged_decode_mx"): 1, calls: 2.0}
        graphs.set_counts(before, obs)
        assert graphs.read_counts(obs) == {**before, calls: 0}
        for _ in range(5):  # five replays
            graphs.add_counts(delta, obs)
        now = graphs.read_counts(obs)
        assert graphs.counts_delta(before, now) == {
            k: 5 * v for k, v in delta.items()}
        snap = obs.registry.snapshot()["kernel_calls_total"]["series"]
        assert snap == [{"labels": {"kernel": "cim_linear", "mode": "eager"},
                         "value": 10.0}]
    finally:
        graphs.set_counts(saved, None)


def test_step_graph_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA steps only"):
        graphs.StepGraph(lambda x: x + 1, torch.zeros(3))


# ------------------------------------------------------------- RoPE

@pytest.mark.parametrize("dim,theta", [(16, 1e4), (80, 1e4), (128, 1e5),
                                       (256, 1e6)])
def test_rope_tables_cached_bitwise(dim, theta):
    """The frequencies are computed once per (dim, theta, device) and the
    tables are bitwise the formula computed afresh (``torch.pow`` of a
    theta tensor on the positions' device). Against the reference within
    2 f32 ulps at 1 (2.4e-7): XLA's pow, cos and sin round differently in
    the last bit."""
    pos = torch.from_numpy(np.arange(0, 3000, 7).reshape(1, -1))
    cos, sin = trope.rope_tables(pos, dim, theta)
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    ang = pos.to(torch.float32)[..., None] * inv
    assert torch.equal(cos, torch.cos(ang)[..., None, :])
    assert torch.equal(sin, torch.sin(ang)[..., None, :])
    assert trope._inv_freq(dim, theta, "cpu") is trope._inv_freq(dim, theta,
                                                                 "cpu")
    jcos, jsin = jrope.rope_tables(jnp.asarray(pos.numpy()), dim, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0,
                               atol=2.4e-7)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0,
                               atol=2.4e-7)


# ------------------------------------------------- quant_page_step

@pytest.mark.parametrize("w,slots", [(24, [23, 0, 10]), (48, [47, 33, 31]),
                                     (40, [39, 32, 5])])
def test_quant_page_step_partial_block_bitwise(w, slots):
    """A page width that is not a multiple of 32: the step's writes of
    the partial end block (slots past the page write slot W-1's own codes
    again) leave the mirrors bitwise the reference's."""
    hkv, dh = 2, 16
    rng = np.random.default_rng(w)
    kv = rng.standard_normal((4, w, 2 * hkv, dh)).astype(np.float32)
    jkv = jnp.asarray(kv).astype(jnp.bfloat16)
    tkv = torch.from_numpy(np.array(jkv).view(np.int16)).view(
        torch.bfloat16)
    k, v = tlayout.split_kv(tkv)
    jq = jax.jit(jlayout.quant_page_full)(*jlayout.split_kv(jkv))
    tq = tlayout.quant_page_full(k, v)
    rows, slot = np.array([3, 0, 1]), np.array(slots)
    new = jnp.asarray(rng.standard_normal((3, 2 * hkv, dh)), jnp.bfloat16)
    jkv = jkv.at[rows, slot].set(new)
    tkv[torch.from_numpy(rows), torch.from_numpy(slot)] = torch.from_numpy(
        np.array(new).view(np.int16)).view(torch.bfloat16)
    jout = jax.jit(jlayout.quant_page_step)(jq, jkv, jnp.asarray(rows),
                                            jnp.asarray(slot))
    tlayout.quant_page_step(tq, tkv, torch.from_numpy(rows),
                            torch.from_numpy(slot))
    for name in ("kv_codes", "k_exps", "v_exps"):
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jout[name]))


# ------------------------------------------------------------ engines

def test_add_request_rejects_out_of_vocabulary_ids():
    """An id outside [0, vocab) raises ValueError at admission, before it
    can reach the embedding (a device-side assert on CUDA; the
    reference's jnp.take fills NaN rows)."""
    cfg, params, ctx = _tiny_lm("float")
    eng = Engine(params, cfg, ctx, ECFG)
    for bad in ([1, cfg.vocab_size], [-1, 2], [2 ** 40]):
        with pytest.raises(ValueError, match="not in \\[0, 128\\)"):
            eng.add_request(bad, max_new=2)
    assert not eng.requests and not eng.sched.has_work
    eng.add_request([0, cfg.vocab_size - 1], max_new=2)
    assert len(eng.run()[0]) == 2


def test_cpu_engines_run_eagerly():
    """On the CPU there is nothing to capture: ``cuda_graphs`` leaves no
    graph and the same tokens, and ``impl="ref"`` is accepted."""
    cfg, params, ctx = _tiny_lm("mxfp4")
    eng = Engine(params, cfg, dataclasses.replace(ctx, impl="ref"), ECFG)
    assert eng.graphs == {}
    on = _serve(cfg, params, ctx, ECFG)
    off = _serve(cfg, params, ctx,
                 dataclasses.replace(ECFG, cuda_graphs=False))
    assert on == off
    vcfg = C.tiny_vit(C.VIT_B16)
    from repro_torch.models import vit
    vparams = vit.init_model(vcfg, torch.Generator().manual_seed(0))
    assert VisionEngine(vparams, vcfg, ctx).graphs is None


# ------------------------------------------------------ the prefill step

def _prompt_input(eng, prompt, row) -> torch.Tensor:
    """The prefill step's input for ``prompt`` into pool row ``row``."""
    p = eng.ecfg.prefill_len
    step = np.zeros(2 * p + 2, np.int64)
    eng_mod._window(step, p, prompt, 0)
    step[2 * p:] = (row, len(prompt) - 1)
    return torch.from_numpy(step).to(eng.device)


@torch.no_grad()
def _eager_prefill(eng, prompt, row) -> int:
    """The engine's prefill before its steps took device inputs: Python
    ``row`` and ``last``, ``hidden[:, last]`` and a host-built row index."""
    cfg, p, n = eng.cfg, eng.ecfg.prefill_len, len(prompt)
    ids = np.zeros((1, p), np.int64)
    ids[0, :n] = prompt
    positions = np.full((1, p), eng_mod.attn_mod.KV_PAD, np.int64)
    positions[0, :n] = np.arange(n)
    caches = lm.init_cache(cfg, 1, eng.ecfg.page_len,
                           mx_digital=eng.kv.mx_digital, fused=eng.kv.fused,
                           device=eng.device)
    hidden, caches = lm.forward(
        eng.params, cfg, dataclasses.replace(eng.ctx, arange_positions=True),
        {"ids": torch.from_numpy(ids).to(eng.device),
         "positions": torch.from_numpy(positions).to(eng.device)},
        caches=caches, return_hidden=True)
    logits = lm._head(eng.ctx, cfg, eng.params, hidden[:, n - 1][:, None])
    scatter_rows(eng.kv.pool, eng.kv.specs,
                 torch.tensor([row], device=eng.device), caches)
    return int(torch.argmax(logits[0, 0].float()))


def _pool_bytes(pool) -> list:
    return [v.view(torch.uint8).clone() if v.dtype != torch.bfloat16
            else v.view(torch.int16).clone()
            for seg in pool for layer in seg for v in layer.values()]


def _pools_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("layout", ["fused", "legacy"])
@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
def test_prefill_step_bitwise_the_eager_path(backend, layout):
    """``_prefill_step`` on one int64 input gives the id and pool leaves
    of the eager path it replaced, bitwise, on either pool layout; run
    twice on the same input it leaves the pool as one run does (the
    graph's warm-up runs it so)."""
    cfg, params, ctx = _tiny_lm(backend)
    rng = np.random.default_rng(7)
    ecfg = dataclasses.replace(ECFG, prefill_len=12, kv_layout=layout)
    old, new = (Engine(params, cfg, ctx, ecfg) for _ in range(2))
    for n, row in ((12, 2), (5, 0), (1, 1)):
        prompt = rng.integers(0, cfg.vocab_size, n).tolist()
        want = _eager_prefill(old, prompt, row)
        step = _prompt_input(new, prompt, row)
        got = eng_mod._prefill_step(params, cfg, ctx, new.kv.pool,
                                    new.kv.specs, step)
        assert got.shape == (1,) and got.dtype == torch.int64
        assert int(got[0]) == want
        assert _pools_equal(_pool_bytes(new.kv.pool),
                            _pool_bytes(old.kv.pool))
    once = _pool_bytes(new.kv.pool)
    again = eng_mod._prefill_step(params, cfg, ctx, new.kv.pool,
                                  new.kv.specs, step)
    assert int(again[0]) == int(got[0])
    assert _pools_equal(_pool_bytes(new.kv.pool), once)


# ------------------------------------------------ the card (cuda marker)

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")


def _capture_bitwise(fn, x: torch.Tensor, kernel: str) -> None:
    """``fn`` captured alone and replayed on a new input: bitwise its
    eager launch, and the wrapper's counter moves by one a replay."""
    eager = fn(x)
    g = graphs.StepGraph(fn, x.clone())
    g.capture()
    assert torch.equal(g.static_out, eager)
    y = x.flip(-1).contiguous()
    g.static_in.copy_(y)
    counter = graphs._wrappers()[kernel]
    before = counter.launches
    got = g().clone()
    assert counter.launches == before + 1
    assert torch.equal(got, fn(y))


@pytest.mark.cuda
def test_cuda_each_wrapper_captured_bitwise():
    """cim_linear (splitk), mxfp4_matmul (mma), paged_decode,
    paged_decode_mx and flash_attention (wgmma), each captured alone."""
    _cuda()
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.layers import backends

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k, n = 512, 768
    w = mxlib.quantize_w(torch.randn((k, n), generator=gen, device=dev))
    x = torch.randn((4, k), generator=gen, device=dev).to(torch.bfloat16)
    cfg = cimlib.CIMConfig()
    cal = cimlib.calibrate_rowhist([x.float()], w, cfg)
    _capture_bitwise(lambda t: cim_ops.cim_linear(t, w, cal, cfg=cfg), x,
                     "cim_linear")
    packed = backends._quantize_packed(torch.randn((k, n), generator=gen,
                                                   device=dev))
    _capture_bitwise(lambda t: mm_ops.mxfp4_matmul(
        t, packed["codes"], packed["exps"]), x, "mxfp4_matmul")
    hkv, g, dh, w_pg = 2, 3, 128, 96
    kv = torch.randn((6, w_pg, 2 * hkv, dh), generator=gen,
                     device=dev).to(torch.bfloat16)
    quant = tlayout.quant_page_full(*tlayout.split_kv(kv))
    rows = torch.tensor([4, 0, 2, 5], device=dev)
    lens = torch.tensor([1, 40, 96, 0], device=dev, dtype=torch.int32)
    q = torch.randn((4, hkv, g, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    _capture_bitwise(lambda t: pops.ragged_paged_decode(
        t, rows, lens, kv=kv, scale=dh ** -0.5), q, "paged_decode")
    from repro_torch.core.mx import fake_quant
    _capture_bitwise(lambda t: pops.ragged_paged_decode(
        fake_quant(t), rows, lens, quant=quant, scale=dh ** -0.5), q,
        "paged_decode_mx")
    qa = torch.randn((1, 200, 4, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    ka, va = (torch.randn((1, 200, 2, 128), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    _capture_bitwise(lambda t: fa_ops.flash_attention(t, ka, va, causal=True),
                     qa, "flash_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused", "legacy"])
@pytest.mark.parametrize("backend", ["cim", "mxfp4", "float"])
def test_cuda_engine_captured_tokens_equal_eager(backend, layout):
    """Tiny starcoder2-7b on the card, either pool layout: captured tokens
    == eager tokens, bitwise, for staggered requests and each request
    alone; the launch counts of a captured run equal the eager run's (no
    paged decode kernel on a legacy pool, so none at all under float
    there); ``impl="ref"`` with graphs raises."""
    _cuda()
    cfg, params, ctx = _tiny_lm(backend, "cuda")
    capt_cfg = dataclasses.replace(ECFG, kv_layout=layout)
    eager_cfg = dataclasses.replace(capt_cfg, cuda_graphs=False)
    counts = []
    outs = []
    for ecfg in (eager_cfg, capt_cfg):
        before = graphs.read_counts()
        outs.append(_serve(cfg, params, ctx, ecfg))
        counts.append(graphs.counts_delta(before, graphs.read_counts()))
    assert outs[0] == outs[1]
    assert counts[0] == counts[1]
    paged = sum(n for key, n in counts[0].items()
                if key[0] == "launches" and key[1].startswith("paged_decode"))
    assert (paged > 0) == (layout == "fused")
    # float on a legacy pool: bf16 linears, short prompts, torch-op decode
    assert bool(counts[0]) == (backend != "float" or layout == "fused")
    assert _serve(cfg, params, ctx, capt_cfg, staggered=False) == outs[0]
    assert Engine(params, cfg, ctx, capt_cfg).graphs["decode"] is not None
    with pytest.raises(ValueError, match="runs eagerly"):
        Engine(params, cfg, dataclasses.replace(ctx, impl="ref"), capt_cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("chips", [1, 2])
def test_cuda_vision_frame_captured_equals_eager(chips):
    """A tiny ViT frame (and the two-chip chain) captured == eager,
    bitwise, over a stream of frames; the chain's graphs hand the hidden
    state over as their static buffers."""
    _cuda()
    from repro_torch.models import vit

    vcfg = dataclasses.replace(C.tiny_vit(C.VIT_L32), n_layers=4,
                               chips=chips)
    args = tserve.build_parser().parse_args(
        ["--arch", "vit-l32", "--backend", "cim", "--device", "cpu",
         "--log-level", "warning"])
    cpu = torch.device("cpu")
    fparams = vit.init_model(vcfg, torch.Generator().manual_seed(0))
    params, ctx = tserve.build_backend(
        args, vcfg, fparams, cpu, forward_fn=vit.forward,
        batches=vit.calibration_images(vcfg, device=cpu))
    params = _to(params, "cuda")
    frames = torch.randn((5, vcfg.image_size, vcfg.image_size, 3),
                         generator=torch.Generator().manual_seed(1)).cuda()
    eager = VisionEngine(params, vcfg, ctx, cuda_graphs=False)
    capt = VisionEngine(params, vcfg, ctx)
    for f in frames:
        assert torch.equal(capt.logits(f[None]), eager.logits(f[None]))
    assert len(capt.graphs[((1,) + tuple(frames.shape[1:]),
                            torch.float32)]) == chips
    assert capt.stream(frames) == eager.stream(frames)


@pytest.mark.cuda
def test_cuda_failed_capture_raises():
    """A step that reads the device from the host cannot be captured: the
    capture raises, and nothing runs the step eagerly in its place."""
    _cuda()
    calls = []

    def step(x):
        calls.append(1)
        return x * float(x.sum())  # a host read inside the step

    g = graphs.StepGraph(step, torch.ones(4, device="cuda"))
    with pytest.raises(RuntimeError):
        g()
    assert g.graph is None


STEP_ECFG = EngineConfig(lanes=2, num_slots=3, page_len=24, prefill_len=10,
                         kv_layout="fused",
                         chunk_len=4, policy="chunked")


def _step_inputs(cfg) -> list:
    """(step, host input) calls over every step: a 10-token prefill into
    row 0 (past ``dense_attn_max`` = 8), the clone of its first 4 rows
    into row 1 and two chunks there, a reset of row 2 and a chunk into
    it, a decode step over rows 1 and 2."""
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, 14).tolist()
    pre = np.zeros(22, np.int64)
    eng_mod._window(pre, 10, prompt[:10], 0)
    pre[20:] = (0, 9)
    calls = [("prefill", pre)]
    for row, src, n, offs in ((1, 0, 4, (4, 8)), (2, 2, 0, (0,))):
        calls.append(("clone", np.array([src, row, n], np.int64)))
        for o in offs:
            ch = np.zeros(11, np.int64)
            take = min(4, len(prompt) - o)
            eng_mod._window(ch, 4, prompt[o:o + take], o)
            ch[8:] = (row, take - 1, o)
            calls.append(("chunk", ch))
    calls.append(("decode", np.array([[1, 2], [prompt[12], prompt[3]],
                                      [12, 4]], np.int64)))
    return calls


def _run_calls(eng, calls, no_sync: bool = False) -> tuple[list, dict]:
    """Each call through the engine's own path (host array, pinned copy,
    graph or eager step), with ``no_sync`` under
    ``set_sync_debug_mode("error")`` (a step that syncs raises); the
    outputs, read after each call, and the launch counts it moved."""
    before = graphs.read_counts(eng.ctx.obs)
    outs = []
    for name, host in calls:
        eng._host[name].numpy()[:] = host
        torch.cuda.synchronize()  # the previous copy from the host array
        torch.cuda.set_sync_debug_mode("error" if no_sync else "default")
        try:
            out = eng._call(name)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append(None if out is None else out.cpu().clone())
    return outs, graphs.sum_modes(
        graphs.counts_delta(before, graphs.read_counts(eng.ctx.obs)))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused", "legacy"])
@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("backend", ["cim", "mxfp4", "float"])
def test_cuda_steps_captured_equal_eager(backend, arch, layout):
    """The prefill (past ``dense_attn_max``: ``flash_attention`` in its
    graph under mxfp4 and float), clone, chunk and decode steps of a tiny
    engine, dense and MoE (the dispatch's sort, capacity and gathers in
    every step; under mxfp4 and cim one ``mxfp4_matmul`` launch an expert
    a bank), captured == eager: ids and pool bytes bitwise, the launch
    counts of every pass equal the eager pass's (replays included), the
    obs's ``kernel_calls_total`` too. No step syncs with the host (each
    eager step runs under ``set_sync_debug_mode("error")``, after a pass
    that did the one-time setup). A pass rewrites every row it reads
    first, so a second pass gives the first one's bytes. On a legacy pool
    the decode step gathers, decodes and scatters the lanes' pages: no
    paged decode kernel launches."""
    _cuda()
    cfg, params, ctx = _tiny_lm(backend, "cuda", arch)
    ctx = dataclasses.replace(ctx, dense_attn_max=8, obs=obs_lib.Obs())
    calls = _step_inputs(cfg)
    step_ecfg = dataclasses.replace(STEP_ECFG, kv_layout=layout)
    eager = Engine(params, cfg, ctx,
                   dataclasses.replace(step_ecfg, cuda_graphs=False))
    _run_calls(eager, calls)  # one-time setup (tables, scratch) first
    want, want_counts = _run_calls(eager, calls, no_sync=True)
    if backend != "cim":
        assert want_counts[("launches", "flash_attention")] == cfg.n_layers
    paged = sum(n for key, n in want_counts.items()
                if key[0] == "launches" and key[1].startswith("paged_decode"))
    assert (paged > 0) == (layout == "fused")
    capt = Engine(params, cfg, ctx, step_ecfg)
    for _ in range(2):  # the captures, then replays only
        got, counts = _run_calls(capt, calls)
        assert counts == want_counts
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
        assert _pools_equal(_pool_bytes(capt.kv.pool),
                            _pool_bytes(eager.kv.pool))
    assert sorted(n for n, g in capt.graphs.items() if g.graph is not None) \
        == ["chunk", "clone", "decode", "prefill"]
    for g in capt.graphs.values():
        assert g.capture_s > 0 and g.pool_bytes >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cim", "mxfp4"])
def test_cuda_decode_graph_replays_after_long_prefill_graph(backend):
    """A [1, 2048] prefill captured in another engine grows the kernels'
    shared scratch (``cim_linear``'s workspaces, ``mxfp4_matmul``'s
    arrival counters) past what a decode graph captured: the decode graph
    still replays bitwise what it gave before, and the eager step's."""
    _cuda()
    cfg, params, ctx = _tiny_lm(backend, "cuda")
    short = Engine(params, cfg, ctx, ECFG)
    rng = np.random.default_rng(4)
    for n, m in REQS:
        short.add_request(rng.integers(0, cfg.vocab_size, n).tolist(),
                          max_new=m)
    short.run()
    step = np.array([[0, 1], [5, 9], [12, 20]], np.int64)
    short._host["decode"].numpy()[:] = step
    before = short._call("decode").clone()
    pool = _pool_bytes(short.kv.pool)
    long = Engine(params, cfg, ctx, EngineConfig(
        lanes=1, num_slots=1, page_len=2056, prefill_len=2048,
        kv_layout="fused"))
    long.add_request(rng.integers(0, cfg.vocab_size, 2048).tolist(),
                     max_new=1)
    long.run()
    assert long.graphs["prefill"].graph is not None
    short._host["decode"].numpy()[:] = step
    assert torch.equal(short._call("decode"), before)
    assert _pools_equal(_pool_bytes(short.kv.pool), pool)
    eager = eng_mod._decode_step(params, cfg, ctx, short.kv.pool,
                                 torch.from_numpy(step).cuda())
    assert torch.equal(eager, before)


@pytest.mark.cuda
def test_cuda_prefill_step_that_syncs_raises(monkeypatch):
    """A host read inside the prefill step makes its capture raise; the
    request gets no token from an eager run in its place."""
    _cuda()
    cfg, params, ctx = _tiny_lm("mxfp4", "cuda")
    greedy = eng_mod._greedy

    def syncing(ctx, cfg, params, hidden, last):
        return greedy(ctx, cfg, params, hidden * float(hidden.sum() * 0 + 1),
                      last)

    monkeypatch.setattr(eng_mod, "_greedy", syncing)
    eng = Engine(params, cfg, ctx, ECFG)
    rid = eng.add_request([1, 2, 3], max_new=2)
    with pytest.raises(RuntimeError):
        eng.step()
    assert eng.graphs["prefill"].graph is None
    assert eng.requests[rid].out == []
