"""Chunked prefill and the prefix cache in the port's engine: the cases of
``tests/test_prefix.py`` on ``repro_torch``, plus one check against the
reference's chunk step.

- Fixed ``[1, chunk_len]`` windows, including prompts longer than
  ``prefill_len``, give the tokens of greedy full-sequence ``lm.forward``
  (float, mxfp4).
- With the prefix cache on, a shared-system-prompt workload gives the
  tokens of the cache-off run bitwise, with hits, no verify failures and
  fewer prefill steps (float, mxfp4, cim).
- Fingerprints are content addresses: equal across donors of one prefix,
  and bit-rot under a cached page is a counted miss.
- The host control plane (scheduler, refcounted allocator, radix tree)
  keeps its invariants under random interleavings.
- Chunk steps of the port against the reference's on the same weights
  under the digital SDPA (mirrors recomputed for the whole page every
  chunk), into a fused and into a legacy split page: logits, raw rows and
  mirrors of every layer bitwise.
- The prefix cache and the fingerprints on either pool layout.
- The engine's chunk step (``engine._chunk_step``, one int64 input: ids,
  positions, row, last, offset) gives the ids and pool leaves of the
  eager path it replaced, bitwise, and run twice on one input writes what
  one run writes; ``clone_prefix`` on device scalars is bitwise the
  reference's ``clone_prefix`` for n = 0, a partial V 32-block and the
  full page, on either layout.
"""

import dataclasses
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import kvcache as jkvcache  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers.common import RunCtx, convert_params_mxfp4  # noqa: E402
from repro_torch.models import calibrate, lm  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.serving import Engine, EngineConfig, PrefixCache  # noqa: E402
from repro_torch.serving import engine as eng_mod  # noqa: E402
from repro_torch.serving.kvcache import (  # noqa: E402
    PoolExhausted,
    SlotAllocator,
    clone_prefix,
    gather_rows,
    scatter_rows,
)
from repro_torch.serving.prefix import page_fingerprint  # noqa: E402
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402

CFG = C.tiny(C.STARCODER2_7B)
SYS = [5, 6, 7, 8, 9, 10, 11, 12]  # 8-token shared system prompt


@pytest.fixture(scope="module")
def models():
    params = lm.init_model(CFG, torch.Generator().manual_seed(0))
    ctx = RunCtx(dense_attn_max=256)
    batches = calibrate.calibration_batches(CFG, n_batches=2, batch=2, seq=16,
                                            device="cpu")
    conv, _ = calibrate.convert_model_cim(params, CFG, ctx, batches,
                                          cim_cfg=tcim.CIMConfig(), min_n=32)
    return {"float": (params, ctx),
            "mxfp4": (convert_params_mxfp4(params, min_n=32),
                      dataclasses.replace(ctx, quant="mxfp4_wonly")),
            "cim": (conv, dataclasses.replace(ctx, quant="cim",
                                              cim=tcim.CIMConfig()))}


def _engine(params, ctx, obs_on=False, **kw):
    base = dict(lanes=3, num_slots=4, page_len=24, prefill_len=8,
                policy="chunked", chunk_len=4, kv_layout="fused")
    base.update(kw)
    return Engine(params, CFG, ctx, EngineConfig(**base),
                  obs=Obs(enabled=obs_on))


@torch.no_grad()
def _greedy(params, ctx, prompt, max_new):
    toks, outs = list(prompt), []
    for _ in range(max_new):
        logits, _ = lm.forward(params, CFG, ctx, {"ids": torch.tensor([toks])})
        outs.append(int(torch.argmax(logits[0, -1].float())))
        toks.append(outs[-1])
    return outs


def _shared_prompts(n=5):
    """Most prompts open with the shared system prompt; one does not."""
    return [SYS + [20 + i] for i in range(n)] + [[3, 4, 5]]


def _run(params, ctx, prompts, max_new=4, **kw):
    eng = _engine(params, ctx, **kw)
    rids = [eng.add_request(list(p), max_new=max_new) for p in prompts]
    out = eng.run()
    return eng, [out[r] for r in rids]


# ------------------------------------------------- chunked prefill fidelity

@pytest.mark.parametrize("backend", ["float", "mxfp4"])
def test_chunked_prefill_matches_greedy(backend, models):
    params, ctx = models[backend]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, CFG.vocab_size, size=n).tolist()
               for n in (3, 7, 8, 13, 20)]  # chunk and prefill_len edges
    _, outs = _run(params, ctx, prompts, max_new=4, page_len=32)
    for p, got in zip(prompts, outs):
        assert got == _greedy(params, ctx, p, 4), f"len {len(p)}"


def test_single_shot_rejects_long_prompt_chunked_accepts(models):
    params, ctx = models["float"]
    long_prompt = list(range(1, 15))  # 14 > prefill_len=8
    eng = Engine(params, CFG, ctx, EngineConfig(lanes=1, num_slots=1,
                                                page_len=24, prefill_len=8,
                                                kv_layout="fused"))
    with pytest.raises(ValueError, match="prompt length"):
        eng.add_request(long_prompt, max_new=2)
    eng_c = _engine(params, ctx, lanes=1, num_slots=1)
    rid = eng_c.add_request(long_prompt, max_new=2)
    assert len(eng_c.run()[rid]) == 2


# ------------------------------------------------ bitwise prefix-cache reuse

@pytest.mark.parametrize("layout", ["fused", "legacy"])
@pytest.mark.parametrize("backend", ["float", "mxfp4", "cim"])
def test_prefix_cache_outputs_bitwise_equal(backend, layout, models):
    """Cache-on tokens equal cache-off tokens with a nonzero hit rate, on
    either pool layout; the reused pages carry the quantized mirrors
    under cim."""
    params, ctx = models[backend]
    prompts = _shared_prompts(4 if backend == "cim" else 5)
    _, off = _run(params, ctx, prompts, prefix_cache=False, kv_layout=layout)
    eng, on = _run(params, ctx, prompts, prefix_cache=True, kv_layout=layout)
    assert on == off
    st_ = eng.prefix_stats()
    assert st_["hits"] > 0 and st_["hit_tokens"] > 0, st_
    assert st_["verify_failures"] == 0


def test_prefix_hits_reduce_prefill_steps(models):
    params, ctx = models["float"]
    prompts = _shared_prompts(5)

    def prefills(pc):
        eng, _ = _run(params, ctx, prompts, prefix_cache=pc, obs_on=True)
        return sum(1 for e in eng.obs.steps if e.kind == "prefill")

    # 4 hit requests x 8 shared tokens / chunk_len 4 = 8 skipped windows
    n_off, n_on = prefills(False), prefills(True)
    assert n_on == n_off - 8, (n_on, n_off)


def test_clone_prefix_copies_raw_rows_and_zeroes_the_rest(models):
    params, ctx = models["cim"]
    eng = _engine(params, ctx, lanes=1, num_slots=2)
    rid = eng.add_request(SYS + [42], max_new=1)
    eng.run()
    donor = eng.requests[rid].slot
    dst = 1 - donor
    for layer in eng.kv.pool[0]:
        for leaf in layer.values():
            leaf[dst].fill_(3)  # stale bytes in the other slot
    clone_prefix(eng.kv.pool, eng.kv.specs, torch.tensor(donor),
                 torch.tensor(dst), torch.tensor(6))
    for layer in eng.kv.pool[0]:
        assert torch.equal(layer["kv"][dst, :6], layer["kv"][donor, :6])
        assert layer["kv"][donor, :9].float().abs().sum() > 0
        assert not layer["kv"][dst, 6:].float().any()
        for name in ("kv_codes", "k_exps", "v_exps"):
            assert not layer[name][dst].any(), name
    clone_prefix(eng.kv.pool, eng.kv.specs, torch.tensor(dst),
                 torch.tensor(dst), torch.tensor(0))  # a reset
    assert not eng.kv.pool[0][0]["kv"][dst].float().any()


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("layout", ["fused", "legacy"])
@pytest.mark.parametrize("n", [0, 40, 48])
def test_clone_prefix_device_scalars_bitwise_reference(n, layout):
    """``clone_prefix`` with device-scalar rows and length, on a pool of
    random values (page 48: n = 40 ends inside the second V 32-block), is
    bitwise the reference's ``clone_prefix`` on either layout: the
    destination's first n raw rows (``kv``, or ``k`` and ``v``) copied,
    the rest and its mirrors zeroed, every other row untouched."""
    fused = layout == "fused"
    jcfg = jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"])
    jpool = jlm.init_cache(jcfg, 5, 48, mx_digital=True, fused=fused)
    jspecs = jlm.cache_specs(jcfg, mx_digital=True, fused=fused)
    rng = np.random.default_rng(n)
    # finite bf16 K/V (XLA may rewrite a NaN's payload), any mirror bytes
    leaves = [{k: (np.asarray(jnp.asarray(rng.standard_normal(v.shape),
                                          v.dtype)) if v.dtype == jnp.bfloat16
                   else rng.integers(0, 256, v.shape, dtype=np.uint8).view(
                       v.dtype))
               for k, v in seg.items()} for seg in jpool]
    jout = jax.jit(lambda p, s, d, m: jkvcache.clone_prefix(
        p, jspecs, s, d, m))(
        [{k: jnp.asarray(v) for k, v in seg.items()} for seg in leaves],
        jnp.int32(3), jnp.int32(1), jnp.int32(n))

    def port_leaf(v):  # bf16 through its int16 bits
        if v.dtype == jnp.bfloat16:
            return torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(v.copy())

    pool = [[{k: port_leaf(v[j]) for k, v in seg.items()}
             for j in range(CFG.n_layers)] for seg in leaves]
    specs = lm.cache_specs(CFG, mx_digital=True, fused=fused)
    clone_prefix(pool, specs, torch.tensor(3), torch.tensor(1),
                 torch.tensor(n))
    for seg, jseg in zip(pool, jout):
        assert sorted(seg[0]) == sorted(jseg)
        for j, layer in enumerate(seg):
            for k, v in layer.items():
                ref = np.asarray(jseg[k])[j]
                if ref.dtype == jnp.bfloat16:
                    ref = ref.view(np.int16)
                np.testing.assert_array_equal(_bits(v), ref, err_msg=k)


def _chunk_input(prompt, offs, width, row) -> torch.Tensor:
    take = min(width, len(prompt) - offs)
    step = np.zeros(2 * width + 3, np.int64)
    eng_mod._window(step, width, prompt[offs:offs + take], offs)
    step[2 * width:] = (row, take - 1, offs)
    return torch.from_numpy(step)


@torch.no_grad()
def _eager_chunk(eng, prompt, offs, row) -> int:
    """The engine's chunk before its steps took device inputs: Python
    ``row``, ``offset`` and ``last``."""
    width = eng.ecfg.chunk_len
    take = min(width, len(prompt) - offs)
    ids = np.zeros((1, width), np.int64)
    ids[0, :take] = prompt[offs:offs + take]
    positions = np.full((1, width), tattn.KV_PAD, np.int64)
    positions[0, :take] = np.arange(offs, offs + take)
    rows = torch.tensor([row])
    caches = gather_rows(eng.kv.pool, eng.kv.specs, rows)
    hidden, caches = lm.forward(
        eng.params, CFG, eng.ctx, {"ids": torch.from_numpy(ids),
                                   "positions": torch.from_numpy(positions)},
        caches=caches, pos=offs, return_hidden=True)
    logits = lm._head(eng.ctx, CFG, eng.params,
                      hidden[:, take - 1][:, None])
    scatter_rows(eng.kv.pool, eng.kv.specs, rows, caches)
    return int(torch.argmax(logits[0, 0].float()))


@pytest.mark.parametrize("backend", ["float", "cim"])
def test_chunk_step_bitwise_the_eager_path(backend, models):
    """``_chunk_step`` over a 13-token prompt in windows of 4 (the last
    one partial) gives the ids and pool leaves of the eager path it
    replaced, bitwise; a window run twice leaves the pool as one run."""
    params, ctx = models[backend]
    old, new = (_engine(params, ctx) for _ in range(2))
    prompt = np.random.default_rng(6).integers(0, CFG.vocab_size,
                                               13).tolist()
    pool = new.kv.pool
    for offs in range(0, len(prompt), 4):
        want = _eager_chunk(old, prompt, offs, 2)
        step = _chunk_input(prompt, offs, 4, 2)
        got = eng_mod._chunk_step(params, CFG, ctx, pool, new.kv.specs, step)
        assert got.shape == (1,) and int(got[0]) == want, offs
        for a, b in zip(_leaves(pool), _leaves(old.kv.pool)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        once = [_bits(a).copy() for a in _leaves(pool)]
        eng_mod._chunk_step(params, CFG, ctx, pool, new.kv.specs, step)
        for a, b in zip(_leaves(pool), once):
            np.testing.assert_array_equal(_bits(a), b)


def _leaves(pool):
    return [v for seg in pool for layer in seg for v in layer.values()]


# ------------------------------------------- content-addressable identity

@pytest.mark.parametrize("layout", ["fused", "legacy"])
def test_fingerprint_deterministic_across_donors(layout, models):
    """Two donors of one prefix with other tails: equal fingerprints at
    the prefix (the V blocks cut to whole 32-blocks, on either layout's
    mirrors), other ones past it."""
    params, ctx = models["cim"]
    eng = _engine(params, ctx, lanes=2, num_slots=4, kv_layout=layout)
    pa, pb = SYS + [101, 102], SYS + [111, 112]
    # both stay live until the second admits, so the LIFO allocator
    # cannot give the first page to the second request
    ra = eng.add_request(pa, max_new=6)
    rb = eng.add_request(pb, max_new=6)
    while eng.requests[rb].slot < 0:  # -1 until admitted
        eng.step()
    sa, sb = eng.requests[ra].slot, eng.requests[rb].slot
    assert sa != sb
    eng.run()
    n = len(SYS)
    assert page_fingerprint(eng.kv, sa, n) == page_fingerprint(eng.kv, sb, n)
    assert (page_fingerprint(eng.kv, sa, len(pa))
            != page_fingerprint(eng.kv, sb, len(pa)))


def test_fingerprint_corruption_is_counted_miss(models):
    params, ctx = models["float"]
    eng = _engine(params, ctx, prefix_cache=True)
    rid = eng.add_request(SYS + [42], max_new=2)
    eng.run()
    donor = eng.requests[rid].slot
    assert donor in eng.prefix.cached_slots
    probe = SYS + [43]
    assert eng.prefix.match(probe, eng.kv) is not None
    eng.kv.pool[0][0]["kv"][donor, 0] += 1  # flip the donor's raw K/V
    before = eng.prefix.stats()["verify_failures"]
    assert eng.prefix.match(probe, eng.kv) is None
    assert eng.prefix.stats()["verify_failures"] == before + 1
    assert donor not in eng.prefix.cached_slots  # backing dropped
    assert eng.kv.allocator.refcount(donor) == 0  # slot back on free list


# ------------------------------------------------ eviction + refcount unit

def test_prefix_eviction_respects_refcounts():
    a = SlotAllocator(4)
    pc = PrefixCache(chunk_len=2, allocator=a, fingerprints=False)
    s_live, s_old, s_new = a.alloc(), a.alloc(), a.alloc()
    assert pc.insert([1, 2, 3, 4], s_live)  # the cache takes its own ref
    assert pc.insert([5, 6], s_old)
    assert pc.insert([7, 8], s_new)
    a.free(s_old)  # the donors' requests retire...
    a.free(s_new)
    # ...but s_live's request still runs: not evictable
    assert pc.n_evictable == 2
    assert pc.evict_lru()  # LRU: s_old went in before s_new
    assert a.refcount(s_old) == 0 and pc.match([5, 6, 9]) is None
    assert pc.evict_lru()
    assert a.refcount(s_new) == 0
    assert not pc.evict_lru()  # s_live is pinned by its request
    assert pc.match([1, 2, 3]) is not None  # still served
    a.free(s_live)
    assert pc.n_evictable == 1 and pc.evict_lru()
    assert a.num_free == 4  # every reference drained


def test_prefix_match_always_leaves_live_suffix():
    a = SlotAllocator(2)
    pc = PrefixCache(chunk_len=2, allocator=a, fingerprints=False)
    s = a.alloc()
    pc.insert([1, 2, 3, 4], s)
    hit = pc.match([1, 2, 3, 4])
    assert hit is not None and hit.n_tokens == 2  # not 4
    assert pc.match([1, 2]) is None  # would leave nothing live
    assert pc.match([1, 2, 3, 4, 5]).n_tokens == 4


def test_prefix_insert_keeps_existing_backing():
    a = SlotAllocator(3)
    pc = PrefixCache(chunk_len=2, allocator=a, fingerprints=False)
    s1, s2 = a.alloc(), a.alloc()
    assert pc.insert([1, 2, 3, 4], s1)
    assert not pc.insert([1, 2, 3, 4], s2)  # nodes keep s1
    assert pc.match([1, 2, 3, 4, 5]).slot == s1
    assert a.refcount(s2) == 1  # only its request's own reference


# --------------------------------------- control-plane property (invariants)

_CHUNK, _SLOTS, _LANES = 2, 3, 2


def _sim_step(rng, sched, alloc, cache, live):
    """One scheduler-planned unit of fake work, the engine's chunked
    admission and retire flow without any device compute."""
    action = sched.plan(alloc.num_free + cache.n_evictable)
    if action == "idle":
        return
    if action == "prefill":
        req = sched.prefilling
        if req is None:
            hit = cache.match(sched.waiting[0].prompt)
            if hit is not None:
                alloc.retain(hit.slot)  # pin the donor
            try:
                slot = alloc.try_alloc()
                while slot is None:
                    if not cache.evict_lru():
                        raise PoolExhausted("planned admit with no slot")
                    slot = alloc.try_alloc()
            finally:
                if hit is not None:
                    alloc.release(hit.slot)
            req = sched.begin_prefill(slot, step=0)
            live[req.rid] = req
            if hit is not None:
                req.prefilled = req.prefix_hit = hit.n_tokens
        req.prefilled = min(len(req.prompt), req.prefilled + _CHUNK)
        if req.prefilled == len(req.prompt):
            sched.finish_prefill(req)
            req.out.append(rng.randrange(100))
            cache.insert(req.prompt, req.slot)
    else:  # decode: every running request advances one token
        for req in list(sched.running.values()):
            req.out.append(rng.randrange(100))
            req.pos += 1
            if Scheduler.stop_reason(req, page_len=64) is not None:
                sched.finish(req, step=0)
                alloc.free(req.slot)
                del live[req.rid]


def _check_invariants(sched, alloc, cache):
    holders = list(sched.running.values())
    if sched.prefilling is not None:
        holders.append(sched.prefilling)
    slots = [r.slot for r in holders]
    lanes = [r.lane for r in holders]
    assert len(set(slots)) == len(slots), f"slot aliasing: {slots}"
    assert len(set(lanes)) == len(lanes), f"lane aliasing: {lanes}"
    for r in holders:
        assert alloc.refcount(r.slot) >= 1
    for s in cache.cached_slots:
        assert alloc.refcount(s) >= 1, "cache advertises a freed slot"
    assert alloc.num_free + len(alloc.in_use) == _SLOTS
    expected = {r.slot for r in holders} | cache.cached_slots
    assert alloc.in_use == expected, (alloc.in_use, expected)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_control_plane_invariants_under_random_interleaving(seed):
    """No slot aliased across lanes, nothing freed twice, no cached page
    without its reference, and every refcount drained once quiet."""
    rng = random.Random(seed)
    sched = Scheduler(lanes=_LANES, policy="chunked")
    alloc = SlotAllocator(_SLOTS)
    cache = PrefixCache(chunk_len=_CHUNK, allocator=alloc, fingerprints=False)
    live, rid = {}, 0
    for _ in range(60):
        if rng.random() < 0.4 and len(sched.waiting) < 4:
            # a small alphabet and even lengths make prefixes collide
            prompt = [rng.randrange(3) for _ in range(rng.choice([2, 4, 6]))]
            sched.add(Request(rid=rid, prompt=prompt,
                              max_new=rng.randint(1, 4)))
            rid += 1
        else:
            _sim_step(rng, sched, alloc, cache, live)
        _check_invariants(sched, alloc, cache)
    while sched.has_work:  # drain
        _sim_step(rng, sched, alloc, cache, live)
        _check_invariants(sched, alloc, cache)
    assert not live and sched.running == {} and sched.prefilling is None
    while cache.evict_lru():  # the cache holds the last references
        pass
    assert alloc.num_free == _SLOTS and alloc.in_use == set()


# ---------------------------------------- against the reference's chunk step

@pytest.fixture(scope="module")
def ref_model():
    """The reference's tiny starcoder2-7b (float weights) and the port's
    copy of it, shared by the layouts of the chunk-step check."""
    jcfg = jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"])
    jparams, _ = jlm.init_model(jax.random.PRNGKey(2), jcfg)
    tparams = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tparams


@pytest.mark.parametrize("layout", ["fused", "legacy"])
def test_chunk_steps_match_reference(layout, ref_model):
    """Three [1, 8] chunks of a 20-token prompt into one 32-slot page, fused
    or legacy, under ``mxfp4_digital`` (the digital SDPA over
    quantized-resident mirrors, float weights): each chunk's logits
    bitwise the reference's chunk step's, then every leaf of the page
    (raw rows and the mirrors recomputed for the whole page) of each
    layer bitwise."""
    jcfg, jparams, tparams = ref_model
    fused = layout == "fused"
    jctx = jcommon.RunCtx(shd=jcommon.ShardingCtx(), quant="mxfp4_digital",
                          unroll_layers=True, dense_attn_max=256)
    tctx = RunCtx(quant="mxfp4_digital", dense_attn_max=256)
    prompt = np.random.default_rng(4).integers(0, CFG.vocab_size, 20)
    jc = jlm.init_cache(jcfg, 1, 32, mx_digital=True, fused=fused)
    tc = lm.init_cache(CFG, 1, 32, mx_digital=True, fused=fused,
                       device="cpu")
    for offs in (0, 8, 16):
        take = min(8, len(prompt) - offs)
        ids = np.zeros((1, 8), np.int64)
        ids[0, :take] = prompt[offs:offs + take]
        positions = np.full((1, 8), tattn.KV_PAD, np.int64)
        positions[0, :take] = np.arange(offs, offs + take)
        assert tattn.KV_PAD == jattn.KV_PAD
        ref, jc = jlm.forward(jparams, jcfg, jctx,
                              {"ids": jnp.asarray(ids, jnp.int32),
                               "positions": jnp.asarray(positions, jnp.int32)},
                              caches=jc, pos=jnp.int32(offs))
        with torch.no_grad():
            got, tc = lm.forward(tparams, CFG, tctx,
                                 {"ids": torch.from_numpy(ids),
                                  "positions": torch.from_numpy(positions)},
                                 caches=tc, pos=offs)
        np.testing.assert_array_equal(got[0, :take].float().numpy(),
                                      np.asarray(ref, np.float32)[0, :take],
                                      err_msg=f"chunk at {offs}")
    for j, layer in enumerate(tc[0]):
        assert sorted(layer) == sorted(jc[0])
        for k, v in layer.items():
            ref = np.asarray(jc[0][k])[j]
            if ref.dtype == jnp.bfloat16:
                ref = ref.view(np.int16)
            np.testing.assert_array_equal(_bits(v), ref, err_msg=k)
