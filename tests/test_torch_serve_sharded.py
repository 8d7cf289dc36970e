"""The sharded serving steps of the port (``launch.steps.make_prefill_step``,
``make_decode_step`` and ``make_paged_decode_step`` on a mesh over a
``torch.distributed`` group), on the CPU: gloo ranks spawned by
``torch_dist.spawn``, their side in ``tests/torch_serve_ranks.py`` (no
JAX), the tiny starcoder2-7b, h2o-danube-1.8b, gemma3-1b (one KV head,
qk-norm, tied head, local and global layers) and qwen2-vl-7b (M-RoPE, the
vision front end) at head_dim 32, d_ff 128 and windows of 64, a prompt
and caches of 128, 2 lanes, under ``none``, ``mxfp4_wonly`` (packed at
``min_n`` 32) and calibrated ``cim``. One world-2 spawn runs (1, 2) and
(2, 1) and the raises; one world-4 spawn runs (2, 2) and (1, 4), then
rank 0 alone (1, 1) on a group of one.

- (1, 1) on a group: the three builders (the paged step in both layouts)
  bitwise the one-device bundles, ids and caches.
- (1, 2), (2, 1), (2, 2), (1, 4): each rank's ids equal the one-device
  ids of its rows, or, where one differs, the one-device logits of the
  two picks are within 2 bf16 ulps (the sharded sums run in another f32
  order; a tie of bf16 logits breaks either way): the one-device logits
  are computed here. Each rank's cache blocks >= 40 dB against the same
  slices of the one-device caches, and a paged pool's change from its
  input (two rows a leaf) >= 30 dB, the repo's gate for a step's change;
  an unchanged leaf bitwise. Under gemma3-1b's qk-norm, which amplifies
  the f32 sums' order through its 12 layers, each block's gate is
  min(40, its floor - 3 dB) and each change's min(30, its floor - 3 dB):
  the floor is the SQNR of the same slice of the one-device steps run
  with ``wo``'s and ``w2``'s K cut as the model ranks cut it, each
  slice's product in f32, summed and rounded once (``split_k`` of
  ``scripts/torch_serve_multicard.py``): the same function, its sums in
  another order. Under ``cim`` every block bitwise (no tiny row reaches 2^24
  units, and the digital SDPA's quantization absorbs the reordered f32
  sums here). One lane at (2, 2) puts the decode cache's sequence on
  (data, model), its softmax combined over the world.
- The fused paged step (starcoder2-7b under ``mxfp4_wonly`` and ``cim``)
  on all four meshes, and on (2, 1) and (2, 2) over a pool of 3 rows,
  which do not divide the data axis, so its sequence is cut over
  ``data`` (over the world at (2, 2)): kernels B and D in their partial
  mode on the rank's block, the blocks' (o, lse) combined over the
  ranks. Held as the legacy step against the plain one-device fused
  step (ids; blocks >= 40 dB, under ``cim`` >= 30 dB; each change >= 30
  dB), and under ``cim`` bitwise against the one-device step run as the
  ranks run it (``torch_serve_ranks.seq_blocks``: each block's partial
  by the plain version, combined in block order): A's sums are exact
  and the combine runs in rank order.
- (1, 1) with ``model_forms`` (the row-parallel linears' modes, the
  gathers, the vocab-parallel head and the fused decode's partial mode
  at one block, at model 1): the steps bitwise the one-device bundles
  under ``mxfp4_wonly`` and ``cim``, the fused paged step too.
- Row-parallel ``w2`` (K over the model ranks) on its own: ``cim`` (kernel
  A's pass sums, summed as integers, one read-out) bitwise the one-device
  linear; ``mxfp4_wonly`` (C's f32 partials, one rounding) within a bf16
  ulp.
- The reference's own builders (``repro.launch.steps``) on an Auto-axes
  1 x 1 ``jax.sharding.Mesh``, compiled with XLA's excess precision off,
  against the port's (1, 2) steps on the same weights
  (``from_reference``) and inputs: ids equal, each cache block >= 30 dB.
  starcoder2-7b under ``none``, ``mxfp4_wonly`` and ``cim`` (its weights
  unconverted, as the reference's builders take them: the digital
  SDPA's quantized-resident pool, the MXFP4 fake-quant linears),
  h2o-danube-1.8b and gemma3-1b under ``none``, qwen2-vl-7b (its vision
  embeddings too) under ``mxfp4_wonly``; starcoder2-7b's fused paged
  step under ``mxfp4_wonly`` and ``cim`` too (the reference's
  ``kv_layout="fused"``, whose dense decode XLA's partitioner cuts).
- Collectives: the decode's, the prefill's and the fused paged step's
  counts and result bytes on the model axis are the formula's (below),
  with the ring model's wire bytes.
- Raises (``NotImplementedError`` naming ``ROADMAP.md``): the digital
  SDPA on a fused pool whose sequence block is not whole 32-blocks (24
  slots at model 2), a non-dense family (mixtral-8x22b) on the model
  axis, a K shard off the 32-blocks (d_ff 96 over 2 under
  ``mxfp4_wonly``: ``w2``'s 48 rows).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import torch_dist  # noqa: E402
import torch_serve_ranks as R  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.roofline import ring_wire_bytes  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.layers.common import RunCtx, linear_apply  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_paged_step import _to_port  # noqa: E402
from test_torch_train import _NO_EXCESS, _np, _sqnr_db  # noqa: E402

MIN_DB = 40.0
REF_DB = 30.0
# a qk-norm config's block may sit this far below its floor (the split-K
# one-device run's SQNR at the same slice)
FLOOR_MARGIN_DB = 3.0
TIE_ULPS = 2
STEPS = ("prefill", "decode", "paged")
W2, W4 = ((1, 2), (2, 1)), ((2, 2), (1, 4))
# (arch, quant) -> meshes; starcoder2-7b (the four-card arch) on all four,
# each other config on some
MATRIX = {
    **{("starcoder2-7b", q): W2 + W4 for q in R.QUANTS},
    ("h2o-danube-1.8b", "none"): ((1, 2), (2, 2)),
    ("h2o-danube-1.8b", "mxfp4_wonly"): ((2, 1), (1, 4)),
    ("h2o-danube-1.8b", "cim"): ((1, 2), (2, 2)),
    ("gemma3-1b", "none"): ((1, 2), (1, 4)),
    ("gemma3-1b", "mxfp4_wonly"): ((2, 2),),
    ("gemma3-1b", "cim"): ((2, 1),),
    ("qwen2-vl-7b", "none"): ((2, 1), (2, 2)),
    ("qwen2-vl-7b", "mxfp4_wonly"): ((1, 2),),
    ("qwen2-vl-7b", "cim"): ((1, 4),),
}
FUSED = (("starcoder2-7b", "mxfp4_wonly"), ("starcoder2-7b", "cim"))
# the pool of 3 rows (its sequence on the data axes)
FUSED3_MESHES = ((2, 1), (2, 2))
REF_CASES = (("starcoder2-7b", "none"), ("starcoder2-7b", "mxfp4_wonly"),
             ("starcoder2-7b", "cim"), ("h2o-danube-1.8b", "none"),
             ("gemma3-1b", "none"), ("qwen2-vl-7b", "mxfp4_wonly"))
# the qk-norm configs' floors: (arch, quant, model ranks)
FLOORS = sorted({(a, q, m[1]) for (a, q), ms in MATRIX.items() for m in ms
                 if R.config(a).qk_norm and q != "cim" and m[1] > 1})
FORMS = ("mxfp4_wonly", "cim")  # (1, 1) with model_forms
RAISES = {
    "fused_block_off_32": ((1, 2), "starcoder2-7b", "cim", ("fused_odd",)),
    "moe_on_model": ((1, 2), "mixtral-8x22b", "mxfp4_wonly", ("prefill",)),
    "k_shard_off_blocks": ((1, 2), "starcoder2-7b", "mxfp4_wonly",
                           ("decode",), 96),
}


def _steps(arch, quant, mesh) -> tuple:
    s = STEPS
    if (arch, quant) in FUSED:
        s += ("fused",) + (("fused3",) if mesh in FUSED3_MESHES else ())
    if arch == "starcoder2-7b" and mesh[1] > 1:
        s += ("rowlin",)
    if (arch, quant, mesh) == ("starcoder2-7b", "none", (2, 2)):
        s += ("decode1",)
    return s


def _jobs(meshes) -> list:
    return [(m, a, q, _steps(a, q, m)) for (a, q), ms in MATRIX.items()
            for m in ms if m in meshes]


def _jcfg(arch):
    cfg = jconfigs.tiny(jconfigs.ARCHS[arch])
    return dataclasses.replace(cfg, head_dim=32, d_ff=128,
                               window=64 if cfg.window else 0)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's init of each of ``REF_CASES``'s archs (seed 0),
    converted under the quant as the reference's builders convert it
    (``cim``: not at all, as they take it)."""
    out = {}
    for arch, quant in REF_CASES:
        params, _ = jlm.init_model(jax.random.PRNGKey(0), _jcfg(arch))
        if quant == "mxfp4_wonly":
            params = jax.jit(jsteps.convert_params_mxfp4)(params)
        out[arch, quant] = params
    return out


@pytest.fixture(scope="module")
def floors(cases):
    """The one-device steps of each of ``FLOORS`` under
    ``split_k`` (``scripts/torch_serve_multicard.py``)."""
    return {(a, q, m): R.floor(a, q, cases[a, q], m) for a, q, m in FLOORS}


@pytest.fixture(scope="module")
def cases(ref_params):
    out = {key: R.case(*key, fused3=key in FUSED) for key in MATRIX}
    gen = torch.Generator().manual_seed(9)
    for key in (("starcoder2-7b", q) for q in R.QUANTS):
        out[key]["x"] = torch.randn((4, 128), generator=gen).to(
            torch.bfloat16)
    for key, params in ref_params.items():
        out[("ref",) + key] = R.case(
            *key, params=from_reference(_np(params), device="cpu"),
            fused3=False)
    return out


def _lean(case: dict) -> dict:
    """A case without its one-device results (the ranks do not need them)."""
    return {k: v for k, v in case.items() if k != "one"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, cases):
    """The world-2 and the world-4 spawns, run at once (each blocks on its
    ranks): (results, jobs) and (results, jobs, the (1, 1) jobs)."""
    from concurrent.futures import ThreadPoolExecutor

    jobs2 = _jobs(W2)
    jobs2 += [((1, 2),) + key[1:] + (
        STEPS + (("fused",) if key[1:] in FUSED else ()), 128, key)
              for key in cases if key[0] == "ref"]
    jobs2 += [RAISES[k] for k in RAISES]
    jobs4 = _jobs(W4)
    jobs1 = [((1, 1), "starcoder2-7b", q,
              STEPS + (("fused",) if q != "none" else ()))
             for q in R.QUANTS]
    jobs1 += [((1, 1), "starcoder2-7b", q, STEPS + ("fused",), 128, None,
               True) for q in FORMS]
    store1 = str(tmp_path_factory.mktemp("serve1") / "store")
    with ThreadPoolExecutor(2) as pool:
        f2 = pool.submit(torch_dist.spawn, R.run, 2,
                         tmp_path_factory.mktemp("serve2"), jobs2,
                         {k: _lean(v) for k, v in cases.items()})
        f4 = pool.submit(torch_dist.spawn, R.run, 4,
                         tmp_path_factory.mktemp("serve4"), jobs4,
                         {k: _lean(v) for k, v in cases.items()
                          if k[0] != "ref"}, store1, jobs1)
        return (f2.result(), jobs2), (f4.result(), jobs4, jobs1)


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[1]


def _mesh(shape, rank) -> Mesh:
    return Mesh(("data", "model"), shape,
                (torch.device("meta"),) * (shape[0] * shape[1]), rank=rank)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _logits(cfg, quant, case, step: str) -> torch.Tensor:
    """The one-device logits behind the ids of ``step`` (prefill, decode,
    decode1, paged, fused), the bundles' bodies on the case's inputs."""
    from repro_torch.launch import steps
    from repro_torch.serving.kvcache import gather_rows

    params, inp = case["params"], case["inp"]
    ctx = RunCtx(quant=quant)
    with torch.no_grad():
        if step == "prefill":
            caches = lm.init_cache(cfg, R.BATCH, R.SEQ, device="cpu")
            hidden, _ = lm.forward(params, cfg, ctx, inp["batch"],
                                   caches=caches, return_hidden=True)
            return steps._prefill_logits(cfg, ctx, params, hidden[:, -1])
        if step in ("decode", "decode1"):
            n = R.BATCH if step == "decode" else 1
            caches = R._clone(case["caches"]) if n > 1 else R._row0(
                case["caches"])
            return lm.decode_step(params, cfg, ctx, inp["ids"][:n],
                                  inp["pos"], caches)[0]
        pool = R._clone(case["pools"][step])
        rows = inp["rows"].long()
        if step in ("fused", "fused3"):
            return lm.decode_step(params, cfg, dataclasses.replace(
                ctx, paged_rows=rows), inp["ids"], inp["paged_pos"],
                pool)[0]
        specs = lm.cache_specs(cfg, mx_digital=quant == "cim")
        return lm.decode_step(params, cfg, ctx, inp["ids"],
                              inp["paged_pos"],
                              gather_rows(pool, specs, rows))[0]


def _check_ids(case, cfg, quant, step, got, want, rows):
    """``got`` (a rank's ids) against the one-device ``want`` at ``rows``:
    equal, or the one-device logit of the sharded pick within
    ``TIE_ULPS`` bf16 ulps of the largest (a tie that the sums' order
    breaks otherwise)."""
    want, got = want[rows].long(), got.long()
    if torch.equal(got, want):
        return
    lf = _logits(cfg, quant, case, step)[rows].float()
    for i in torch.nonzero(got != want)[:, 0].tolist():
        top = float(lf[i].max())
        gap = top - float(lf[i, got[i]])
        ulp = float(torch.finfo(torch.bfloat16).eps) * abs(top)
        assert gap <= TIE_ULPS * ulp, (step, i, gap, ulp)


def _rows_of(spec, mesh, n) -> slice:
    return shd.shard_slices((spec[0],), (n,), mesh)[0]


def _gate(want, floor, spec, mesh, base: float, b0=None) -> float:
    """``base``, or with a floor run min(``base``, the floor's SQNR at
    the same slice (of the change from ``b0``) - ``FLOOR_MARGIN_DB``)."""
    if floor is None:
        return base
    f = shd.take_shard(floor, spec, mesh).float().numpy()
    w = want.float().numpy()
    if b0 is not None:
        w, f = w - b0, f - b0
    return min(base, _sqnr_db(w, f) - FLOOR_MARGIN_DB)


def _check_blocks(want_tree, got, specs, mesh, bitwise: bool, before=None,
                  floor=None, min_db: float = MIN_DB):
    for si, seg in enumerate(want_tree):
        for li, layer in enumerate(seg):
            for k, v in layer.items():
                spec = specs[si][li][k]
                w = shd.take_shard(v, spec, mesh)
                g = got[si][li][k]
                if bitwise:
                    assert torch.equal(_bits(w), _bits(g)), (si, li, k)
                    continue
                fl = None if floor is None else floor[si][li][k]
                assert _sqnr_db(w.float().numpy(), g.float().numpy()) >= \
                    _gate(w, fl, spec, mesh, min_db), (si, li, k)
                if before is not None:  # a pool: its change from the input
                    b0 = shd.take_shard(before[si][li][k], spec, mesh)
                    if torch.equal(_bits(w), _bits(b0)):
                        assert torch.equal(_bits(g), _bits(b0)), k
                        continue
                    b0 = b0.float().numpy()
                    assert _sqnr_db(w.float().numpy() - b0,
                                    g.float().numpy() - b0) >= _gate(
                        w, fl, spec, mesh, REF_DB, b0), (si, li, k)


def _results(world2, world4, mesh):
    if mesh in W2:
        res, jobs = world2
        return res, jobs
    res, jobs, _ = world4
    return res, jobs


CASES = [(k, m) for k, ms in MATRIX.items() for m in ms]


@pytest.mark.parametrize("key,mesh", CASES,
                         ids=[f"{a}-{q}-{m[0]}x{m[1]}" for (a, q), m in CASES])
def test_sharded_steps_against_one_device(world2, world4, cases, floors,
                                          key, mesh):
    arch, quant = key
    case, cfg = cases[key], R.config(arch)
    one = case["one"]
    floor = floors.get((arch, quant, mesh[1]))
    res, jobs = _results(world2, world4, mesh)
    job = next(j for j in jobs if j[:3] == (mesh, arch, quant))
    for rank in range(mesh[0] * mesh[1]):
        got = res[rank][job]
        assert "raised" not in got, got
        m = _mesh(mesh, rank)
        for step in job[3]:
            if step == "rowlin":
                continue
            g = got[step]
            want_ids, want_c = one[step]
            bitwise, min_db = quant == "cim", MIN_DB
            n = _seq_blocks(g["specs"], m) if step.startswith("fused") else 1
            if bitwise and n > 1:
                # bitwise the function the ranks compute; the plain
                # one-device step's own decode quantizes P per chunk of
                # the whole page
                b_ids, b_c = one[f"{step}@{n}"]
                assert torch.equal(g["ids"].long(), b_ids.long()), step
                _check_blocks(b_c, g["caches"], g["specs"], m, True)
                bitwise, min_db = False, REF_DB
            if step == "prefill":
                rows = _rows_of(g["batch_spec"], m, R.BATCH)
                specs = g["specs"]
            elif step in ("decode", "decode1"):
                rows = _rows_of(g["ids_spec"], m, want_ids.shape[0])
                specs = g["specs"]
            else:
                rows, specs = slice(None), g["specs"]
            _check_ids(case, cfg, quant, step, g["ids"], want_ids, rows)
            before = case["pools"][step] if step in ("paged", "fused",
                                                     "fused3") else None
            _check_blocks(want_c, g["caches"], specs, m, bitwise, before,
                          None if floor is None else floor[step][1], min_db)


def _seq_blocks(specs, mesh) -> int:
    """The blocks a fused pool's sequence is cut in (its first leaf's)."""
    return shd.shard_index(specs[0][0]["kv"], 1, mesh)[1]


@pytest.mark.parametrize("quant", R.QUANTS)
def test_group_of_one_bitwise_one_device(world4, cases, quant):
    res, _, jobs1 = world4
    job = next(j for j in jobs1 if j[2] == quant and len(j) == 4)
    got, one = res[0][job], cases["starcoder2-7b", quant]["one"]
    m = _mesh((1, 1), 0)
    for step in job[3]:
        assert torch.equal(got[step]["ids"].long(), one[step][0].long())
        _check_blocks(one[step][1], got[step]["caches"], got[step]["specs"],
                      m, bitwise=True)


@pytest.mark.parametrize("quant", FORMS)
def test_group_of_one_model_forms_bitwise(world4, cases, quant):
    """At (1, 1) with ``model_forms`` the row-parallel ``wo`` and ``w2``
    run C's f32 out (summed over one rank, rounded once) or A's pass sums
    (read out once), q, k and v are gathered and the head is
    vocab-parallel: bitwise the one-device steps."""
    res, _, jobs1 = world4
    job = next(j for j in jobs1 if j[2] == quant and len(j) == 7)
    got, one = res[0][job], cases["starcoder2-7b", quant]["one"]
    m = _mesh((1, 1), 0)
    for step in job[3]:
        assert "raised" not in got, got
        assert torch.equal(got[step]["ids"].long(), one[step][0].long())
        _check_blocks(one[step][1], got[step]["caches"], got[step]["specs"],
                      m, bitwise=True)


@pytest.mark.parametrize("quant", ("mxfp4_wonly", "cim"))
@pytest.mark.parametrize("mesh", ((1, 2), (2, 2), (1, 4)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_row_parallel_linear(world2, world4, cases, quant, mesh):
    case = cases["starcoder2-7b", quant]
    node = case["params"]["segments"][0][0]["ffn"]["w2"]
    want = linear_apply(RunCtx(quant=quant), node, case["x"])
    res, jobs = _results(world2, world4, mesh)
    job = next(j for j in jobs if j[:3] == (mesh, "starcoder2-7b", quant))
    for rank in range(mesh[0] * mesh[1]):
        got = res[rank][job]["rowlin"]
        if quant == "cim":  # integer pass sums: bitwise
            assert torch.equal(_bits(got), _bits(want))
        else:  # f32 partials, summed in another order, rounded once
            ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
            assert ((got.float() - want.float()).abs() <= ulp).all()


@pytest.mark.parametrize("key", REF_CASES, ids=lambda k: "-".join(k))
def test_reference_builders_against_port(world2, cases, ref_params, key):
    arch, quant = key
    jcfg, cfg = _jcfg(arch), R.config(arch)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    case = cases[("ref",) + key]
    inp = case["inp"]
    params = ref_params[key]
    res, jobs = world2
    job = next(j for j in jobs if len(j) > 5 and j[5] == ("ref",) + key)

    def compiled(b):
        return b.fn.lower(*b.args).compile(compiler_options=_NO_EXCESS)

    pb = jsteps.make_prefill_step(jcfg, jmesh, jconfigs.Shape(
        R.SEQ, R.BATCH, "prefill"), quant=quant)
    j_ids, j_caches = compiled(pb)(params, {k: v.numpy() for k, v in
                                            inp["batch"].items()})
    j_caches = jax.tree.map(np.asarray, j_caches)  # the decode donates
    db = jsteps.make_decode_step(jcfg, jmesh, jconfigs.Shape(
        R.SEQ, R.BATCH, "decode"), quant=quant)
    d_ids, d_caches = compiled(db)(params, j_caches, inp["ids"].numpy(),
                                   inp["pos"].numpy())
    want = {"prefill": (j_ids, j_caches), "decode": (d_ids, d_caches)}
    for step in ("paged", "fused") if key in FUSED else ("paged",):
        kb = jsteps.make_paged_decode_step(
            jcfg, jmesh, jconfigs.Shape(R.SEQ, R.BATCH, "decode"), R.SLOTS,
            quant=quant, kv_layout="legacy" if step == "paged" else "fused")
        pool_np = [{k: np.stack([_j(layer[k]) for layer in seg])
                    if len(seg) > 1 else _j(seg[0][k]) for k in seg[0]}
                   for seg in case["pools"][step]]
        want[step] = compiled(kb)(params, pool_np, inp["rows"].numpy(),
                                  inp["ids"].numpy(),
                                  inp["paged_pos"].numpy())
    for rank in (0, 1):
        got, m = res[rank][job], _mesh((1, 2), rank)
        for step, (ids, tree) in want.items():
            g = got[step]
            assert torch.equal(g["ids"].long(), torch.from_numpy(
                np.array(ids)).long()), step
            port = _to_port(jax.tree.map(np.asarray, tree), cfg)
            before = case["pools"][step] if step in ("paged", "fused") \
                else None
            for si, seg in enumerate(port):
                for li, layer in enumerate(seg):
                    for k, v in layer.items():
                        spec = g["specs"][si][li][k]
                        w = shd.take_shard(v, spec, m).float()
                        h = g["caches"][si][li][k].float()
                        if before is not None:
                            b0 = shd.take_shard(before[si][li][k], spec,
                                                m).float()
                            if torch.equal(w, b0):
                                continue
                            w, h = w - b0, h - b0
                        assert _sqnr_db(w.numpy(), h.numpy()) >= REF_DB, (
                            step, si, li, k)


def _j(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _formula_decode(cfg, quant: str, m: int, lanes: int) -> dict:
    """The model axis's collectives of one sharded decode step: (count,
    result bytes) by kind. All-gather: q|k|v a layer, [lanes, (H + 2 Hkv)
    Dh] bf16; the head's (value, index) pairs, [m, lanes, 2] f64.
    All-reduce (f32): the embedding [lanes, d]; a layer's softmax max
    [lanes, H], its sums [lanes, H], then the PV partials [lanes, H Dh]
    (the digital SDPA: the quantized P's sums with the PV partials
    [lanes, H (1 + Dh)]), ``wo`` and ``w2`` [lanes, d] (under ``cim``
    kernel A's two pass sums, int32 [2, lanes, d])."""
    L, d, h, kv, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.hd)
    dig = quant == "cim"
    gather = (L + 1, L * lanes * (h + 2 * kv) * hd * 2 + m * lanes * 2 * 8)
    rowpar = 2 * lanes * d * 4 * (2 if dig else 1)
    per_layer = lanes * h * 4 + lanes * h * (1 + hd) * 4 + rowpar
    if dig:
        per_layer += lanes * h * 4
    reduce = (1 + 5 * L, lanes * d * 4 + L * per_layer)
    return {"all-gather": gather, "all-reduce": reduce}


def _formula_prefill(cfg, quant: str, m: int, rows: int) -> dict:
    """The prefill's model-axis collectives: the embedding's, ``wo``'s and
    ``w2``'s sums [rows, S, d] f32 (under ``cim`` ``wo``'s and ``w2``'s
    pass sums, int32 [2, rows, S, d]); a layer's K and V gathered to every KV
    head, [rows, S, Hkv Dh] bf16 (one gather of both where the rank holds
    whole KV heads, else k and v each, gathered whole); the head's pairs."""
    L, d, kv, hd, s = (cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.hd,
                       R.SEQ)
    own = kv % m == 0
    per = 1 if own else 2
    kvb = rows * s * kv * hd * 2 * 2  # k and v, every head
    act = rows * s * d * 4
    rowpar = 2 * act * (2 if quant == "cim" else 1)
    return {"all-gather": (L * per + 1, L * kvb + m * rows * 2 * 8),
            "all-reduce": (1 + 2 * L, act + L * rowpar)}


@pytest.mark.parametrize("quant", ("none", "cim"))
@pytest.mark.parametrize("mesh", ((1, 2), (1, 4), (2, 2)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_collectives_formula(world2, world4, quant, mesh):
    cfg = R.config("starcoder2-7b")
    res, jobs = _results(world2, world4, mesh)
    job = next(j for j in jobs if j[:3] == (mesh, "starcoder2-7b", quant))
    got = res[0][job]
    lanes = R.BATCH // mesh[0]
    m = mesh[1]
    for step, want in (("decode", _formula_decode(cfg, quant, m, lanes)),
                       ("prefill", _formula_prefill(cfg, quant, m, lanes))):
        stats = got[step]["stats"]["model"]
        assert set(stats) == set(want), (step, stats)
        for kind, (n, nbytes) in want.items():
            count, wire, result = stats[kind]
            assert (count, result) == (n, nbytes), (step, kind, stats[kind])
            assert wire == pytest.approx(ring_wire_bytes(kind, nbytes, m))
        assert "data" not in got[step]["stats"], step


def _formula_fused(cfg, quant: str, m: int, lanes: int) -> dict:
    """The model axis's collectives of one fused paged step whose pool's
    sequence is cut over the model ranks: a layer's q|k|v gathered as the
    decode's, and its partials [m, lanes, Hkv, G, Dh + 1] f32 in one
    all-gather, the head's pairs; the embedding's, ``wo``'s and ``w2``'s
    sums (under ``cim`` their pass sums): 4 a layer + 2."""
    L, d, h, kv, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.hd)
    rowpar = 2 * lanes * d * 4 * (2 if quant == "cim" else 1)
    gather = (2 * L + 1, L * lanes * (h + 2 * kv) * hd * 2
              + L * m * lanes * h * (hd + 1) * 4 + m * lanes * 2 * 8)
    return {"all-gather": gather,
            "all-reduce": (1 + 2 * L, lanes * d * 4 + L * rowpar)}


@pytest.mark.parametrize("quant", [q for _, q in FUSED])
@pytest.mark.parametrize("mesh", ((1, 2), (1, 4), (2, 2)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_collectives_formula_fused(world2, world4, quant, mesh):
    """The fused paged step on the model meshes: the formula's counts and
    bytes (each rank decodes its lanes: at (2, 2) the lane whose row its
    data rank holds), the ring model's wire bytes."""
    cfg = R.config("starcoder2-7b")
    res, jobs = _results(world2, world4, mesh)
    job = next(j for j in jobs if j[:3] == (mesh, "starcoder2-7b", quant))
    stats = res[0][job]["fused"]["stats"]["model"]
    want = _formula_fused(cfg, quant, mesh[1], R.BATCH // mesh[0])
    assert set(stats) == set(want), stats
    for kind, (n, nbytes) in want.items():
        count, wire, result = stats[kind]
        assert (count, result) == (n, nbytes), (kind, stats[kind])
        assert wire == pytest.approx(ring_wire_bytes(kind, nbytes, mesh[1]))


def test_paged_ids_combined_over_data(world2, world4):
    """On a data axis the paged step's ids are summed over the data ranks
    (one all-reduce of [lanes] int64): each lane decoded once."""
    for res, jobs, mesh in ((world2[0], world2[1], (2, 1)),
                            (world4[0], world4[1], (2, 2))):
        job = next(j for j in jobs if j[:3] == (mesh, "starcoder2-7b",
                                                "none"))
        st = res[0][job]["paged"]["stats"]
        ids_bytes = R.BATCH * 8
        assert st["data"] == {"all-reduce": [
            1, ring_wire_bytes("all-reduce", ids_bytes, 2), ids_bytes]}


@pytest.mark.parametrize("name", sorted(RAISES))
def test_raises(world2, name):
    res, jobs = world2
    got = res[0][RAISES[name]]
    assert "raised" in got and "ROADMAP.md" in got["raised"], got
