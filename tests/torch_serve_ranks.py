"""The ranks' side of ``tests/test_torch_serve_sharded.py``: each function
runs in a spawned gloo rank (``torch_dist.spawn``), builds the sharded
prefill, decode and paged decode steps (``launch.steps``) for the tiny
dense and vlm configs on the CPU over a (data, model) mesh, runs them on
this rank's blocks of the test's served trees and inputs, and returns its
blocks of the results with their specs. No JAX here: the ranks import
the port only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from pathlib import Path

import torch

from repro_torch import configs as C
from repro_torch.distributed import seq_parallel as spl
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.layers.common import convert_params_mxfp4
from repro_torch.models import calibrate, lm

# the floor's K split, as the four-card script runs it
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from torch_serve_multicard import split_k  # noqa: E402

ARCHS = ("starcoder2-7b", "h2o-danube-1.8b", "gemma3-1b", "qwen2-vl-7b")
QUANTS = ("none", "mxfp4_wonly", "cim")
SEQ, BATCH = 128, 2  # the prompt, the caches' length and the lanes
PREFILL = C.Shape(SEQ, BATCH, "prefill")
DECODE = C.Shape(SEQ, BATCH, "decode")
DECODE1 = C.Shape(SEQ, 1, "decode")  # one lane: the sequence on data too
SLOTS = 2  # the paged pool: SLOTS + BATCH rows of SEQ
# a fused pool of SLOTS3 + BATCH = 3 rows: they do not divide a data axis
# of 2, so the decode rules cut its sequence over the data axes
SLOTS3 = 1
# a fused pool of pages of ODD_PAGE: a block of 24 slots at model 2, not
# whole 32-blocks (the digital SDPA raises)
ODD_PAGE = 48
BLOCKS = (2, 4)  # the sequence blocks of the meshes' fused pools
ROWS = (1, 2)  # a lane a pool row: on both data ranks of a 2-way data axis
MIN_N = 32  # packing and calibration gate at the tiny width


def config(arch: str, d_ff: int = 128):
    """The tiny ``arch`` at head_dim 32 (the fused Q dim 128: a model rank
    of 4 keeps a whole 32-block of ``wo``'s K), d_ff 128 and a window of
    64 (a local layer's cache of 64 slots beside a global one's 128)."""
    cfg = C.tiny(C.ARCHS[arch])
    return dataclasses.replace(cfg, head_dim=32, d_ff=d_ff,
                               window=64 if cfg.window else 0)


def inputs(cfg) -> dict:
    """The prefill batch, the decode step's ids and position, and the
    paged step's rows, ids and positions (seed 1)."""
    batch = C.concrete_inputs(cfg, PREFILL, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    return {"batch": batch,
            "ids": torch.randint(0, cfg.vocab_size, (BATCH, 1),
                                 generator=gen, dtype=torch.int32),
            "pos": torch.tensor(SEQ, dtype=torch.int32),
            "rows": torch.tensor(ROWS, dtype=torch.int32),
            "paged_pos": torch.tensor([SEQ - 7, 40], dtype=torch.int32)}


def served(cfg, quant: str) -> dict:
    """Seed 0's init served under ``quant``: as it is (``none``), packed
    (``mxfp4_wonly``) or calibrated and converted (``cim``), at
    ``MIN_N``."""
    params, _ = steps.param_structs(cfg, device="cpu")
    if quant == "mxfp4_wonly":
        return convert_params_mxfp4(params, min_n=MIN_N)
    if quant == "cim":
        batches = calibrate.calibration_batches(cfg, n_batches=2, batch=2,
                                                seq=32, device="cpu")
        params, _ = calibrate.convert_model_cim(
            params, cfg, steps.RunCtx(), batches, min_n=MIN_N)
    return params


def random_pool(cfg, quant: str, fused: bool = False, slots: int = SLOTS,
                page: int = SEQ):
    """A paged pool of random values (seed 3): K/V normal, the quantized
    mirrors' codes and exponents small integers."""
    mx = quant == "cim"
    pool = lm.init_cache(cfg, slots + BATCH, page, mx_digital=mx,
                         fused=fused, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for seg in pool:
        for layer in seg:
            for v in layer.values():
                if v.is_floating_point():
                    v.copy_(torch.randn(v.shape, generator=gen) * 0.5)
                else:
                    v.copy_(torch.randint(0, 16, v.shape, generator=gen))
    return pool


def _row0(caches):
    """The first lane of a cache tree (the batch is dim 0 of every leaf)."""
    return [[{k: v[:1].clone() for k, v in layer.items()} for layer in seg]
            for seg in caches]


class _Keep:
    """A rank's collectives with the ranks' partials kept: its all-gather
    returns the rank's own and records it (``seq_blocks``)."""

    def __init__(self):
        self.got = None

    def all_gather(self, x, dim=0):
        self.got = x
        return x


@contextlib.contextmanager
def seq_blocks(n: int):
    """The one-device fused decode run as ``n`` ranks run it on a sequence
    cut in ``n`` blocks: each block's row write and partial (o, lse) by
    ``seq_parallel.fused_decode`` on that block of the pool (a view), the
    partials combined in block order (``combine_partials``), the same
    code and the same values as the ranks'."""
    whole = spl.fused_decode

    def blocked(ctx, cfg, q, k, v, cache, pos, mx_dig, shard=None,
                partial=False):
        wl = cache["kv"].shape[1] // n
        parts = []
        for r in range(n):
            view = {name: t.narrow(1, r * (wl // 32 if name == "v_exps"
                                           else wl),
                                   wl // 32 if name == "v_exps" else wl)
                    for name, t in cache.items()}
            keep = _Keep()
            whole(ctx, cfg, q, k, v, view, pos, mx_dig,
                  spl.SeqShard(keep, n, r))
            parts.append(keep.got)
        full = torch.cat(parts, 0)
        return spl.combine_partials(
            full[..., :-1], full[..., -1],
            torch.bfloat16 if mx_dig else cache["kv"].dtype)[:, None]

    spl.fused_decode = blocked
    try:
        yield
    finally:
        spl.fused_decode = whole


def one_device(cfg, quant: str, params, inp: dict, pools: dict,
               caches=None, blocks: tuple = ()) -> dict:
    """The one-device bundles' results on ``params`` and ``inp``: prefill,
    one decode step over the prefill's caches (or over ``caches``), the
    same for its first lane alone (``decode1``), and the paged step over
    a copy of each of ``pools`` (``paged``: legacy; ``fused``,
    ``fused3``), each fused one also with its sequence in each of
    ``blocks`` (``fused@2``: :func:`seq_blocks`)."""
    out = {}
    one = make_local_mesh(1, 1, device="cpu")  # outside a group: one device
    pb = steps.make_prefill_step(cfg, one, PREFILL, quant=quant,
                                 device="cpu")
    out["prefill"] = pb.fn(params, inp["batch"])
    caches = out["prefill"][1] if caches is None else caches
    db = steps.make_decode_step(cfg, one, DECODE, quant=quant, device="cpu")
    out["decode"] = db.fn(params, _clone(caches), inp["ids"], inp["pos"])
    db1 = steps.make_decode_step(cfg, one, DECODE1, quant=quant,
                                 device="cpu")
    out["decode1"] = db1.fn(params, _row0(caches), inp["ids"][:1],
                            inp["pos"])
    for name, pool in pools.items():
        kb = steps.make_paged_decode_step(
            cfg, one, DECODE, pool_slots(name), quant=quant,
            kv_layout="legacy" if name == "paged" else "fused",
            device="cpu")
        out[name] = kb.fn(params, _clone(pool), inp["rows"], inp["ids"],
                          inp["paged_pos"])
        for n in blocks if name != "paged" else ():
            with seq_blocks(n):
                out[f"{name}@{n}"] = kb.fn(params, _clone(pool), inp["rows"],
                                           inp["ids"], inp["paged_pos"])
    return out


def pool_slots(name: str) -> int:
    """The request pages of the pool ``name`` (``paged``, ``fused``,
    ``fused3``)."""
    return SLOTS3 if name == "fused3" else SLOTS


def floor(arch: str, quant: str, case: dict, parts: int) -> dict:
    """:func:`one_device` on ``case`` under ``split_k`` (the one-device
    row-parallel linears with their K cut as ``parts`` model ranks cut
    it, each slice's f32 product summed and rounded once:
    ``scripts/torch_serve_multicard.py``), its decode steps over the
    one-device prefill's caches (as the sharded ones)."""
    cfg = config(arch)
    with split_k(parts):
        return one_device(cfg, quant, case["params"], case["inp"],
                          case["pools"], case["caches"])


def case(arch: str, quant: str, params=None, fused3: bool = False) -> dict:
    """The global case of (arch, quant): the served tree (``params``, or
    :func:`served`'s), the inputs, the random pools (with ``fused3`` the
    3-row fused one too, and under ``cim`` the fused steps over
    ``BLOCKS`` blocks) and the one-device results."""
    cfg = config(arch)
    params = served(cfg, quant) if params is None else params
    inp = inputs(cfg)
    pools = {"paged": random_pool(cfg, quant),
             "fused": random_pool(cfg, quant, fused=True)}
    if fused3:
        pools["fused3"] = random_pool(cfg, quant, fused=True, slots=SLOTS3)
    one = one_device(cfg, quant, params, inp, pools,
                     blocks=BLOCKS if fused3 and quant == "cim" else ())
    return {"params": params, "inp": inp, "pools": pools,
            "caches": one["prefill"][1], "one": one}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if torch.is_tensor(tree) else tree


def _stats(bundle) -> dict:
    return {axis: {k: list(v) for k, v in st.by_kind.items()}
            for axis, st in bundle.axis_collectives.items() if st.count}


def sharded(cfg, quant: str, mesh, case: dict, steps_: tuple,
            forms: bool = False) -> dict:
    """This rank's results of the sharded steps named in ``steps_``
    (``prefill``, ``decode``, ``paged``, ``fused``, ``fused3``; ``fused_odd``
    only builds) on ``mesh`` (with
    ``forms``, the model axis's forms at model 1: ``model_forms``), from
    the global ``case`` (``params``, ``inp``, ``caches``: the one-device
    prefill's, ``pool``): each step's ids, its blocks and their specs."""
    out = {}
    params, inp = case.get("params"), case.get("inp")
    if "prefill" in steps_:
        b = steps.make_prefill_step(cfg, mesh, PREFILL, quant=quant,
                                    device="cpu", model_forms=forms)
        pp, _ = steps.shard_params(cfg, mesh, params, "prefill")
        batch = shd.take_shard_tree(inp["batch"], b.shardings[1], mesh)
        ids, caches = b.fn(pp, batch)
        out["prefill"] = {"ids": ids, "caches": caches,
                          "specs": prefill_layout(cfg, mesh),
                          "batch_spec": b.shardings[1]["ids"],
                          "stats": _stats(b)}
    if "decode" in steps_:
        b = steps.make_decode_step(cfg, mesh, DECODE, quant=quant,
                                   device="cpu", model_forms=forms)
        pp, _ = steps.shard_params(cfg, mesh, params, "decode",
                                   batch_size=BATCH)
        layout = steps._cache_layout(b.shardings[1])
        caches = shd.take_shard_tree(case["caches"], layout, mesh)
        ids = shd.take_shard(inp["ids"], b.shardings[2], mesh)
        got, caches = b.fn(pp, caches, ids, inp["pos"])
        out["decode"] = {"ids": got, "caches": caches, "specs": layout,
                         "ids_spec": b.shardings[2], "stats": _stats(b)}
    if "rowlin" in steps_:  # layer 0's w2, row-parallel, on case["x"]
        from repro_torch.distributed.collectives import MeshComm
        from repro_torch.layers.common import RunCtx, row_linear_apply

        specs = steps.serve_specs(cfg, params, mesh, "decode", BATCH)
        blk = shd.take_shard_tree(params["segments"][0][0]["ffn"]["w2"],
                                  specs["segments"][0][0]["ffn"]["w2"], mesh)
        comm = MeshComm(mesh)
        ctx = RunCtx(quant=quant, tp=comm.model)
        out["rowlin"] = row_linear_apply(
            ctx, blk, comm.model.block(case["x"], -1).contiguous())
    if "decode1" in steps_:
        b = steps.make_decode_step(cfg, mesh, DECODE1, quant=quant,
                                   device="cpu")
        pp, _ = steps.shard_params(cfg, mesh, params, "decode",
                                   batch_size=1)
        layout = steps._cache_layout(b.shardings[1])
        caches = shd.take_shard_tree(_row0(case["caches"]), layout, mesh)
        got, caches = b.fn(pp, caches, inp["ids"][:1], inp["pos"])
        out["decode1"] = {"ids": got, "caches": caches, "specs": layout,
                          "ids_spec": b.shardings[2], "stats": _stats(b)}
    if "fused_odd" in steps_:  # raises at build under the digital SDPA
        steps.make_paged_decode_step(
            cfg, mesh, C.Shape(ODD_PAGE, BATCH, "decode"), SLOTS,
            quant=quant, kv_layout="fused", device="cpu")
    for name in ("paged", "fused", "fused3"):
        if name not in steps_:
            continue
        b = steps.make_paged_decode_step(
            cfg, mesh, DECODE, pool_slots(name), quant=quant,
            kv_layout="legacy" if name == "paged" else "fused",
            device="cpu", model_forms=forms)
        pp, _ = steps.shard_params(cfg, mesh, params, "decode",
                                   batch_size=BATCH)
        layout = steps._cache_layout(b.shardings[1])
        pool = shd.take_shard_tree(case["pools"][name], layout, mesh)
        got, pool = b.fn(pp, pool, inp["rows"], inp["ids"],
                         inp["paged_pos"])
        out[name] = {"ids": got, "caches": pool, "specs": layout,
                     "stats": _stats(b)}
    return out


def prefill_layout(cfg, mesh) -> list:
    """The prefill's caches' resolved specs (the prefill rules)."""
    return shd.resolve_with_divisibility(
        steps._cache_spec_tree(cfg),
        lm.init_cache(cfg, BATCH, SEQ, device="meta"),
        shd.make_ctx(cfg, mesh, "prefill"), mesh)


def run(rank: int, world: int, jobs: list, cases: dict,
        store1: str | None = None, jobs1: list = ()) -> dict:
    """Each of ``jobs`` ((data, model), arch, quant, steps[, d_ff[, case
    key[, forms]]]) on a mesh over this group (``cases[arch, quant]``, or
    ``cases[key]``, its global case): this rank's
    :func:`sharded` results, keyed by the job; then, with ``store1``, rank
    0 alone in a group of one runs ``jobs1`` at (1, 1) (the others return
    what they have). A job that raises returns its exception's type and
    message."""
    out: dict = {}
    meshes: dict = {}

    def one(mesh_shape, arch, quant, steps_, d_ff=128, key=None,
            forms=False):
        if mesh_shape not in meshes:
            meshes[mesh_shape] = make_local_mesh(*mesh_shape, device="cpu")
        try:
            return sharded(config(arch, d_ff), quant, meshes[mesh_shape],
                           cases.get(key or (arch, quant), {}), steps_,
                           forms)
        except NotImplementedError as e:
            return {"raised": str(e)}

    for job in jobs:
        out[job] = one(*job)
    if store1 is None or rank:
        return out
    from torch_dist import regroup

    regroup(store1, 0, 1)
    meshes.clear()
    for job in jobs1:
        out[job] = one(*job)
    return out
