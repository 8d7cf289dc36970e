"""The sharded serving steps on four cards: starcoder2-7b at full width
(d 4608, 36 heads, 4 KV heads, d_ff 18432, vocab 49152), one process a
card over NCCL (``launch.steps.make_prefill_step``,
``make_decode_step`` and ``make_paged_decode_step`` on
``make_local_mesh(data, model)``), under ``mxfp4_wonly`` (32 layers) and
``cim`` (8 of 32: the Row-Hist calibration's time), on three meshes in
turn: (data, model) = (4, 1), (2, 2) and (1, 4).

1. Each rank builds the served model from seed 0 on its card (random
   weights, packed or calibrated and converted, as the launcher's
   ``build_backend`` does) and cuts its blocks of it
   (``steps.shard_params``: rank 0's calibration broadcast).
2. On each mesh: a prefill of [4, 2048] (seed 5's ids) into caches of
   2048, then 16 teacher-forced decode steps over them (seed 6's ids, at
   positions 2048..2063: the ring wraps onto slot 0..15), then one
   paged step over a random pool (4 lanes on rows 1, 6, 11, 14 of 16:
   12 request pages and a scratch row a lane, pages of 256) in the
   legacy and the fused layouts (the fused one: kernels B and D on the
   rank's rows at (4, 1), in their partial mode on its block of the
   sequence on the model meshes, the blocks' (o, lse) combined over the
   ranks), and on (4, 1) once more in the fused layout over a pool of 6
   request pages and 4 scratch rows (``fused10``: 10 rows, which do not
   divide the data axis, so the rules cut its sequence over ``data``;
   lanes on rows 1, 3, 5, 8). The prefill and the
   paged steps run twice (the first warms: the kernels' builds, NCCL's
   first calls), each decode step once. Wall ms on the host clock,
   synchronised: the second prefill, the median of decode steps 2-12
   (untraced) and of the last 4 (traced); device ms and NCCL kernel ms
   of the traced calls (``torch.profiler``, every rank); peak GiB
   (``max_memory_allocated`` over the sharded steps); the collectives by
   kind and axis a step (count, result bytes, ring wire bytes over the
   axis's group) beside their time at 450 GB/s (NVLink each way).
3. The reference: the one-device step bodies (``lm.forward`` /
   ``lm.decode_step``, the head, argmax) on the whole model, on each
   rank's own card (each rank holds its blocks against the same slice),
   fed the same ids. Checks: the prefill's ids equal; every decode
   step's cache blocks >= 30 dB against the one-device caches and its
   ids equal, or, where they differ, the one-device logit of the
   sharded pick within 2 bf16 ulps of the one-device top logit (a tie
   that the f32 sums' order breaks otherwise), each such lane reported
   with its top-2 margin; the paged step's ids equal and each pool
   leaf's change from its input >= 30 dB (an unchanged leaf bitwise).
   Where the model axis is larger than 1 under ``mxfp4``, the floor: the
   one-device prefill and decode steps again with ``wo``'s and ``w2``'s
   K cut as the model ranks cut it (:func:`split_k`: each slice's product
   in f32 by kernel C, summed and rounded once), the same function in
   another f32 order; its caches' SQNR against the one-device caches,
   step by step, and the cache gates are min(30, the floor - 3 dB).
4. The kernels' launches, a call (``launches``): the wrappers' counters
   zeroed before the timed prefill, the decode steps and each timed
   paged step and read after, with kernel C's f32-out, kernel A's
   pass-sums (the row-parallel linears' modes) and kernels D's and B's
   partial (the fused decode over ranks) launches apart.

The exit code is 1 if a check fails. Rank 0 writes the result to
``chiprun_out/serve_multicard.json`` (``--out``).

    torchrun --standalone --nproc_per_node 4 scripts/torch_serve_multicard.py
    torchrun --standalone --nproc_per_node 4 \\
        scripts/torch_serve_multicard.py --cpu      # tiny width, gloo

``--cpu`` runs the tiny starcoder2-7b at head_dim 32 and d_ff 128 (a
model rank of 4 keeps whole 32-blocks of ``wo`` and ``w2``), prompts
and pages of 128.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import configs as C  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.roofline import LINK_BW  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.layers.common import RunCtx  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.kvcache import gather_rows, scatter_rows  # noqa

ARCH = "starcoder2-7b"
WORLD = 4
MESHES = ((4, 1), (2, 2), (1, 4))
LAYERS = {"mxfp4": 32, "cim": 8}
QUANT = {"mxfp4": "mxfp4_wonly", "cim": "cim"}
LANES, PROMPT, DECODE_STEPS = 4, 2048, 16
SLOTS, PAGE = 12, 256  # the pool's rows: 16, four a data rank at (4, 1)
PAGED_ROWS = (1, 6, 11, 14)
# the fused10 pool on (4, 1): 10 rows, its sequence cut over the data axis
SLOTS10, PAGED_ROWS10 = 6, (1, 3, 5, 8)
MIN_DB = 30.0
FLOOR_MARGIN_DB = 3.0  # a cache may sit this far below its floor
TIE_ULPS = 2  # a lane whose pick is within this of the one-device max
PROFILED_STEPS = 4  # the last decode steps, traced; the others timed bare
JOIN_TIMEOUT_S = 300

T0 = time.perf_counter()


def _progress(rank: int, what: str) -> None:
    if rank == 0:
        print(f"serve multicard {what} at {time.perf_counter() - T0:.1f} s",
              flush=True)


def _smi() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _sqnr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    err = float(((ref - got) ** 2).sum())
    return float("inf") if err == 0 else float(
        10 * torch.log10((ref * ref).sum() / err))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def _host_copy(caches) -> list:
    """A copy of a cache tree on the host (a copy on the CPU too: the
    decode writes its caches in place)."""
    return [[{k: v.to("cpu", copy=True) for k, v in layer.items()}
             for layer in seg] for seg in caches]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _model(backend: str, args, dev):
    """(cfg, served params, run context): seed 0's init on ``dev``,
    converted as the launcher's ``build_backend`` converts it."""
    cfg = C.ARCHS[ARCH]
    if args.cpu:
        cfg = dataclasses.replace(C.tiny(cfg), head_dim=32, d_ff=128,
                                  n_layers=2)
    else:
        cfg = dataclasses.replace(cfg, n_layers=LAYERS[backend])
    largs = serve.build_parser().parse_args(
        ["--backend", backend, "--calib-batches", "2", "--batch", "2",
         "--prompt-len", "256" if not args.cpu else "64",
         "--log-level", "warning"])
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        fparams = lm.init_model(cfg, gen, device=dev)
        params, ctx = serve.build_backend(largs, cfg, fparams, dev,
                                          free_float=True)
    return cfg, params, dataclasses.replace(ctx, obs=None)


def _inputs(cfg, prompt: int, page: int, dev) -> dict:
    gen = torch.Generator(device=dev)

    def ids(seed, *shape):
        return torch.randint(0, cfg.vocab_size, shape,
                             generator=gen.manual_seed(seed),
                             dtype=torch.int32, device=dev)

    pool_gen = torch.Generator(device=dev).manual_seed(7)
    return {"prompt": ids(5, LANES, prompt),
            "teacher": ids(6, DECODE_STEPS, LANES, 1),
            "rows": torch.tensor(PAGED_ROWS, dtype=torch.int32, device=dev),
            "rows10": torch.tensor(PAGED_ROWS10, dtype=torch.int32,
                                   device=dev),
            "paged_ids": ids(8, LANES, 1),
            "paged_pos": torch.tensor([page * 3 // 4, 17, page - 1, 0],
                                      dtype=torch.int32, device=dev),
            "pool_gen": pool_gen}


def _random_pool(cfg, quant: str, fused: bool, page: int, gen, dev,
                 slots: int = SLOTS):
    pool = lm.init_cache(cfg, slots + LANES, page,
                         mx_digital=quant == "cim", fused=fused, device=dev)
    for t in _leaves(pool):
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) / 2)
        else:
            t.copy_(torch.randint(0, 16, t.shape, generator=gen, device=dev))
    return pool


def _ties(logits: torch.Tensor, want: torch.Tensor, got: torch.Tensor
          ) -> list:
    """Each lane where ``got`` differs from the one-device ``want``: its
    top-2 margin and whether the one-device logit of ``got`` is within
    ``TIE_ULPS`` bf16 ulps of the top one."""
    lf = logits.float()
    out = []
    for lane in torch.nonzero(want.long() != got.long())[:, 0].tolist():
        top = lf[lane].topk(2).values
        ulp = float(torch.finfo(torch.bfloat16).eps) * abs(float(top[0]))
        gap = float(top[0] - lf[lane, int(got[lane])])
        out.append({"lane": lane, "want": int(want[lane]),
                    "got": int(got[lane]),
                    "top2_margin": float(top[0] - top[1]),
                    "gap_to_pick": gap,
                    "within_ties": gap <= TIE_ULPS * ulp})
    return out


def _stats_delta(bundle, before: dict, steps_: int) -> dict:
    """The bundle's collectives since ``before`` (a snapshot of
    ``axis_collectives``), a call: by axis and kind [count, wire bytes,
    result bytes], and the wire bytes' time at 450 GB/s."""
    out = {}
    for axis, st in bundle.axis_collectives.items():
        kinds = {}
        for kind, (n, wire, nbytes) in st.by_kind.items():
            b0 = before.get(axis, {}).get(kind, [0, 0.0, 0.0])
            if n - b0[0]:
                kinds[kind] = {"count": (n - b0[0]) / steps_,
                               "wire_bytes": (wire - b0[1]) / steps_,
                               "bytes": (nbytes - b0[2]) / steps_}
        if kinds:
            wire = sum(k["wire_bytes"] for k in kinds.values())
            out[axis] = {"kinds": kinds, "ring_ms": wire / LINK_BW * 1e3}
    return out


def _snapshot(bundle) -> dict:
    return {a: {k: list(v) for k, v in st.by_kind.items()}
            for a, st in bundle.axis_collectives.items()}


def _profiled(fn, dev, cpu: bool):
    """(fn's result, wall ms, device ms, NCCL ms) of one call."""
    if cpu:
        t0 = time.perf_counter()
        res = fn()
        return res, (time.perf_counter() - t0) * 1e3, None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device = sum(e.self_device_time_total for e in events) / 1e3
    nccl = sum(e.self_device_time_total for e in events
               if "nccl" in e.key.lower()) / 1e3
    return res, wall, device, nccl


def _wrappers() -> dict:
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pops

    return {"cim_linear": cim_ops.cim_linear,
            "mxfp4_matmul": mm_ops.mxfp4_matmul,
            "paged_decode": pops.paged_flash_decode,
            "paged_decode_mx": pops.paged_flash_decode_mx,
            "flash_attention": fa_ops.flash_attention}


def _zero_counts() -> None:
    w = _wrappers()
    for fn in w.values():
        fn.launches = 0
    w["mxfp4_matmul"].f32_launches = 0
    w["cim_linear"].sums_launches = 0
    w["paged_decode"].partial_launches = 0
    w["paged_decode_mx"].partial_launches = 0


def _counts(calls: int) -> dict:
    """The wrappers' launches since :func:`_zero_counts`, a call; C's
    f32-out, A's pass-sums and D's and B's partial launches apart."""
    w = _wrappers()
    out = {k: fn.launches / calls for k, fn in w.items() if fn.launches}
    out["mxfp4_matmul f32"] = w["mxfp4_matmul"].f32_launches / calls
    out["cim_linear sums"] = w["cim_linear"].sums_launches / calls
    for k in ("paged_decode", "paged_decode_mx"):
        out[f"{k} partial"] = w[k].partial_launches / calls
    return out


@contextlib.contextmanager
def split_k(parts: int):
    """The one-device row-parallel linears (``wo``, ``w2``) with their K
    cut as ``parts`` model ranks cut it: each slice's product in f32
    (kernel C with f32 out on a packed weight, else the bf16 operands'
    f32 product), summed in slice order, rounded to bf16 once. A
    calibrated ``cim`` linear runs as it is (integer sums)."""
    from repro_torch.kernels.mxfp4_matmul.ops import mxfp4_matmul
    from repro_torch.layers import attention, common, ffn

    def row(ctx, params, x, name=None):
        if "e_n" in params:
            return common.linear_apply(ctx, params, x, name=name)
        ks = x.shape[-1] // parts
        acc = None
        for i in range(parts):
            xs = x[..., i * ks:(i + 1) * ks]
            if "codes" in params:
                part = mxfp4_matmul(
                    xs, params["codes"][i * ks // 2:(i + 1) * ks // 2],
                    params["exps"][i * ks // 32:(i + 1) * ks // 32],
                    out_dtype=torch.float32)
            else:
                w = params["w"][i * ks:(i + 1) * ks]
                part = (xs.to(torch.bfloat16).float()
                        @ w.to(torch.bfloat16).float())
            acc = part if acc is None else acc + part
        y = acc.to(torch.bfloat16)
        return y + params["b"].to(y.dtype) if "b" in params else y

    saved = attention.row_linear_apply, ffn.row_linear_apply
    attention.row_linear_apply = ffn.row_linear_apply = row
    try:
        yield
    finally:
        attention.row_linear_apply, ffn.row_linear_apply = saved


def _one_prefill(cfg, ctx, params, prompt, page):
    caches = lm.init_cache(cfg, prompt.shape[0], page, device=prompt.device)
    hidden, caches = lm.forward(params, cfg, ctx, {"ids": prompt},
                                caches=caches, return_hidden=True)
    logits = steps._prefill_logits(cfg, ctx, params, hidden[:, -1])
    return logits, caches


def _mesh_run(cfg, params, quant: str, mesh, inp: dict, page: int,
              paged_page: int, dev, cpu: bool) -> dict:
    """One mesh: the sharded steps and their checks against the one-device
    bodies on this card (see the module). ``page``: the prompt and the
    caches' length; ``paged_page``: the paged pool's."""
    data, model = mesh.sizes
    pre = C.Shape(page, LANES, "prefill")
    dec = C.Shape(page, LANES, "decode")
    pdec = C.Shape(paged_page, LANES, "decode")
    kw = dict(quant=quant, device="meta")
    pb = steps.make_prefill_step(cfg, mesh, pre, **kw)
    db = steps.make_decode_step(cfg, mesh, dec, **kw)
    p_pre, _ = steps.shard_params(cfg, mesh, params, "prefill")
    p_dec, _ = steps.shard_params(cfg, mesh, params, "decode",
                                  batch_size=LANES)
    prompt = shd.take_shard(inp["prompt"], pb.shardings[1]["ids"], mesh)
    ids_spec = db.shardings[2]
    layout = steps._cache_layout(db.shardings[1])
    p_layout = shd.resolve_with_divisibility(
        steps._cache_spec_tree(cfg),
        lm.init_cache(cfg, LANES, page, device="meta"),
        shd.make_ctx(cfg, mesh, "prefill"), mesh)
    if p_layout != layout:
        raise ValueError(f"{mesh.name}: the prefill's caches {p_layout} are "
                         f"not the decode's {layout}")
    row: dict = {"mesh": [data, model]}
    if not cpu:
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    pb.fn(p_pre, {"ids": prompt})  # warm
    before = _snapshot(pb)
    _zero_counts()
    (ids, caches), wall, device, nccl = _profiled(
        lambda: pb.fn(p_pre, {"ids": prompt}), dev, cpu)
    row["prefill"] = {"wall_ms": wall, "device_ms": device, "nccl_ms": nccl,
                      "collectives": _stats_delta(pb, before, 1),
                      "launches": _counts(1)}
    got_ids = {"prefill": ids.clone()}
    blocks = _host_copy(caches)
    step_blocks, dec_rows = [], []
    before = _snapshot(db)
    _zero_counts()
    for t in range(DECODE_STEPS):
        tid = shd.take_shard(inp["teacher"][t], ids_spec, mesh)
        pos = torch.tensor(page + t, dtype=torch.int32, device=dev)
        dist.barrier()
        if t >= DECODE_STEPS - PROFILED_STEPS:  # traced
            (nid, caches), wall, device, nccl = _profiled(
                lambda: db.fn(p_dec, caches, tid, pos), dev, cpu)
        else:  # host clock, synchronised
            _sync(dev)
            t0 = time.perf_counter()
            nid, caches = db.fn(p_dec, caches, tid, pos)
            _sync(dev)
            wall, device, nccl = (time.perf_counter() - t0) * 1e3, None, None
        dec_rows.append({"wall_ms": wall, "device_ms": device,
                         "nccl_ms": nccl})
        got_ids[t] = nid.clone()
        step_blocks.append(_host_copy(caches))
    row["decode"] = {
        "steps": dec_rows,
        "collectives": _stats_delta(db, before, DECODE_STEPS),
        "launches": _counts(DECODE_STEPS)}
    for key, rows_ in (("wall_ms", dec_rows[1:-PROFILED_STEPS]),
                       ("profiled_wall_ms", dec_rows[-PROFILED_STEPS:]),
                       ("device_ms", dec_rows), ("nccl_ms", dec_rows)):
        src = "wall_ms" if key.endswith("wall_ms") else key
        vals = sorted(r[src] for r in rows_ if r[src] is not None)
        row["decode"][f"{key}_median"] = vals[len(vals) // 2] if vals else None
    row["peak_gib"] = (None if cpu else
                       torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del caches
    # the paged step: legacy and fused on every mesh, fused10 on (4, 1)
    paged = {}
    for lay in ("legacy", "fused") + (("fused10",) if model == 1 else ()):
        slots = SLOTS10 if lay == "fused10" else SLOTS
        rows = inp["rows10" if lay == "fused10" else "rows"]
        kb = steps.make_paged_decode_step(
            cfg, mesh, pdec, slots,
            kv_layout="legacy" if lay == "legacy" else "fused", **kw)
        pool = _random_pool(cfg, quant, lay != "legacy", paged_page,
                            inp["pool_gen"].manual_seed(7), dev, slots)
        pl = steps._cache_layout(kb.shardings[1])
        warm = shd.take_shard_tree(pool, pl, mesh)  # builds, first calls
        kb.fn(p_dec, warm, rows, inp["paged_ids"], inp["paged_pos"])
        del warm
        mine = shd.take_shard_tree(pool, pl, mesh)
        before = _snapshot(kb)
        dist.barrier()
        _zero_counts()
        (pid, mine), wall, device, nccl = _profiled(
            lambda: kb.fn(p_dec, mine, rows, inp["paged_ids"],
                          inp["paged_pos"]), dev, cpu)
        paged[lay] = {"ids": pid.clone(), "pool": mine, "layout": pl,
                      "input": pool, "rows": rows,
                      "row": {"wall_ms": wall, "device_ms": device,
                              "nccl_ms": nccl,
                              "collectives": _stats_delta(kb, before, 1),
                              "launches": _counts(1)}}
    row["paged"] = {lay: v["row"] for lay, v in paged.items()}
    # the one-device reference on this card
    ctx = RunCtx(quant=quant)
    checks: dict = {}
    floor = model > 1 and quant == "mxfp4_wonly"
    with torch.no_grad():
        logits, ref = _one_prefill(cfg, ctx, params, inp["prompt"], page)
        fl_ref = None
        if floor:
            with split_k(model):
                fl_ref = _one_prefill(cfg, ctx, params, inp["prompt"],
                                      page)[1]
            checks["floor_prefill_cache_db"] = _min_db(
                ref, shd.take_shard_tree(fl_ref, layout, mesh), layout,
                mesh)
        want = torch.argmax(logits.float(), -1)
        want_rows = shd.take_shard(want, pb.shardings[1]["ids"][:1], mesh)
        checks["prefill_ids"] = bool(torch.equal(want_rows.long(),
                                                 got_ids["prefill"].long()))
        checks["prefill_disagree"] = _ties(
            shd.take_shard(logits, pb.shardings[1]["ids"][:1], mesh),
            want_rows, got_ids["prefill"])
        checks["prefill_cache_db"] = _min_db(ref, blocks, layout, mesh)
        worst, disagree, floors = [], [], []
        for t in range(DECODE_STEPS):
            pos = torch.tensor(page + t, dtype=torch.int32, device=dev)
            lg, ref = lm.decode_step(params, cfg, ctx,
                                     inp["teacher"][t].long(), pos, ref)
            if floor:
                with split_k(model):
                    fl_ref = lm.decode_step(params, cfg, ctx,
                                            inp["teacher"][t].long(), pos,
                                            fl_ref)[1]
                floors.append(_min_db(
                    ref, shd.take_shard_tree(fl_ref, layout, mesh), layout,
                    mesh))
            w = shd.take_shard(torch.argmax(lg.float(), -1), ids_spec[:1],
                               mesh)
            ties = _ties(shd.take_shard(lg, ids_spec[:1], mesh), w,
                         got_ids[t])
            disagree += [dict(d, step=t) for d in ties]
            worst.append(_min_db(ref, step_blocks[t], layout, mesh))
        checks["decode_cache_db_by_step"] = worst
        checks["decode_disagree"] = disagree
        if floor:
            checks["floor_decode_cache_db_by_step"] = floors
        del ref, step_blocks, fl_ref
        for lay, v in paged.items():
            pool = v["input"]
            fused = lay != "legacy"
            specs = lm.cache_specs(cfg, mx_digital=quant == "cim",
                                   fused=fused)
            before_pool = [[{k: t.clone() for k, t in layer.items()}
                            for layer in seg] for seg in pool]
            rows = v["rows"].long()
            pos = inp["paged_pos"].long()
            pids = inp["paged_ids"].long()
            if fused:
                lg, _ = lm.decode_step(params, cfg, dataclasses.replace(
                    ctx, paged_rows=rows), pids, pos, pool)
            else:
                caches = gather_rows(pool, specs, rows)
                lg, caches = lm.decode_step(params, cfg, ctx, pids, pos,
                                            caches)
                scatter_rows(pool, specs, rows, caches)
            pw = torch.argmax(lg.float(), -1)
            checks[f"paged_{lay}_ids"] = bool(torch.equal(
                pw.long(), v["ids"].long()))
            checks[f"paged_{lay}_disagree"] = _ties(lg, pw, v["ids"])
            checks[f"paged_{lay}_change_db"] = _change_db(
                before_pool, pool, v["pool"], v["layout"], mesh)
    row["checks"] = checks
    def gate(fl):
        return MIN_DB if fl is None else min(MIN_DB, fl - FLOOR_MARGIN_DB)

    ok = {
        "prefill_ids": checks["prefill_ids"],
        "prefill_cache": checks["prefill_cache_db"] >= gate(
            checks.get("floor_prefill_cache_db")),
        "decode_cache": all(
            db >= gate(floors[t] if floors else None)
            for t, db in enumerate(checks["decode_cache_db_by_step"])),
        "decode_ids": all(d["within_ties"] for d in disagree)}
    for lay in paged:
        ok[f"paged_{lay}_ids"] = all(
            d["within_ties"] for d in checks[f"paged_{lay}_disagree"])
        ok[f"paged_{lay}_change"] = checks[f"paged_{lay}_change_db"] >= MIN_DB
    row["ok"] = ok
    return row


def _min_db(ref, blocks, layout, mesh) -> float:
    """The least SQNR of this rank's blocks (on the host) against the same
    slices of the one-device caches ``ref``."""
    worst = float("inf")
    for seg_r, seg_b, seg_s in zip(ref, blocks, layout):
        for lr, lb, ls in zip(seg_r, seg_b, seg_s):
            for k, v in lr.items():
                want = shd.take_shard(v, ls[k], mesh)
                got = lb[k].to(want.device)
                worst = min(worst, _sqnr_db(want.float(), got.float()))
    return worst


def _change_db(before, ref, got, layout, mesh) -> float:
    """The least SQNR of each pool leaf's change from its input in this
    rank's blocks against the one-device change (an unchanged leaf must
    be bitwise, else -inf)."""
    worst = float("inf")
    for sb, sr, sg, ss in zip(before, ref, got, layout):
        for lb, lr, lg, ls in zip(sb, sr, sg, ss):
            for k in lr:
                b0 = shd.take_shard(lb[k], ls[k], mesh).float()
                want = shd.take_shard(lr[k], ls[k], mesh).float() - b0
                have = lg[k].float() - b0
                if not want.any():
                    if have.any():
                        return float("-inf")
                    continue
                worst = min(worst, _sqnr_db(want, have))
    return worst


def run(rank: int, world: int, args) -> int:
    cpu = args.cpu
    kw = dict(rank=rank, world_size=world, init_method="env://",
              timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    if cpu:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", **kw)
        dev = torch.device("cpu")
    else:
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", **kw)
        dev = torch.device("cuda", local)
    prompt = 128 if cpu else PROMPT
    page_paged = 128 if cpu else PAGE
    out: dict = {"card": "cpu (gloo)" if cpu else _smi(), "arch": ARCH,
                 "world": world, "lanes": LANES, "prompt": prompt,
                 "decode_steps": DECODE_STEPS, "paged_page": page_paged,
                 "paged_slots": SLOTS, "python": sys.version.split()[0],
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "backends": {}}
    ok: dict = {}
    for backend in ("mxfp4", "cim"):
        t0 = time.perf_counter()
        cfg, params, _ = _model(backend, args, dev)
        inp = _inputs(cfg, prompt, page_paged, dev)
        res = {"layers": cfg.n_layers, "build_s": time.perf_counter() - t0,
               "meshes": {}}
        _progress(rank, f"built {backend}")
        for data, model in MESHES:
            mesh = make_local_mesh(data, model,
                                   device="cpu" if cpu else None)
            name = f"{data}x{model}"
            row = _mesh_run(cfg, params, QUANT[backend], mesh, inp, prompt,
                            page_paged, dev, cpu)
            rows = [None] * world
            dist.all_gather_object(rows, row)
            res["meshes"][name] = {"rank0": rows[0], "ranks": rows}
            for r, rr in enumerate(rows):
                for k, v in rr["ok"].items():
                    ok[f"{backend}_{name}_{k}_rank{r}"] = v
            _progress(rank, f"ran {backend} {name}")
        out["backends"][backend] = res
        del params
        if not cpu:
            torch.cuda.empty_cache()
    out["ok"] = ok
    out["all_ok"] = all(ok.values())
    if rank == 0:
        print(f"serve multicard {json.dumps(out)}", flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    dist.barrier()
    dist.destroy_process_group()
    return 0 if out["all_ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="tiny width, gloo ranks on the CPU")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "serve_multicard.json"))
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_serve_multicard: CUDA is not available (--cpu for the "
              "CPU)", file=sys.stderr)
        return 2
    if "RANK" not in os.environ:
        print("torch_serve_multicard: run it under torchrun --standalone "
              f"--nproc_per_node {WORLD}", file=sys.stderr)
        return 2
    return run(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), args)


if __name__ == "__main__":
    sys.exit(main())
