"""The sharded train step on four cards: h2o-danube-1.8b at full width
and depth (``--layers`` cuts it), batch [8, 1024], one process a card
over NCCL (``launch.steps.make_train_step`` on
``make_local_mesh(data, model)``), on three meshes in turn: (data,
model) = (4, 1) (FSDP parameters and ZeRO-1 moments over a data axis of
4), (2, 2) and (1, 4) (tensor parallelism over heads, mlp and vocab on
the model axis, FSDP and ZeRO-1 over what data axis is left).

1. On each mesh every rank builds its blocks (seed 0's init, cut) and
   its rows of each batch; the argument bytes it allocated are held to
   ``steps.args_bytes`` of the dry-run's bundle on the same mesh.
2. AdamW at lr 1, eps 1, no warmup, no weight decay (``OPT``). Step 1, whose global
   parameters and m rank 0 keeps on the host; on (2, 2) a blocking
   checkpoint of the sharded state (global arrays, rank 0 writes); then
   ``--steps`` - 1 more steps, each profiled on every rank: step wall
   ms, device ms, busy share (device over wall), peak GiB, the
   collectives by kind and by axis (count, result bytes, ring wire bytes
   over that axis's group) and the profiler's NCCL kernel time beside
   the wire bytes over 450 GB/s (NVLink each way).
3. The (2, 2) checkpoint restored onto (4, 1), onto (1, 4) and then onto
   one rank (reshard on load): each rank's blocks, gathered, bitwise the
   files.
4. On rank 0's card alone: the one-device step with k = 4 (the world)
   from the same init on step 1's batch (the reference), and again with
   k = 8 (the floor: the same function, its sums in another order).
   Each mesh's state after step 1 is held to the reference. (4, 1),
   whose ranks' rows are the one-device microbatches: grad norm within
   1e-6 relative, m >= 100 dB a leaf, every parameter within twice the
   step's largest update of its leaf, and each leaf's move from the
   init (p - p0) >= 100 dB against the one-device move. (2, 2) and
   (1, 4), whose sums over the model ranks run in another order:
   ``tests/test_torch_tp.py``'s gates (loss and grad norm within 1e-3
   relative, parameters within twice the update + 1e-7), and each
   leaf's m and move >= 40 dB or, where the floor run itself is below
   40 + ``FLOOR_MARGIN_DB`` at that leaf, >= its floor (its SQNR against
   the reference) less that margin. Each mesh takes k = 4 / data
   microbatches (``--k`` sets one k for all), so each rank's
   microbatch is one of the one-device step's and the two differ in
   the order of their sums only. Without weight decay a move follows
   the leaf's gradient (at lr 1 a decay of 0.1 p would hide it).

Deterministic algorithms on (``CUBLAS_WORKSPACE_CONFIG`` set first). The
exit code is 1 if a check fails. ``--no-ckpt`` leaves out the checkpoint
(2's save and 3). Rank 0 writes the result to
``chiprun_out/fsdp_multicard.json`` (``--out``).

    torchrun --standalone --nproc_per_node 4 scripts/torch_fsdp_multicard.py
    torchrun --standalone --nproc_per_node 4 \
        scripts/torch_fsdp_multicard.py --cpu       # tiny width, gloo

    torchrun --standalone --nproc_per_node 4 \
        scripts/torch_fsdp_multicard.py --steps 3 --no-ckpt   # shorter

``--standalone`` has torchrun pick a free port for its group. The group
of 1 for the last restore meets through a ``FileStore`` under
``build/fsdp_groups`` (one host; no socket); its join fails after 300 s.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import shutil
import sys
import time
import uuid
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import configs as C  # noqa: E402
from repro_torch.checkpoint.ckpt import (  # noqa: E402
    CheckpointManager,
    flatten,
)
from repro_torch.data.pipeline import (  # noqa: E402
    make_batch_np,
    rank_rows,
    to_device,
)
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.collectives import MeshComm  # noqa: E402
from repro_torch.distributed.mesh import data_rank  # noqa: E402
from repro_torch.distributed.roofline import LINK_BW  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "h2o-danube-1.8b"
WORLD = 4
DENSE_MAX = 512  # phase 14's: the prefill past it is the torch-op flash
MIN_M_DB = 100.0  # m and each leaf's move against the one-device step
# Adam's first update is g / (|g| + eps): at eps 1 it follows g, so the
# moves can be compared (at eps 1e-8 it is lr * sign(g), which flips
# wherever g is near 0); phase 14c's settings
OPT = adamw.AdamWConfig(lr=1.0, eps=1.0, warmup_steps=0, weight_decay=0.0)
JOIN_TIMEOUT_S = 300  # a group that does not form fails the run
GROUPS = ROOT / "build" / "fsdp_groups"  # the FileStores of the groups


T0 = time.perf_counter()


def _progress(rank: int, what: str) -> None:
    if rank == 0:
        print(f"fsdp {what} at {time.perf_counter() - T0:.1f} s", flush=True)


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


def _config(args):
    cfg = C.ARCHS[ARCH]
    if args.cpu:
        return C.tiny(cfg), C.Shape(64, 8, "train"), 16
    return (dataclasses.replace(cfg, n_layers=args.layers),
            C.Shape(1024, 8, "train"), DENSE_MAX)


def _join(store: str, rank: int, world: int, cpu: bool) -> torch.device:
    """Join a group of ``world`` ranks: torchrun's (``env://``) or one
    through a ``FileStore`` at ``store`` (every rank on this host), for
    the restores."""
    kw = dict(rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    if store == "env://":
        kw["init_method"] = store
    else:
        kw["store"] = dist.FileStore(store, world)
    if cpu:
        dist.init_process_group("gloo", **kw)
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", **kw)
    return torch.device("cuda", local)


def _new_store() -> str:
    """A fresh ``FileStore`` path under ``build/fsdp_groups``."""
    GROUPS.mkdir(parents=True, exist_ok=True)
    return str(GROUPS / f"store_{uuid.uuid4().hex}")


def _regroup(rank: int, cpu: bool) -> str:
    """A fresh store for the next group, from rank 0 to all (over the
    current group), which is then left."""
    box = [_new_store() if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    if not cpu:
        torch.cuda.synchronize()
    dist.destroy_process_group()
    return box[0]


def _batch(cfg, shape, step: int, k: int, data: int, rank: int, dev):
    """Data rank ``rank``'s rows (of ``data``) of step ``step``'s batch."""
    return to_device(rank_rows(make_batch_np(cfg, shape, 0, step), k, data,
                               rank), dev)


def _profiled_step(bundle, params, state, batch, dev, cpu: bool):
    """One step: (params, state, metrics, a row of its figures)."""
    from torch.profiler import ProfilerActivity, profile

    before = {k: list(v) for k, v in bundle.collectives.by_kind.items()}
    before_axis = {a: {k: list(v) for k, v in st.by_kind.items()}
                   for a, st in bundle.axis_collectives.items()}
    if cpu:
        t0 = time.perf_counter()
        params, state, met = bundle.fn(params, state, batch)
        wall = (time.perf_counter() - t0) * 1e3
        row = dict(wall_ms=wall, device_ms="not measured")
    else:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, met = bundle.fn(params, state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        nccl = sum(e.self_device_time_total for e in events
                   if "nccl" in e.key.lower()) / 1e3
        row = dict(wall_ms=wall, device_ms=dev_ms, busy=dev_ms / wall,
                   nccl_ms=nccl,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    coll = {}
    for kind, (n, wire, byts) in bundle.collectives.by_kind.items():
        n0, w0, b0 = before.get(kind, [0, 0.0, 0.0])
        coll[kind] = {"count": n - n0, "bytes": byts - b0,
                      "wire_bytes": wire - w0}
    axes = {}
    for axis, st in bundle.axis_collectives.items():
        for kind, (n, wire, byts) in st.by_kind.items():
            n0, w0, b0 = before_axis.get(axis, {}).get(kind, [0, 0.0, 0.0])
            axes.setdefault(axis, {})[kind] = {
                "count": n - n0, "bytes": byts - b0, "wire_bytes": wire - w0,
                "link_ms_at_450GBs": (wire - w0) / LINK_BW * 1e3}
    wire = sum(c["wire_bytes"] for c in coll.values())
    row.update(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
               collectives=coll, by_axis=axes, wire_bytes=wire,
               link_ms_at_450GBs=wire / LINK_BW * 1e3)
    return params, state, met, row


MESHES = ((4, 1), (2, 2), (1, 4))
SAVE_AT = (2, 2)  # the mesh whose step-1 state is checkpointed
TP_DB, TP_REL = 40.0, 1e-3  # the model axis's gates (tests/test_torch_tp.py)
# a model mesh's leaf may sit this far below the floor run's SQNR where
# that is under TP_DB + this: a leaf gradient 10% off reads 20 dB
FLOOR_MARGIN_DB = 3.0
FLOOR_K = 8  # the floor run's microbatches


def _restore_check(ckpt: str, cfg, shape, dense: int, mesh, rank: int
                   ) -> bool:
    """The step-1 checkpoint restored onto ``mesh``'s ranks, gathered
    leaf by leaf and held bitwise to the files (rank 0's verdict)."""
    b = steps.make_train_step(cfg, mesh, shape, quant="mxfp4_ste",
                              dense_attn_max=dense)
    template = {"params": b.args[0], "opt": b.args[1]}
    shardings = {"params": b.shardings[0], "opt": b.shardings[1]}
    mgr = CheckpointManager(ckpt)
    got = mgr.restore(1, template, shardings=shardings, mesh=mesh)
    del b, template
    comm = MeshComm(mesh)
    with open(os.path.join(ckpt, "step_00000001", "MANIFEST.json")) as f:
        manifest = json.load(f)["leaves"]
    ok = True
    for (key, t), spec in zip(flatten(got).items(),
                              shd.spec_leaves(got, shardings)):
        whole = comm.gather_leaf(t, spec, shd.global_shape(spec, t.shape,
                                                           mesh))
        if rank == 0:
            arr = np.load(os.path.join(ckpt, "step_00000001",
                                       manifest[key]["file"]))
            host = whole.detach().cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            ok &= bool(np.array_equal(host.numpy(), arr))
        del whole
    return ok


def _host_state(mesh, bundle, params, state, rank: int) -> dict | None:
    """The global parameters and m after a step, on rank 0's host (every
    rank takes part in the gathers)."""
    comm = MeshComm(mesh)
    out = {"params": [], "m": []}
    for name, tree, specs in (("params", params, bundle.shardings[0]),
                              ("m", state.m, bundle.shardings[1].m)):
        for t, spec in zip(adamw.leaves(tree), shd.spec_leaves(tree, specs)):
            whole = comm.gather_leaf(t, spec, shd.global_shape(
                spec, t.shape, mesh))
            if rank == 0:
                out[name].append(whole.detach().to("cpu", copy=True))
            del whole
    return out if rank == 0 else None


def _one_device(cfg, shape, dense: int, dev, k: int) -> dict:
    """Rank 0's card alone: the one-device step with k microbatches from
    seed 0's init on step 1's batch. Its parameters and m after the step,
    and the init, on the host; its metrics."""
    params, _ = steps.param_structs(cfg, device=dev)
    # a copy: the step updates the parameters in place
    before = [t.detach().to("cpu", copy=True) for t in adamw.leaves(params)]
    one = steps.make_train_step(cfg, shape, OPT, quant="mxfp4_ste",
                                microbatches=k, device=dev,
                                dense_attn_max=dense)
    batch = to_device(make_batch_np(cfg, shape, 0, 0), dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, met = one.fn(params, adamw.init(params), batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    row = {"k": k, "wall_ms": (time.perf_counter() - t0) * 1e3,
           "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if dev.type == "cuda" else "not measured")}
    host = {"params": [p.detach().to("cpu", copy=True)
                       for p in adamw.leaves(params)],
            "m": [m.to("cpu", copy=True) for m in adamw.leaves(state.m)],
            "met": {"loss": row["loss"], "grad_norm": row["grad_norm"]},
            "before": before, "row": row}
    del one, params, state, met
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return host


def _against(ref: dict, got: dict, dev) -> dict:
    """``got`` (a state after step 1 on the host) held to ``ref`` (the
    one-device reference), leaf by leaf on the card: loss and grad norm
    relative, each leaf's m and move SQNR, each parameter's distance over
    twice the step's largest update of its leaf."""
    worst, m_db, move_db = 0.0, [], []
    for p, m, w, wm, p0 in zip(ref["params"], ref["m"], got["params"],
                               got["m"], ref["before"]):
        p, m, w, wm, p0 = (t.to(dev) for t in (p, m, w, wm, p0))
        move = p - p0
        upd = float(move.abs().max())
        worst = max(worst, float((p - w).abs().max()) / (2 * upd + 1e-7))
        m_db.append(_sqnr_db(m, wm))
        move_db.append(_sqnr_db(move, w - p0))
    loss, gn = ref["met"]["loss"], ref["met"]["grad_norm"]
    return dict(loss=got["met"]["loss"],
                loss_rel=abs(got["met"]["loss"] - loss) / loss,
                grad_norm=got["met"]["grad_norm"],
                grad_norm_rel=abs(got["met"]["grad_norm"] - gn) / gn,
                param_diff_over_2upd=worst, m_db=m_db, move_db=move_db)


def _one_device_check(cfg, shape, dense: int, dev, k: int,
                      sharded: dict) -> dict:
    """The one-device reference (k microbatches, the sharded runs'
    world) against each mesh's state after step 1 (``sharded``: name ->
    host state and step-1 metrics) and against the floor run (k =
    ``FLOOR_K``); the model meshes' per-leaf gates from the floor."""
    paths = list(flatten(steps.param_structs(cfg, device="meta")[0]))
    ref = _one_device(cfg, shape, dense, dev, k)
    out = dict(ref["row"])
    floor_run = _one_device(cfg, shape, dense, dev, FLOOR_K)
    floor = _against(ref, floor_run, dev)
    out["floor"] = dict(floor_run["row"])
    del floor_run
    gates = {w: [min(TP_DB, f - FLOOR_MARGIN_DB) for f in floor[f"{w}_db"]]
             for w in ("m", "move")}
    for name, got in {"floor": None, **sharded}.items():
        r = floor if got is None else _against(ref, got, dev)
        row = out.setdefault(name, {})
        row.update({k2: v for k2, v in r.items()
                    if k2 not in ("m_db", "move_db")})
        for w in ("m", "move"):
            dbs = r[f"{w}_db"]
            i = dbs.index(min(dbs))
            over = [d - g for d, g in zip(dbs, gates[w])]
            j = over.index(min(over))
            row.update({f"{w}_min_sqnr_db": dbs[i], f"{w}_min_leaf": paths[i],
                        f"{w}_floor_at_min_db": floor[f"{w}_db"][i],
                        f"{w}_min_over_gate_db": over[j],
                        f"{w}_min_over_gate_leaf": paths[j]})
    return out


def _mesh_run(cfg, shape, dense: int, data: int, model: int, rank: int,
              dev, args, out: dict, ckpt: str):
    """One mesh's steps (module docstring, 1-2): its figures into
    ``out``; rank 0's host copy of the step-1 state, returned."""
    name = f"{data}x{model}"
    mesh = make_local_mesh(data, model, device="cpu" if args.cpu else None)
    pred = steps.make_train_step(cfg, make_local_mesh(data, model, "meta"),
                                 shape, quant="mxfp4_ste", device="meta",
                                 dense_attn_max=dense)
    row: dict = {"argument_bytes_predicted": steps.args_bytes(
        pred.args, pred.shardings, pred.mesh)}
    del pred
    t0 = time.perf_counter()
    # k = world / data: each rank's microbatch is one of the one-device
    # k = world step's (rows and their order), so the two differ in the
    # order of their sums only (--k sets one k for every mesh)
    bundle = steps.make_train_step(cfg, mesh, shape, OPT, quant="mxfp4_ste",
                                   microbatches=args.k or WORLD // data,
                                   dense_attn_max=dense)
    row["build_s"] = time.perf_counter() - t0
    row["microbatches"] = k = bundle.microbatches
    row["argument_bytes_allocated"] = sum(
        t.numel() * t.element_size() for t in adamw.leaves(list(bundle.args)))
    params, state, _ = bundle.args
    rows, host = [], None
    for i in range(args.steps):
        batch = _batch(cfg, shape, i, k, data, data_rank(mesh), dev)
        params, state, met, prow = _profiled_step(bundle, params, state,
                                                  batch, dev, args.cpu)
        rows.append(prow)
        if rank == 0:
            print(f"fsdp {name} step {i + 1} rank 0 {json.dumps(prow)}",
                  flush=True)
        if i == 0:
            host = _host_state(mesh, bundle, params, state, rank)
            if rank == 0:
                host["met"] = {k2: float(v) for k2, v in met.items()}
            if (data, model) == SAVE_AT and not args.no_ckpt:
                t0 = time.perf_counter()
                CheckpointManager(ckpt, keep=1).save(
                    1, {"params": params, "opt": state}, blocking=True,
                    shardings={"params": bundle.shardings[0],
                               "opt": bundle.shardings[1]}, mesh=mesh)
                row["save_s"] = time.perf_counter() - t0
                _progress(rank, f"saved at {name}")
    timed = rows[1:] or rows
    row["steps"] = rows
    for key in ("wall_ms", "device_ms", "busy", "nccl_ms", "peak_gib",
                "link_ms_at_450GBs"):
        vals = [r[key] for r in timed if isinstance(r.get(key), float)]
        row[f"{key}_median"] = float(np.median(vals)) if vals else \
            "not measured"
    row["collectives_a_step"] = timed[-1]["collectives"]
    row["collectives_by_axis_a_step"] = timed[-1]["by_axis"]
    out["meshes"][name] = row
    del params, state, bundle, met
    if not args.cpu:
        torch.cuda.empty_cache()
    return host


def run(rank: int, world: int, init: str, args) -> int:
    torch.use_deterministic_algorithms(True)
    if args.cpu:
        torch.set_num_threads(1)
    dev = _join(init, rank, world, args.cpu)
    cfg, shape, dense = _config(args)
    out: dict = {"card": "cpu (gloo)" if args.cpu else _smi(),
                 "arch": cfg.name, "layers": cfg.n_layers, "seq": shape.seq,
                 "batch": shape.batch, "world": world,
                 "python": sys.version.split()[0], "torch": torch.__version__,
                 "cuda": torch.version.cuda, "meshes": {}}
    ckpt = args.ckpt
    if rank == 0:  # no step of an earlier run: step 1 is written below
        shutil.rmtree(ckpt, ignore_errors=True)
    hosts, ok = {}, {}
    for data, model in MESHES:
        name = f"{data}x{model}"
        hosts[name] = _mesh_run(cfg, shape, dense, data, model, rank, dev,
                                args, out, ckpt)
        row = out["meshes"][name]
        ok[f"argument_bytes_{name}"] = (row["argument_bytes_allocated"]
                                        == row["argument_bytes_predicted"])
        _progress(rank, f"ran {name}")
    # the (2, 2) checkpoint onto (4, 1) and (1, 4), then onto one rank
    for data, model in (m for m in MESHES
                        if m != SAVE_AT and not args.no_ckpt):
        t0 = time.perf_counter()
        mesh = make_local_mesh(data, model, device="cpu" if args.cpu
                               else None)
        ok[f"restore_{data}x{model}"] = _restore_check(
            ckpt, cfg, shape, dense, mesh, rank)
        out[f"restore_{data}x{model}_s"] = time.perf_counter() - t0
        _progress(rank, f"restored at {data}x{model}")
    init = _regroup(rank, args.cpu)
    if rank:
        return 0
    if not args.no_ckpt:
        dev = _join(init, 0, 1, args.cpu)
        t0 = time.perf_counter()
        ok["restore_1"] = _restore_check(
            ckpt, cfg, shape, dense,
            make_local_mesh(1, 1, device="cpu" if args.cpu else None), 0)
        out["restore_1_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
    if not args.cpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    one = _one_device_check(cfg, shape, dense, dev, world, hosts)
    del hosts
    out["one_device"] = one
    for name, r in ((n, one[n]) for n in out["meshes"]):
        tight = name == "4x1"
        ok[f"loss_{name}"] = r["loss_rel"] <= (1e-6 if tight else TP_REL)
        ok[f"grad_norm_{name}"] = r["grad_norm_rel"] <= (
            1e-6 if tight else TP_REL)
        ok[f"params_{name}"] = r["param_diff_over_2upd"] <= 1.0
        for w in ("m", "move"):
            ok[f"{w}_{name}"] = (r[f"{w}_min_sqnr_db"] >= MIN_M_DB if tight
                                 else r[f"{w}_min_over_gate_db"] >= 0)
    out["ok"] = ok
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(GROUPS, ignore_errors=True)
    print(f"fsdp multicard {json.dumps(out)}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if all(ok.values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="tiny width, gloo ranks on the CPU")
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--no-ckpt", action="store_true",
                    help="leave out the checkpoint's save and restores")
    ap.add_argument("--k", type=int, default=None,
                    help="microbatches a step on every mesh (default: the "
                         "world over the data axis, each rank's microbatch "
                         "one of the one-device step's)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "fsdp_multicard.json"))
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "fsdp_ckpt"),
                    help="checkpoint directory, shared by the ranks; "
                         "emptied first, removed at the end")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_fsdp_multicard: CUDA is not available (--cpu for the "
              "CPU)", file=sys.stderr)
        return 2
    if "RANK" not in os.environ:
        print("torch_fsdp_multicard: run it under torchrun --standalone "
              f"--nproc_per_node {WORLD}", file=sys.stderr)
        return 2
    return run(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
               "env://", args)


if __name__ == "__main__":
    sys.exit(main())
