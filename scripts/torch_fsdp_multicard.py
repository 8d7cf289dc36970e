"""The sharded train step on four cards: h2o-danube-1.8b at full width
and depth (``--layers`` cuts it), batch [8, 1024], FSDP parameters and
ZeRO-1 moments over a data axis of 4, one process a card over NCCL
(``launch.steps.make_train_step`` on ``make_local_mesh(4, 1)``).

1. Every rank builds its blocks (seed 0's init, cut) and its rows of each
   batch; the argument bytes it allocated are held to
   ``steps.args_bytes`` of the dry-run's bundle on the same mesh.
2. AdamW at lr 1, eps 1, no warmup (``OPT``). Step 1, then a blocking
   checkpoint of the sharded state (global arrays, rank 0 writes), then
   ``--steps`` - 1 more steps, each profiled on every rank: step wall
   ms, device ms, busy share (device over wall), peak GiB, the
   collectives by kind (count, result bytes, ring wire bytes) and the
   profiler's NCCL kernel time beside the wire bytes over 450 GB/s
   (NVLink each way).
3. The checkpoint restored onto 2 ranks and then onto 1 (reshard on
   load): each rank's blocks, gathered, bitwise the files.
4. On rank 0's card alone: the one-device step with k = 4 (the world)
   from the same init on step 1's batch against the 4-rank state after
   step 1 (each rank's rows are one of its microbatches): grad
   norm within 1e-6 relative, m >= 100 dB a leaf, every parameter within
   twice the step's largest update of its leaf, and each leaf's move
   from the init (p - p0) >= 100 dB against the one-device move.

Deterministic algorithms on (``CUBLAS_WORKSPACE_CONFIG`` set first). The
exit code is 1 if a check fails. Rank 0 writes the result to
``chiprun_out/fsdp_multicard.json`` (``--out``).

    torchrun --standalone --nproc_per_node 4 scripts/torch_fsdp_multicard.py
    torchrun --standalone --nproc_per_node 4 \
        scripts/torch_fsdp_multicard.py --cpu       # tiny width, gloo

``--standalone`` has torchrun pick a free port for its group. The groups
of 2 and 1 for the restores meet through a ``FileStore`` under
``build/fsdp_groups`` (one host; no socket); each join fails after
300 s.
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
OPT = adamw.AdamWConfig(lr=1.0, eps=1.0, warmup_steps=0)
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


def _batch(cfg, shape, step: int, k: int, world: int, rank: int, dev):
    return to_device(rank_rows(make_batch_np(cfg, shape, 0, step), k, world,
                               rank), dev)


def _profiled_step(bundle, params, state, batch, dev, cpu: bool):
    """One step: (params, state, metrics, a row of its figures)."""
    from torch.profiler import ProfilerActivity, profile

    before = {k: list(v) for k, v in bundle.collectives.by_kind.items()}
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
    wire = sum(c["wire_bytes"] for c in coll.values())
    row.update(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
               collectives=coll, wire_bytes=wire,
               link_ms_at_450GBs=wire / LINK_BW * 1e3)
    return params, state, met, row


def _restore_check(ckpt: str, cfg, shape, dense: int, world: int,
                   rank: int, cpu: bool) -> bool:
    """The step-1 checkpoint restored onto this group's ranks, gathered
    leaf by leaf and held bitwise to the files (rank 0's verdict)."""
    mesh = make_local_mesh(world, 1, device="cpu" if cpu else None)
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


def _one_device_check(ckpt: str, cfg, shape, dense: int, dev,
                      k: int) -> dict:
    """Rank 0's card alone: the one-device step with k microbatches (the
    sharded run's world) from seed 0's init on step 1's batch, against the
    sharded state after step 1."""
    params, _ = steps.param_structs(cfg, device=dev)
    # a copy: the step updates the parameters in place
    before = [t.detach().to("cpu", copy=True) for t in adamw.leaves(params)]
    one = steps.make_train_step(cfg, shape, OPT, quant="mxfp4_ste",
                                microbatches=k, device=dev,
                                dense_attn_max=dense)
    batch = to_device(make_batch_np(cfg, shape, 0, 0), dev)
    t0 = time.perf_counter()
    params, state, met = one.fn(params, adamw.init(params), batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    want = CheckpointManager(ckpt).restore(
        1, {"params": params, "opt": state}, device="cpu")
    m_db = min(_sqnr_db(a.detach().cpu(), b) for a, b in zip(
        adamw.leaves(state.m), adamw.leaves(want["opt"].m)))
    worst, move_db = 0.0, float("inf")
    for p, w, p0 in zip(adamw.leaves(params), adamw.leaves(want["params"]),
                        before):
        move = p.detach().cpu() - p0
        upd = float(move.abs().max())
        diff = float((p.detach().cpu() - w).abs().max())
        worst = max(worst, diff / (2 * upd + 1e-7))
        move_db = min(move_db, _sqnr_db(move, w - p0))
    with open(os.path.join(ckpt, "metrics_step1.json")) as f:
        sharded = json.load(f)
    gn = float(met["grad_norm"])
    return dict(wall_ms=wall, loss=float(met["loss"]),
                loss_sharded=sharded["loss"], grad_norm=gn,
                grad_norm_sharded=sharded["grad_norm"],
                grad_norm_rel=abs(gn - sharded["grad_norm"]) / gn,
                m_min_sqnr_db=m_db, param_diff_over_2upd=worst,
                move_min_sqnr_db=move_db,
                peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                          if dev.type == "cuda" else "not measured"))


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
                 "cuda": torch.version.cuda}
    mesh = make_local_mesh(world, 1, device="cpu" if args.cpu else None)
    pred = steps.make_train_step(cfg, make_local_mesh(world, 1, "meta"),
                                 shape, quant="mxfp4_ste", device="meta",
                                 dense_attn_max=dense)
    out["argument_bytes_predicted"] = steps.args_bytes(
        pred.args, pred.shardings, pred.mesh)
    del pred
    t0 = time.perf_counter()
    bundle = steps.make_train_step(cfg, mesh, shape, OPT,
                                   quant="mxfp4_ste", dense_attn_max=dense)
    out["build_s"] = time.perf_counter() - t0
    out["microbatches"] = k = bundle.microbatches
    out["argument_bytes_allocated"] = sum(
        t.numel() * t.element_size() for t in adamw.leaves(list(bundle.args)))
    params, state, _ = bundle.args
    rows = []
    ckpt = args.ckpt
    if rank == 0:  # no step of an earlier run: step 1 is written below
        shutil.rmtree(ckpt, ignore_errors=True)
    for i in range(args.steps):
        batch = _batch(cfg, shape, i, k, world, rank, dev)
        params, state, met, row = _profiled_step(bundle, params, state,
                                                 batch, dev, args.cpu)
        rows.append(row)
        if rank == 0:
            print(f"fsdp step {i + 1} rank 0 {json.dumps(row)}", flush=True)
        if i == 0:
            t0 = time.perf_counter()
            CheckpointManager(ckpt, keep=1).save(
                1, {"params": params, "opt": state}, blocking=True,
                shardings={"params": bundle.shardings[0],
                           "opt": bundle.shardings[1]}, mesh=mesh)
            out["save_s"] = time.perf_counter() - t0
            _progress(rank, "saved")
            if rank == 0:
                with open(os.path.join(ckpt, "metrics_step1.json"),
                          "w") as f:
                    json.dump({k2: float(v) for k2, v in met.items()}, f)
    timed = rows[1:] or rows
    out["steps"] = rows
    for key in ("wall_ms", "device_ms", "busy", "nccl_ms", "peak_gib",
                "link_ms_at_450GBs"):
        vals = [r[key] for r in timed if isinstance(r.get(key), float)]
        out[f"{key}_median"] = float(np.median(vals)) if vals else \
            "not measured"
    out["collectives_a_step"] = timed[-1]["collectives"]
    del params, state, bundle, met
    if not args.cpu:
        torch.cuda.empty_cache()
    # the checkpoint onto 2 ranks, then onto 1
    ok = {"argument_bytes": out["argument_bytes_allocated"]
          == out["argument_bytes_predicted"]}
    for w in (n for n in (2, 1) if n < world):
        init = _regroup(rank, args.cpu)
        if rank >= w:
            return 0
        world = w
        dev = _join(init, rank, w, args.cpu)
        t0 = time.perf_counter()
        ok[f"restore_{w}"] = _restore_check(ckpt, cfg, shape, dense, w, rank,
                                            args.cpu)
        out[f"restore_{w}_s"] = time.perf_counter() - t0
        _progress(rank, f"restored at {w}")
    dist.destroy_process_group()
    if not args.cpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    one = _one_device_check(ckpt, cfg, shape, dense, dev, out["world"])
    out["one_device"] = one
    ok["grad_norm"] = one["grad_norm_rel"] <= 1e-6
    ok["m"] = one["m_min_sqnr_db"] >= MIN_M_DB
    ok["params"] = one["param_diff_over_2upd"] <= 1.0
    ok["move"] = one["move_min_sqnr_db"] >= MIN_M_DB
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
    ap.add_argument("--steps", type=int, default=4)
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
