"""Training launcher for the port (the reference's
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch h2o-danube-1.8b --tiny --steps 20 --seq 64 --batch 4 \\
        --device cpu

``--mesh none`` (the default) runs the fault-tolerant ``Trainer`` on one
device: ``lm_loss`` under ``--quant`` (default ``mxfp4_ste``, the
per-linear fake-quant) with ``dense_attn_max=512``, AdamW, async
checkpoints in ``--ckpt`` (resumed from when it holds one). Runs on CUDA
unless ``--device cpu`` is given; without a GPU and without it, it
raises. ``--mesh single|multi`` build the reference's 256- and 512-chip
pod meshes, 16x16 and 2x16x16 (``launch.mesh.make_production_mesh``),
over the process group (torchrun's, joined here from its environment
where none is initialised: NCCL on CUDA, gloo on the CPU), one rank a
device, and run the sharded ``Trainer`` on ``launch.steps``'s train step
there: FSDP and ZeRO-1 over the data axes, tensor parallelism over the
16-wide model axis. A group of any other size raises ``ValueError``
naming the ranks the mesh needs; a config the model axis does not cover
raises ``NotImplementedError`` (``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import os

import torch.distributed as dist

from repro_torch import configs as C
from repro_torch import resolve_device
from repro_torch.distributed.mesh import make_group_mesh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.layers.common import RunCtx
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b", choices=C.ARCHS)
    ap.add_argument("--shape", default=None, choices=C.SHAPES,
                    help="named shape, e.g. train_4k")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU smoke)")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--quant", default="mxfp4_ste")
    ap.add_argument("--ckpt", default=str(CKPT_DIR),
                    help="checkpoint directory (resumed from if it holds "
                         "one)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Run the launcher; returns the trainer's result (``final_step``,
    ``preempted``, ``slow_steps``, ``losses``) and the ``trainer``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = C.ARCHS[args.arch]
    if args.tiny:
        cfg = C.tiny(cfg)
    shape = (C.SHAPES[args.shape] if args.shape
             else C.Shape(args.seq, args.batch, "train"))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt)
    if args.mesh != "none":
        trainer = Trainer(cfg, shape, tcfg, bundle=steps.make_train_step(
            cfg, _pod_mesh(args.mesh, device), shape, quant=args.quant,
            dense_attn_max=512))
    else:
        ctx = RunCtx(quant=args.quant, dense_attn_max=512)
        trainer = Trainer(cfg, shape, tcfg, ctx=ctx, device=device)
    result = trainer.run()
    losses = result["losses"]
    if losses:
        print(f"final step {result['final_step']}, "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print(f"final step {result['final_step']}: {args.ckpt} already "
              f"holds step {trainer.start_step}")
    return dict(result, trainer=trainer)


def _pod_mesh(name: str, device):
    """The reference's pod mesh ``name`` (``single``: 16x16, ``multi``:
    2x16x16) over the process group, one rank a device."""
    pod = make_production_mesh(multi_pod=name == "multi")
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise ValueError(
                f"--mesh {name} runs over a process group of {pod.size} "
                "ranks, one a device (torchrun --nproc_per_node ...)")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_group_mesh(pod.axis_names, pod.sizes,
                           device="cpu" if device.type == "cpu" else None)


if __name__ == "__main__":
    main()
