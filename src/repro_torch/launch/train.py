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
raises. ``--mesh single|multi`` name the reference's 256- and 512-chip
pod meshes, 16x16 and 2x16x16, whose model axis is 16 wide: the port's
sharded train step runs the data axes only (``launch.steps`` on a mesh
over a process group, ``scripts/torch_fsdp_multicard.py``), so they
raise ``NotImplementedError`` (``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch import configs as C
from repro_torch import resolve_device
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
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the pod mesh's model axis is 16 wide, and "
            "the sharded train step runs the data axes only (tensor "
            "parallelism over 'model' is not ported); see ROADMAP.md")
    device = resolve_device(args.device)
    cfg = C.ARCHS[args.arch]
    if args.tiny:
        cfg = C.tiny(cfg)
    shape = (C.SHAPES[args.shape] if args.shape
             else C.Shape(args.seq, args.batch, "train"))
    ctx = RunCtx(quant=args.quant, dense_attn_max=512)
    trainer = Trainer(cfg, shape,
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_dir=args.ckpt),
                      ctx=ctx, device=device)
    result = trainer.run()
    losses = result["losses"]
    if losses:
        print(f"final step {result['final_step']}, "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print(f"final step {result['final_step']}: {args.ckpt} already "
              f"holds step {trainer.start_step}")
    return dict(result, trainer=trainer)


if __name__ == "__main__":
    main()
