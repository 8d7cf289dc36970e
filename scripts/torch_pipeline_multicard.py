"""The stage-parallel pipeline on a grid of several cards, one card a
grid place (a grid over cards runs eagerly), through the launcher's own
``--stages`` / ``--mesh`` paths:

- 8-layer starcoder2-7b ``cim`` over four stages (``serve.main``): the
  logits' ``parity`` with the one-card forward;
- ViT-L/32 ``cim`` over two stages: logits bitwise the two-chip chain on
  the first card;
- ViT-B/16 ``mxfp4`` on a 2 x 2 grid: logits bitwise the same function at
  the same rows a launch (the slab embedded whole, each one-frame
  microbatch's trunk alone) on the first card.

Each prints the grid, the transfer guard (resident trunk, the hops) and
the measured walls; the exit code is 1 if a check fails. Needs four CUDA
devices (``--cpu``: the same at the tiny width, every grid place on the
host):

    python3 scripts/torch_pipeline_multicard.py
    python3 scripts/torch_pipeline_multicard.py --cpu
"""

import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch import obs as obs_lib  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import vit  # noqa: E402
from repro_torch.serving import VisionEngine  # noqa: E402


def _sqnr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.to(ref.device).double()
    err = float(((ref - got) ** 2).sum())
    return float("inf") if err == 0 else float(
        10 * torch.log10((ref * ref).sum() / err))


def lm_check(extra: list) -> bool:
    out = serve.main(extra + ["--layers", "8", "--backend", "cim",
                              "--stages", "4", "--microbatches", "2",
                              "--batch", "4", "--prompt-len", "192",
                              "--log-level", "warning"])
    runner, rep = out["runner"], out["report"]
    sq = _sqnr_db(out["ref"], out["logits"])
    print("lm", {"parity": out["parity"], "sqnr_db": sq,
                 "captured": runner.graphs is not None,
                 "devices": [str(d) for d in runner.mesh.devices[0]],
                 "resident": runner.trunk_resident(),
                 "hops": runner.collectives(out["batch"]).by_kind,
                 "step_wall_ms": rep.step_wall_s * 1e3,
                 "stage_wall_ms": [w * 1e3 for w in rep.stage_walls_s],
                 "one_device_ms": out["base_wall_s"] * 1e3}, flush=True)
    return sq >= 60.0 and runner.trunk_resident()


def vit_check(extra: list, arch: str, backend: str, shape: list,
              graphs: bool) -> bool:
    args = serve.build_parser().parse_args(
        extra + ["--arch", arch, "--backend", backend, "--frames", "4",
                 "--calib-batches", "2", "--batch", "2",
                 "--log-level", "warning"] + shape)
    obs = obs_lib.Obs()
    cfg, params, ctx, _ = serve.build_vision_model(args, obs=obs)
    summ = serve.serve_vision(args, cfg, params, ctx, obs,
                              params["pos"].device)
    runner, frames = summ["runner"], summ["images"]
    kctx = dataclasses.replace(ctx, obs=None)
    with torch.no_grad():
        piped = runner.forward({"images": frames})
        if runner.n_replicas == 1:  # the chip chain, one frame a call
            chain = VisionEngine(params, cfg, kctx, cuda_graphs=graphs)
            want = torch.cat([chain.logits(f[None]) for f in frames])
        else:
            x = vit.embed_images(kctx, cfg, params, frames)
            y = torch.cat([vit.encode(params["segments"][0], cfg, kctx,
                                      x[i:i + runner.mb_size])
                           for i in range(0, x.shape[0], runner.mb_size)])
            want = vit.head(kctx, cfg, params, y)
    bitwise = bool(torch.equal(piped.to(want.device), want))
    print(arch, backend, {
        "devices": [[str(d) for d in row] for row in runner.mesh.devices],
        "captured": runner.graphs is not None, "bitwise": bitwise,
        "resident": runner.trunk_resident(),
        "hops": runner.collectives({"images": frames}).by_kind,
        "measured": summ["measured"]}, flush=True)
    return bitwise and runner.trunk_resident()


def main() -> int:
    cpu = "--cpu" in sys.argv
    extra = ["--device", "cpu"] if cpu else ["--no-tiny"]
    if not cpu:
        from repro_torch.kernels import _build

        print("cards", torch.cuda.device_count(),
              torch.cuda.get_device_name(0), flush=True)
        print("build", _build.build_all(), flush=True)
    t0 = time.perf_counter()
    ok = [lm_check(extra),
          vit_check(extra, "vit-l32", "cim",
                    ["--stages", "2", "--microbatches", "4"], not cpu),
          vit_check(extra, "vit-b16", "mxfp4",
                    ["--mesh", "2x2", "--microbatches", "2"], not cpu)]
    print("multicard", {"ok": ok, "s": time.perf_counter() - t0}, flush=True)
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
