"""Dry-run: for every (arch x shape x mesh) cell, whether the step fits
and which roofline term bounds it, counted on the ``meta`` device with
nothing allocated (counterpart of the reference's ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --mesh single [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun.json

Every number is a prediction on the NVIDIA H100 SXM's constants
(``distributed.roofline``), not a measurement. Per cell:

- ``memory``: ``argument_bytes`` is exact, the per-device shard bytes of
  the step's arguments (parameters, optimizer state and batch, or
  parameters, caches, ids and pos) under their resolved specs.
  ``temp_bytes`` is the counter's peak of the bytes the step's ops hold
  beyond its arguments (``obs.cost``), from a ``meta`` run of the step as
  ``launch.steps`` builds it. On a mesh of more than one device that run
  is one device's microbatch at full width (its share of the batch, the
  weights unsplit): the port does not model tensor-parallel splitting, so
  ``temp_bytes`` is an upper bound there (``temp_bound`` says which).
  ``fits_80GB`` takes the place of the reference's ``fits_16GB``;
  ``output_bytes`` are the whole-step run's outputs (a train step's
  parameters and state are updated in place, so they are its
  arguments).
- the roofline terms and ``details`` from
  ``distributed.blockwise.analyze_cell`` (per device = global /
  n_devices), with ``wholegraph``: the terms of the whole-step ``meta``
  run. The reference composes blocks only on the single pod (its
  per-block compiles are slow); the port's count is cheap, so it composes
  on both meshes (``blockwise`` None).
- ``kernel_calls``: the hand-written kernels' calls by route in the
  whole-step run.

Left out against the reference: ``lower_s`` / ``compile_s`` (nothing is
compiled: ``build_s`` and ``count_s`` instead) and the collective terms
(the port has no partitioned HLO; ``t_collective_s`` is None).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch import configs as C
from repro_torch.distributed import roofline as rl
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.obs.cost import CostCounter, tensors

HBM_LIMIT = 80e9  # H100 80GB


def _per_device_shape(shape, mesh, k_micro: int):
    """One device's microbatch of ``shape`` on ``mesh``: the batch over
    the data axes where it divides, then over the microbatches."""
    dsz = steps_mod._data_size(mesh)
    b = shape.batch // dsz if shape.batch % dsz == 0 else shape.batch
    return C.Shape(shape.seq, max(1, b // k_micro), shape.kind)


def _whole_step(cfg, shape, mesh, kw: dict, k_micro: int):
    """The step's ``meta`` run: (its counter, its outputs' bytes)."""
    run_mesh, run_shape, run_kw = mesh, shape, dict(kw)
    if mesh.size > 1:
        run_mesh = make_local_mesh(1, 1, device="meta")
        run_shape = _per_device_shape(shape, mesh, k_micro)
        if shape.kind == "train":
            run_kw["microbatches"] = 1
    bundle = steps_mod.make_step(cfg, run_mesh, run_shape, device="meta",
                                 **run_kw)
    with CostCounter() as counter:
        out = bundle.fn(*bundle.args)
        out_bytes = sum(t.numel() * t.element_size() for t in tensors(out))
        del out
    return counter, out_bytes


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             quant: str | None = None, verbose: bool = True,
             overrides: dict | None = None, blockwise: bool | None = None,
             mesh=None) -> dict:
    """One cell's prediction (see the module docstring). ``mesh`` defaults
    to the production mesh (``multi_pod``: 2x16x16, else 16x16);
    ``chip_smoke.py`` passes the one-card ``make_local_mesh(1, 1)``."""
    from repro_torch.distributed import blockwise as bw

    if blockwise is None:
        blockwise = True
    cfg = C.ARCHS[arch]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = C.SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    kw = {"quant": quant} if quant else {}

    t0 = time.perf_counter()
    bundle = steps_mod.make_step(cfg, mesh, shape, device="meta", **kw)
    arg_bytes = steps_mod.args_bytes(bundle.args, bundle.shardings, mesh)
    k_micro = bundle.microbatches
    del bundle
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    counter, out_bytes = _whole_step(cfg, shape, mesh, kw, k_micro)
    whole = rl.roofline_terms({"flops": counter.flops,
                               "bytes accessed": counter.bytes}, None, 1)
    if blockwise:
        terms = bw.analyze_cell(cfg, shape, mesh, quant=quant,
                                k_micro=k_micro if shape.kind == "train"
                                else None)
        terms["wholegraph"] = {k: whole[k] for k in (
            "t_compute_s", "t_memory_s", "t_collective_s")}
    else:
        terms = dict(whole, per_device="one device's microbatch, weights "
                     "unsplit", k_micro=k_micro, details={})
    t_count = time.perf_counter() - t0
    temp = counter.peak
    mflops = rl.model_flops(cfg, shape)
    hlo_global = terms["hlo_flops_per_dev"] * n_dev
    result = {
        "arch": arch,
        "shape": shape_name if isinstance(shape_name, str) else "custom",
        "mesh": mesh.name,
        "n_devices": n_dev,
        "quant": kw.get("quant", "default"),
        "build_s": round(t_build, 1),
        "count_s": round(t_count, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "peak_bytes": arg_bytes + temp,
            "temp_bound": "exact" if n_dev == 1 else "upper",
            "fits_80GB": arg_bytes + temp < HBM_LIMIT,
        },
        "kernel_calls": counter.kernel_calls,
        "model_flops_global": mflops,
        "useful_flops_ratio": mflops / hlo_global if hlo_global else 0.0,
        "prediction": "H100 SXM constants; counted on meta, not measured",
        **terms,
    }
    if verbose:
        print(f"== {arch} x {result['shape']} x {result['mesh']} "
              f"(quant={result['quant']}) ==")
        print(f"  build {t_build:.1f}s count {t_count:.1f}s")
        print(f"  memory/dev: args {arg_bytes / 2**30:.2f} GiB"
              f" + temp {temp / 2**30:.2f} GiB ({result['memory']['temp_bound']})"
              f" -> fits80GB={result['memory']['fits_80GB']}")
        print(f"  flops/dev {terms['hlo_flops_per_dev']:.3e}"
              f"  bytes/dev {terms['hlo_bytes_per_dev']:.3e}"
              f"  ({terms['per_device']})")
        print(f"  t_compute {terms['t_compute_s'] * 1e3:.2f} ms"
              f"  t_memory {terms['t_memory_s'] * 1e3:.2f} ms"
              f"  dominant={terms['dominant']}"
              f"  MODEL/COUNTED={result['useful_flops_ratio']:.2f}"
              f"  k_micro={terms['k_micro']}")
    return result


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=C.ARCHS)
    ap.add_argument("--shape", default=None, choices=C.SHAPES)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--quant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch (and --shape) or --all")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for a, s in C.all_cells():
            for m in meshes:
                cells.append((a, s, m == "multi"))
    else:
        shapes = ([args.shape] if args.shape
                  else C.applicable_shapes(C.ARCHS[args.arch]))
        for s in shapes:
            for m in meshes:
                cells.append((args.arch, s, m == "multi"))

    t0 = time.perf_counter()
    results = []
    for a, s, mp in cells:
        try:
            results.append(run_cell(a, s, mp, quant=args.quant))
        except Exception as e:  # noqa: BLE001 - the sweep survives a cell
            traceback.print_exc()
            results.append({"arch": a, "shape": s,
                            "mesh": "2x16x16" if mp else "16x16",
                            "error": f"{type(e).__name__}: {e}"})
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    ok = sum(1 for r in results if "error" not in r)
    print(f"\n{ok}/{len(results)} cells counted in "
          f"{time.perf_counter() - t0:.1f} s")
    if ok < len(results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
