#!/usr/bin/env python3
"""Time the port's tuning choices on one NVIDIA GPU.

    python3 scripts/torch_kernel_sweep.py [SWEEP ...]   # from a checkout's root

with SWEEP among tc_splits, mma_splits, decode_split, mx_heads (default:
all of them).

- ``mxfp4_matmul``, tensor-core route: every static linear of
  starcoder2-7b at the served prefill length (M = 192), over the K split
  counts around the one ``pick_tc_splits`` picks; device time of the
  kernel and of the split-K sum, each against the picker's time model.
- ``mxfp4_matmul``, mma route: every static linear at the decode lanes
  (M = 4), 1, 2 and 4 warps side by side over a block's columns, over the
  K split counts around the one ``pick_mma`` picks.
- ``paged_decode`` (float pages): ``chip_smoke.py``'s pages at split
  widths 16, 32 and 64 keys; device time of the split and combine
  kernels.
- ``paged_decode_mx``: ``chip_smoke.py``'s pages at 1, 2, 3, 5 and 9 query
  heads a block.

One JSON object a line (``tc_splits {...}``, ``mma_splits {...}``,
``decode_split {...}``, ``mx_heads {...}``), the card's name and power
limit last. Device times come from
``torch.profiler`` as in ``chip_smoke.py``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _by_kernel(fn, reps: int) -> dict:
    """Device ms per call of each kernel that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for k, v in chip_smoke._device_kernels_ms(prof).items():
        name = k.removeprefix("void ").replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split("::")[-1]
        out[name] = out.get(name, 0.0) + v / reps
    return out


def sweep_tc_splits(dev) -> None:
    import chip_smoke
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.layers import backends

    gen = torch.Generator(device=dev).manual_seed(6)
    m = chip_smoke.M_PREFILL
    for k, n in chip_smoke.LINEAR_SHAPES:
        packed = backends._quantize_packed(
            torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        codes, exps = packed["codes"], packed["exps"]
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        picked = mm_ops.pick_tc_splits(m, k, n)
        nkt = k // mm_ops.TC_BK
        cands = sorted({s for s in (1, 2, 3, 4, 7, 12, 18, 24, 36,
                                    picked // 2, picked, 2 * picked)
                        if 1 <= s <= nkt})
        for splits in cands:
            ms = _by_kernel(lambda: mm_ops._launch(
                x, codes, exps, route="wgmma", tc_splits=splits), 10)
            print("tc_splits", json.dumps(
                {"m": m, "k": k, "n": n, "splits": splits,
                 "picked": splits == picked, "ms": sum(ms.values()),
                 "model_ms": mm_ops.tc_time_us(m, k, n, splits) / 1e3,
                 "by_kernel_ms": ms}), flush=True)


def sweep_mma_splits(dev) -> None:
    import chip_smoke
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.layers import backends

    gen = torch.Generator(device=dev).manual_seed(6)
    m = 4
    for k, n in chip_smoke.LINEAR_SHAPES:
        packed = backends._quantize_packed(
            torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        codes, exps = packed["codes"], packed["exps"]
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        picked = mm_ops.pick_mma(m, k, n)
        nkb = k // 32
        for wc in (1, 2, 4):
            cands = sorted({-(-nkb // -(-nkb // s)) for s in (
                1, 2, 3, 4, 6, 7, 9, 12, 18, 24, 36, picked[1] // 2,
                picked[1], 2 * picked[1]) if 1 <= s <= nkb})
            for splits in cands:
                ms = _by_kernel(lambda: mm_ops._launch(
                    x, codes, exps, route="mma", tc_splits=splits,
                    mma_layout=wc), 20)
                print("mma_splits", json.dumps(
                    {"m": m, "k": k, "n": n, "wc": wc, "splits": splits,
                     "blocks": -(-n // (mm_ops.MMA_BN * wc)) * splits,
                     "picked": (wc, splits) == picked,
                     "ms": sum(ms.values()), "by_kernel_ms": ms}),
                    flush=True)


def sweep_mx_heads(dev) -> None:
    import chip_smoke
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.paged_attention import layout
    from repro_torch.kernels.paged_attention import ops as pops

    (lanes, hkv, g, dh), pool = chip_smoke.DECODE_DIMS, 10
    gen = torch.Generator(device=dev).manual_seed(2)
    for w, lens in chip_smoke.PAGES:
        kv = (torch.randn((pool, w, 2 * hkv, dh), generator=gen, device=dev)
              * 0.7).to(torch.bfloat16)
        quant = layout.quant_page_full(*layout.split_kv(kv))
        q = mxlib.fake_quant((torch.randn((lanes, hkv, g, dh), generator=gen,
                                          device=dev) * 0.7).to(torch.bfloat16))
        rows = torch.tensor([7, 0, 3, 9], device=dev, dtype=torch.int32)
        lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
        for heads in (1, 2, 3, 5, 9):
            ms = _by_kernel(lambda: pops._launch_mx(
                q, quant, rows, lengths, dh ** -0.5, pops.pick_bk(w),
                heads=heads), 50)
            print("mx_heads", json.dumps(
                {"w": w, "lengths": lens, "heads": heads,
                 "blocks": lanes * hkv * -(-g // heads),
                 "picked": heads == pops.pick_heads(g),
                 "ms": sum(ms.values()), "by_kernel_ms": ms}), flush=True)


def sweep_decode_split(dev) -> None:
    import chip_smoke
    from repro_torch.kernels.paged_attention import ops as pops

    (lanes, hkv, g, dh), pool = chip_smoke.DECODE_DIMS, 10
    gen = torch.Generator(device=dev).manual_seed(7)
    for w, lens in chip_smoke.PAGES:
        kv = (torch.randn((pool, w, 2 * hkv, dh), generator=gen, device=dev)
              * 0.7).to(torch.bfloat16)
        q = (torch.randn((lanes, hkv, g, dh), generator=gen, device=dev)
             * 0.7).to(torch.bfloat16)
        rows = torch.tensor([7, 0, 3, 9], device=dev, dtype=torch.int32)
        lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
        for sw in pops.SPLIT_WIDTHS:
            ms = _by_kernel(lambda: pops._launch(
                q, kv, rows, lengths, dh ** -0.5, split_width=sw), 50)
            print("decode_split", json.dumps(
                {"w": w, "lengths": lens, "split_width": min(sw, w),
                 "picked": min(sw, w) == pops.pick_splits(w)[0],
                 "ms": sum(ms.values()), "by_kernel_ms": ms}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    _build.build_all(("mxfp4_matmul", "paged_decode", "paged_decode_mx"))
    dev = torch.device("cuda")
    only = set(sys.argv[1:])  # sweep names to run (default: all)
    for name, fn in (("tc_splits", sweep_tc_splits),
                     ("mma_splits", sweep_mma_splits),
                     ("decode_split", sweep_decode_split),
                     ("mx_heads", sweep_mx_heads)):
        if not only or name in only:
            fn(dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
