#!/usr/bin/env python3
"""Print the dry-run's per-cell table (markdown) from the JSON that
``python -m repro_torch.launch.dryrun --all --mesh both --out FILE``
writes: one row an arch, one column a shape.

    python3 scripts/torch_dryrun_table.py build/dryrun.json

A cell reads ``fits args+temp dom ratio kK / args+temp kK``: on the
single pod (16x16) whether the step fits in 80 GB (y / n), its argument
and temporary GiB a device (temp an upper bound: one device's
microbatch, the weights unsplit), the dominant roofline term (C compute,
M memory), ``useful_flops_ratio`` and the microbatches; after the slash
the same GiB and microbatches on the two pods (2x16x16), whose dominant
term and ratio are the single pod's (the counts are global). All
predictions on the H100 SXM's constants, not measurements.
"""

import json
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _gib(r) -> str:
    m = r["memory"]
    temp = m["temp_bytes"] / 2 ** 30
    return (f"{m['argument_bytes'] / 2 ** 30:.2f}+"
            + (f"{temp:.3g}" if temp < 1000 else f"{temp:.0f}"))


def main(path: str) -> None:
    cells = {}
    for r in json.load(open(path)):
        cells[(r["arch"], r["shape"], r["mesh"])] = r
    archs = list(dict.fromkeys(a for a, _, _ in cells))
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("|---" * (len(SHAPES) + 1) + "|")
    for a in archs:
        row = []
        for s in SHAPES:
            one, two = cells.get((a, s, "16x16")), cells.get((a, s, "2x16x16"))
            if one is None:
                row.append("–")
                continue
            if "error" in one:
                row.append(f"error: {one['error']}")
                continue
            text = (f"{'y' if one['memory']['fits_80GB'] else 'n'} "
                    f"{_gib(one)} {one['dominant'][0].upper()} "
                    f"{one['useful_flops_ratio']:.2f} k{one['k_micro']}")
            if two is not None:
                text += (f" / error: {two['error']}" if "error" in two
                         else f" / {_gib(two)} k{two['k_micro']}")
            row.append(text)
        print(f"| {a} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main(sys.argv[1])
