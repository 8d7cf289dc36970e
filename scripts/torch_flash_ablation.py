#!/usr/bin/env python3
"""Where the time of ``flash_attention``'s ``wgmma`` route goes, on one
NVIDIA GPU.

    python3 scripts/torch_flash_ablation.py      # from the root of a checkout

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with parts of
the tensor-core kernel's tile loop compiled out, and times each at
``chip_smoke.py``'s causal prefill shape (B=1, S=2048, H=36, Hkv=4, bf16)
for D = 128 and D = 64, beside ``F.scaled_dot_product_attention(...,
is_causal=True, enable_gqa=True)``. The parts: the K/V loads of the next
tile (``load``), the block barrier a tile (``sync``), both ``wgmma``
products (``gemm``) and the online softmax (``softmax``, replaced by a
correction of 1). A variant that leaves out a part computes garbage; only
its time is read. ``full`` is the kernel as it stands. The copies go to
``build/flash_ablation``.

One JSON object a line (``flash_ablation {...}``: variant -> device ms),
the card's name and power limit last. Device times as in
``chip_smoke.py`` (``_device_ms``). Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# part -> (first line, last line) of the code it names in the tile loop
PARTS = {
    "load": ("    if (it + 1 < n) load_kv(st ^ 1, kt_begin + it + 1);",
             "    if (it + 1 < n) load_kv(st ^ 1, kt_begin + it + 1);"),
    "sync": ("    __syncthreads();  // tile it has landed; every read of tile "
             "it - 1 done", "tile it - 1 done"),
    "gemm_s": ("#pragma unroll\n    for (int kk = 0; kk < D / 16; ++kk) {",
               "      hopper::wgmma_ss_m64n128k16(s, da, db, kk > 0);\n    }"),
    "gemm_pv": ("#pragma unroll\n    for (int kk = 0; kk < BK / 16; ++kk) {\n"
                "      const uint64_t db = hopper::desc128(va",
                "        hopper::wgmma_rs_m64n128k16_tb(o, pa + 4 * kk, db);\n"
                "    }"),
    "softmax": ("    const bool need_mask =",
                "rs;  // this thread's columns\n    }"),
}
VARIANTS = {  # name -> parts left out
    "full": (), "no_softmax": ("softmax",), "no_load": ("load",),
    "no_gemm": ("gemm",), "gemm_only": ("softmax", "load", "sync"),
    "softmax_only": ("gemm", "load", "sync"), "load_only": ("gemm", "softmax"),
}


def _guarded_source() -> str:
    """The kernel source with each part inside ``#ifndef NO_<PART>``."""
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    for part, (first, last) in PARTS.items():
        if src.count(first) != 1:
            raise RuntimeError(f"flash_ablation: the {part} part moved")
        i = src.index(first)
        j = src.index(last, i) + len(last)
        macro = "NO_GEMM" if part.startswith("gemm") else f"NO_{part.upper()}"
        alt = "    float corr[2] = {1.0f, 1.0f};\n" if part == "softmax" else ""
        src = (src[:i] + f"#ifndef {macro}\n" + src[i:j] + "\n#else\n" + alt
               + "#endif\n" + src[j:])
    return src


def _build() -> dict:
    """Variant name -> its ``flash_attention_tc_launch``."""
    from repro_torch.kernels import _build as kb

    out_dir = ROOT / "build" / "flash_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flash_attention.cu"
    src.write_text(_guarded_source())
    procs = {}
    for name, parts in VARIANTS.items():
        defs = sorted({f"-DNO_{p.upper()}" for p in parts})
        lib = out_dir / f"lib_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, f"-I{kb.CSRC}", *defs, "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"flash_ablation: {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(lib)).flash_attention_tc_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    import chip_smoke

    fns = _build()
    b, s, h, hkv, _ = chip_smoke.FA_SHAPE
    dev = torch.device("cuda")
    for d in (128, 64):
        gen = torch.Generator(device=dev).manual_seed(8)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((b, s, h, d), (b, s, hkv, d),
                                          (b, s, hkv, d)))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        row = {"d": d}
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b, s, s, h, hkv, d, d ** -0.5, 1, 0,
                         0, stream)
                if err:
                    raise RuntimeError(f"flash_ablation: cudaError {err}")
            row[name] = chip_smoke._device_ms(call, 20)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        row["sdpa_is_causal"] = chip_smoke._device_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        print("flash_ablation", json.dumps(row), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
