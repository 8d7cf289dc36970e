"""Build and load the hand-written Hopper kernels.

Each ``repro_torch/csrc/<name>.cu`` exposes a plain C launch function.
At first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``build/kernels/`` at the checkout root (git-ignored),
named by a hash of its source and flags so an edit rebuilds and an
unchanged source loads straight away, and loaded with ``ctypes``. The
hash covers the source, every header in ``csrc/`` (``*.cuh``) and the
flags, so an edit of a shared header rebuilds too. All sources compile at
once, one ``nvcc`` process each.

No ``--use_fast_math`` / ``-ftz=true``: the CIM kernel's wide
power-of-two construction relies on exact subnormal products.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("cim_linear", "paged_decode_mx", "mxfp4_matmul", "paged_decode",
           "flash_attention")

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple, ctypes._CFuncPtr] = {}
build_log: dict[str, str] = {}  # nvcc's stderr (ptxas register report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> float:
    """Compile every missing library in parallel; returns wall seconds.
    Raises ``RuntimeError`` with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if n not in _loaded and not _lib_path(n).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            tmp = _lib_path(name).with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """Launch function ``symbol`` of kernel ``name``, typed once (it
    returns a CUDA error code); the per-call host cost is the call."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _functions[(name, symbol)] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def needs_grad(*tensors) -> bool:
    """Whether autograd would need a gradient through an op on
    ``tensors``: grad mode is on and a floating tensor requires grad."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.is_floating_point() and t.requires_grad
        for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a launch of kernel ``name`` would hand autograd an
    output with no gradient: the kernels have no backward, as the Pallas
    kernels they replace have none, so a differentiable caller takes the
    torch-op path (or runs the kernel under ``torch.no_grad()``)."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and this CUDA kernel has no "
            "backward (the JAX package has none for it either); run it "
            "under torch.no_grad() or take the differentiable torch-op path")


def on_device(launch):
    """A wrapper's launch (first argument: a CUDA tensor) run with the
    current CUDA device set to that tensor's: the kernel goes to the
    stream of its own device, and the launch function opts its kernel in
    to its shared memory on that device (a tensor on a second card while
    the current device is the first would be refused)."""
    @functools.wraps(launch)
    def run(x, *a, **kw):
        with torch.cuda.device(x.device):
            return launch(x, *a, **kw)

    return run
