"""Wrapper for the packed-MXFP4 dequant-matmul kernel
(``csrc/mxfp4_matmul.cu``): ``x @ dequant(codes, exps)`` with the weights
expanded only on chip.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise; ``meta`` tensors (the dry-run) get the kernel's output
shape and record the call, on the route the card would take, with
:func:`cost` (``obs.cost``), launching nothing. The kernel has three routes, picked by :func:`pick_route`
from the shape and dtype alone: ``"mma"`` (warp-level bf16 tensor cores at
decode sizes, K split in one launch), ``"wgmma"`` (warpgroup bf16 tensor
cores at prefill sizes) and ``"fma"`` (f32 FMAs on the CUDA cores: f32
``x`` and shapes the others do not tile). Each stores its f32 accumulator,
or its split-K sum, as bf16 (rounded to nearest even) or, with
``out_dtype=torch.float32``, as it is: the partial product of a
row-parallel linear, summed over the model ranks before its one rounding.
``mxfp4_matmul.launches`` counts
wrapper launches, one per call; ``mxfp4_matmul.route_launches`` counts
them by route, ``mxfp4_matmul.f32_launches`` those with f32 out.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.mxfp4_matmul.ref import mxfp4_matmul_ref
from repro_torch.obs import cost as cost_mod
from repro_torch.obs.profile import profiled_call

BM_SMALL, BM = 4, 8  # the kernel's row tiles (M <= 4: decode lanes)
COLS = 128  # output columns per block: 32 lanes x 4
KB_PER_STEP = 8  # 32-row K blocks per block step (one per warp)
TARGET_BLOCKS = 4 * 132  # four blocks per H100 SM before K is split
SMS = 132  # H100 SXM streaming multiprocessors
# rows from which bf16 x takes the warpgroup route, and below which the
# warp-level one (which takes up to MMA_MAX_M rows): chip_smoke.py's "route
# crossover" lines time all three routes on w1 at M = 4..64; on the H100
# the mma route is still 2x faster at M = 16 (PERF.md)
TC_MIN_M = 17
TC_BN, TC_BK = 128, 64  # its output columns per block and K rows per tile
# its time model (tc_time_us), fitted to scripts/torch_kernel_sweep.py
TC_TILE_US, TC_BLOCK_US = 1.45, 3.0  # per K tile of a block, per block
TC_PARTIAL_BYTES_US = 4e6  # split-K partials written and read back
MMA_BN, MMA_WARPS = 128, 8  # the mma route's columns a warp, warps a block
MMA_MAX_M = 16  # its rows: two tiles of 8 rows of x
MMA_MIN_KB = 6  # 32-row K blocks a split keeps at least
ROUTES = ("fma", "mma", "wgmma")
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGTYPES_TC = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGTYPES_MMA = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]
OUT_DTYPES = (torch.bfloat16, torch.float32)
_arrivals: dict = {}


def pick_route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """bf16 ``x``: ``"mma"`` below ``TC_MIN_M`` rows (N % 16 == 0),
    ``"wgmma"`` from there on a shape the warpgroup kernel tiles (K % 64,
    N % 128); everything else ``"fma"``. f32 ``x`` stays on ``"fma"``:
    rounding it to bf16 would change the function."""
    if dtype != torch.bfloat16:
        return "fma"
    if m < TC_MIN_M:
        return "fma" if n % 16 else "mma"
    if k % TC_BK or n % TC_BN:
        return "fma"
    return "wgmma"


def mma_resident(m: int) -> int:
    """Blocks of the mma route resident at once: two an SM for one tile of
    8 rows of x (at most 128 registers a thread), one for two tiles."""
    return (2 if m <= 8 else 1) * SMS


def pick_mma(m: int, k: int, n: int) -> tuple[int, int]:
    """(wc, splits) of the mma route: one warp a 128-column tile (wc = 1),
    K split so that the grid comes nearest one resident wave
    (:func:`mma_resident`) from below, each split keeping at least
    ``MMA_MIN_KB`` 32-row blocks; where the tiles alone are between half
    a wave and a wave, two warps side by side (wc = 2) halve the tiles so
    that K can be split. From the H100 sweep in
    ``scripts/torch_kernel_sweep.py`` (``mma_splits``). Only split counts
    the kernel's ceil division reproduces, so no split is empty."""
    resident, nkb = mma_resident(m), k // 32
    wc = 2 if resident // 2 < -(-n // MMA_BN) < resident else 1
    tiles = -(-n // (MMA_BN * wc))
    want = max(1, min(resident // tiles, nkb // MMA_MIN_KB))
    return wc, -(-nkb // -(-nkb // want))


def tc_time_us(m: int, k: int, n: int, splits: int) -> float:
    """The tensor-core route's time model, fitted to its H100 runs (one
    block an SM, 64-192 rows x 128 columns a block): ``waves x
    (TC_TILE_US per 64-row K tile + TC_BLOCK_US)`` for the kernel plus
    the f32 partials written and summed at ``TC_PARTIAL_BYTES_US``."""
    rows = 64 * min(3, -(-m // 64))
    tiles = -(-m // rows) * (n // TC_BN)
    nkt = k // TC_BK
    waves = -(-tiles * splits // SMS)
    t = waves * (-(-nkt // splits) * TC_TILE_US + TC_BLOCK_US)
    return t + (8 * splits * m * n / TC_PARTIAL_BYTES_US if splits > 1
                else 0.0)


def pick_tc_splits(m: int, k: int, n: int) -> int:
    """K splits of the tensor-core route with the least :func:`tc_time_us`:
    splitting fills a wave that the output tiles alone leave part empty
    (w1: 144 tiles on 132 SMs) at the cost of the partials. No split is
    empty (each count is one the kernel's ceil division reproduces)."""
    nkt = k // TC_BK
    counts = sorted({-(-nkt // -(-nkt // s)) for s in range(1, nkt + 1)})
    return min(counts, key=lambda s: tc_time_us(m, k, n, s))


def pick_splits(m: int, k: int, n: int) -> int:
    """Split K over this many blocks when the output tiles alone are too
    few to fill the card; each split keeps at least one block step."""
    bm = BM_SMALL if m <= BM_SMALL else BM
    tiles = -(-m // bm) * -(-n // COLS)
    if tiles >= TARGET_BLOCKS:
        return 1
    nkb = k // 32
    return max(1, min(-(-TARGET_BLOCKS // tiles), nkb // KB_PER_STEP))


def _arrivals_for(dev: torch.device, tiles: int) -> torch.Tensor:
    """The device's arrival counters of the mma route's column tiles, zero
    at rest (the last split of each tile resets its own); grown, never
    cleared, so a call needs no memset and no sync. One set a
    ``kernels.scratch_slot`` (launches on concurrent streams)."""
    key = kernels.scratch_key(dev)
    a = _arrivals.get(key)
    if a is None or a.numel() < tiles:
        a = torch.zeros(tiles, dtype=torch.int32, device=dev)
        _arrivals[key] = a
    return a


@_build.on_device
def _launch(xm: torch.Tensor, codes: torch.Tensor, exps: torch.Tensor,
            route: str | None = None, tc_splits: int | None = None,
            mma_layout: int | None = None,
            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch the kernel on ``route`` (default :func:`pick_route`), its
    output of ``out_dtype`` (bf16 or f32), with
    ``tc_splits`` K splits on the wgmma or mma route (default
    :func:`pick_tc_splits` / :func:`pick_mma`) and, on the mma route,
    ``mma_layout`` warps side by side; a caller names them only to time the
    alternatives on one shape (``chip_smoke.py``,
    ``scripts/torch_kernel_sweep.py``)."""
    _build.refuse_grad("mxfp4_matmul", xm)
    m, k = xm.shape
    n = codes.shape[1]
    if n % 4:
        raise ValueError(f"mxfp4_matmul kernel needs N % 4 == 0, got N={n}")
    if xm.dtype not in (torch.bfloat16, torch.float32):
        xm = xm.to(torch.float32)
    xm = xm.contiguous()
    for t, name in ((codes, "codes"), (exps, "exps")):
        if (t.device != xm.device or t.dtype != torch.uint8
                or not t.is_contiguous()):
            raise ValueError(f"mxfp4_matmul: {name} must be contiguous uint8 "
                             f"on {xm.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=xm.device)
    if m == 0:
        return out
    route = route or pick_route(m, k, n, xm.dtype)
    f32 = int(out_dtype == torch.float32)
    stream = torch.cuda.current_stream(xm.device).cuda_stream
    if route == "mma":
        if xm.dtype != torch.bfloat16 or m > MMA_MAX_M or n % 16:
            raise ValueError(f"mxfp4_matmul: the mma route takes bf16 x, "
                             f"M <= {MMA_MAX_M} and N % 16 == 0")
        if any(t.data_ptr() % 16 for t in (xm, codes, exps)):
            raise ValueError("mxfp4_matmul: the mma route needs 16-byte "
                             "aligned x, codes and exps")
        wc, splits = pick_mma(m, k, n)
        if tc_splits:
            wc, splits = mma_layout or wc, tc_splits
        partial = _partial(splits, m, n, out)
        arrivals = _arrivals_for(xm.device, -(-n // (MMA_BN * wc)))
        fn = _build.function("mxfp4_matmul", "mxfp4_matmul_mma_launch",
                             _ARGTYPES_MMA)
        err = fn(xm.data_ptr(), codes.data_ptr(), exps.data_ptr(),
                 out.data_ptr(), partial.data_ptr(), arrivals.data_ptr(), m,
                 k, n, splits, wc, f32, stream)
    elif route == "wgmma":
        if xm.dtype != torch.bfloat16 or k % TC_BK or n % TC_BN:
            raise ValueError(f"mxfp4_matmul: the wgmma route takes bf16 x, "
                             f"K % {TC_BK} == 0 and N % {TC_BN} == 0")
        if any(t.data_ptr() % 16 for t in (xm, codes, exps)):
            raise ValueError("mxfp4_matmul: the wgmma route needs 16-byte "
                             "aligned x, codes and exps")
        splits = tc_splits or pick_tc_splits(m, k, n)
        partial = _partial(splits, m, n, out)
        fn = _build.function("mxfp4_matmul", "mxfp4_matmul_tc_launch",
                             _ARGTYPES_TC)
        err = fn(xm.data_ptr(), codes.data_ptr(), exps.data_ptr(),
                 out.data_ptr(), partial.data_ptr(), m, k, n, splits, f32,
                 stream)
    else:
        splits = pick_splits(m, k, n)
        partial = _partial(splits, m, n, out)
        fn = _build.function("mxfp4_matmul", "mxfp4_matmul_launch",
                             _ARGTYPES)
        err = fn(xm.data_ptr(), codes.data_ptr(), exps.data_ptr(),
                 out.data_ptr(), partial.data_ptr(), m, k, n, splits,
                 int(xm.dtype == torch.bfloat16), f32, stream)
    mxfp4_matmul.launches += 1
    mxfp4_matmul.route_launches[route] += 1
    mxfp4_matmul.f32_launches += f32
    _build.check(err, "mxfp4_matmul")
    return out


def cost(m: int, k: int, n: int, x_bytes: int,
         out_bytes: int = 2) -> tuple[float, float, str]:
    """(bytes, operations, their type) of one call: x read once, the packed
    codes (K/2 x N) and scales (K/32 x N) once, the output (bf16, or f32:
    ``out_bytes`` 4) written once; 2 M N K operations, bf16 for bf16 x,
    f32 otherwise. The bound of ``chip_smoke.py``'s rows and the dry-run's
    count."""
    n_bytes = x_bytes * m * k + k * n // 2 + k * n // 32 + out_bytes * m * n
    return n_bytes, 2.0 * m * n * k, "bf16" if x_bytes == 2 else "f32"


def _meta(xm: torch.Tensor, codes: torch.Tensor, exps: torch.Tensor,
          route: str | None = None,
          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`_launch` on ``meta``: the output and the split-K partials
    the launch would allocate, and the call recorded with :func:`cost` on
    its route; nothing runs."""
    _build.refuse_grad("mxfp4_matmul", xm)
    m, k = xm.shape
    n = codes.shape[1]
    dtype = xm.dtype if xm.dtype in (torch.bfloat16, torch.float32) \
        else torch.float32
    out = torch.empty((m, n), dtype=out_dtype, device=xm.device)
    if m == 0:
        return out
    route = route or pick_route(m, k, n, dtype)
    splits = (pick_mma(m, k, n)[1] if route == "mma"
              else pick_tc_splits(m, k, n) if route == "wgmma"
              else pick_splits(m, k, n))
    _partial(splits, m, n, out)
    n_bytes, ops, _ = cost(m, k, n, dtype.itemsize, out_dtype.itemsize)
    cost_mod.record_kernel("mxfp4_matmul", route, ops, n_bytes)
    return out


def _partial(splits: int, m: int, n: int, out: torch.Tensor) -> torch.Tensor:
    """The f32 split-K partials, or ``out`` itself when K is not split."""
    if splits == 1:
        return out
    return torch.empty((splits, m, n), dtype=torch.float32, device=out.device)


def mxfp4_matmul(x: torch.Tensor, codes: torch.Tensor, exps: torch.Tensor,
                 *, out_dtype: torch.dtype = torch.bfloat16,
                 obs=None) -> torch.Tensor:
    """x [..., K] @ dequant(codes [K//2, N], exps [K//32, N]) -> [..., N]
    of ``out_dtype`` (bf16 or f32), f32 accumulation: the bf16 output is
    the f32 one rounded to nearest even."""
    k = x.shape[-1]
    n = codes.shape[1]
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"mxfp4_matmul: out_dtype {out_dtype} is not one "
                         "of bf16, f32")
    if k % 32 or codes.shape != (k // 2, n) or exps.shape != (k // 32, n):
        raise ValueError(f"mxfp4_matmul: x [..., {k}] does not match codes "
                         f"{tuple(codes.shape)} / exps {tuple(exps.shape)}")
    xm = x.reshape(-1, k)
    if x.device.type == "cpu":
        out = profiled_call("mxfp4_matmul.ref", obs,
                            lambda: mxfp4_matmul_ref(xm, codes, exps,
                                                     out_dtype))
    elif x.device.type in ("cuda", "meta"):
        run = _meta if x.is_meta else _launch
        if n % 4:
            # the kernel stores four columns at a time: zero columns (scale
            # 0) pad N, and the product drops them (tiny xlstm-125m's sLSTM
            # FFN is 170 wide; the reference's conversion packs it); the
            # route is N's
            pad = -n % 4
            out = profiled_call("mxfp4_matmul", obs, lambda: run(
                xm, F.pad(codes, (0, pad)), F.pad(exps, (0, pad)),
                route=pick_route(xm.shape[0], k, n, xm.dtype),
                out_dtype=out_dtype))[:, :n]
        else:
            out = profiled_call("mxfp4_matmul", obs, lambda: run(
                xm, codes, exps, out_dtype=out_dtype))
    else:
        raise ValueError(f"mxfp4_matmul: unsupported device {x.device}")
    return out.reshape(x.shape[:-1] + (n,))


mxfp4_matmul.launches = 0
mxfp4_matmul.route_launches = dict.fromkeys(ROUTES, 0)
mxfp4_matmul.f32_launches = 0
