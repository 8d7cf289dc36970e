"""Wrapper for the fused CIM kernel (``csrc/cim_linear.cu``): raw
activations in (the MXFP4 activation quantize runs inside the kernel)
against resident INT5 weight codes + per-block exponents, both K-major
(``core.mx.MXW``), and the layer's Row-Hist calibration.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise; ``meta`` tensors (the dry-run) get the kernel's output
shape and record the call, on the route the card would take, with
:func:`cost` (``obs.cost``), launching nothing. :func:`pick_route` picks the route from the shape alone:
``"splitk"`` (decode: integer sums, K split over :func:`pick_splits`
blocks, guarded rows walked in order) or ``"wgmma"`` (prefill: an
activation pre-pass, then tensor-core block dots aligned in order in f32).
``cim_linear.launches`` counts calls that launched, one per call (the
``wgmma`` route's pre-pass included); ``cim_linear.route_launches`` counts
them by route.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.core import cim as cimlib
from repro_torch.core import mx as mxlib
from repro_torch.kernels import _build
from repro_torch.kernels.cim_linear.ref import cim_linear_ref
from repro_torch.obs import cost as cost_mod
from repro_torch.obs.profile import profiled_call

SMS = 132  # H100 SXM streaming multiprocessors
TARGET_BLOCKS = 3 * SMS  # splitk blocks a grid aims at (3 resident an SM)
WARPS = 8  # warps a splitk block
EXACT_UNITS = 2 ** 24  # f32 sums of multiples of 2^-CM stay exact below it
CM_MAX = 24  # the integer sums' shifts stay in range up to this CM
# rows from which the tensor-core route is taken (prefill): chip_smoke.py's
# "cim_linear route crossover" lines time both routes on w1 at M = 16..128;
# the route also needs K % 64 == 0 and more than 1024 columns (16 tiles of
# 64 a row tile), else its grid leaves most of the card idle
TC_MIN_M = 64
TC_MIN_N = 1025
TC_BK = 64  # its K tile: two 32-blocks
ROUTES = ("splitk", "wgmma")
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
    ctypes.c_int] * 10 + [ctypes.c_void_p]
_ARGTYPES_TC = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
    ctypes.c_int] * 6 + [ctypes.c_void_p]
_workspaces: dict = {}
_guard_rows: dict = {}


def pick_route(m: int, k: int, n: int) -> str:
    """``"wgmma"`` (tensor-core block dots, ordered f32 alignment) from
    ``TC_MIN_M`` rows on shapes with K % 64 == 0 and N >= ``TC_MIN_N``,
    else ``"splitk"`` (integer sums, K split over blocks)."""
    if m >= TC_MIN_M and k % TC_BK == 0 and n >= TC_MIN_N:
        return "wgmma"
    return "splitk"


def pick_tile(m: int, n: int) -> tuple[int, int]:
    """(rows, K-warps) of a splitk block: 4, 8 or 16 rows (M is masked),
    and 4 warps sharing each column over K for narrow N (64 columns a
    block), else 1 (256 columns a block)."""
    bm = 4 if m <= 4 else 8 if m <= 8 else 16
    return bm, (4 if n <= 1024 else 1)


def pick_splits(m: int, k: int, n: int) -> int:
    """K splits of the splitk route: as many as keep the grid within
    ``TARGET_BLOCKS`` (one wave) when the output tiles alone are fewer,
    each split at least as many 32-blocks as the block has K-warps. Every
    split owns ``ceil(nb / splits)`` 32-blocks (the kernel's division), the
    last what is left but never nothing, so the bounds are 32-aligned and
    cover K once."""
    bm, wk = pick_tile(m, n)
    tiles = -(-m // bm) * -(-n // (32 * WARPS // wk))
    nb = k // mxlib.BLOCK
    if tiles >= TARGET_BLOCKS or nb <= wk:
        return 1
    splits = min(max(1, TARGET_BLOCKS // tiles), nb // wk)
    per = -(-nb // splits)
    return -(-nb // per)


def needs_guard(k: int, cm: int) -> bool:
    """Whether a row can reach 2^24 units of 2^-CM: K * 144 * 2^CM (32
    products of at most 12 * 12 a 32-block, each shifted by up to CM)."""
    return k * 144 * 2 ** cm >= EXACT_UNITS


def workspace_ints(m: int, k: int, n: int) -> int:
    """int32 words of the splitk workspace: the two passes' sums [2, M, N],
    the guard's row sums a column tile, and an arrival counter a tile."""
    if pick_splits(m, k, n) == 1:
        return 0
    bm, wk = pick_tile(m, n)
    tn, tm = -(-n // (32 * WARPS // wk)), -(-m // bm)
    return 2 * m * n + tn * m + tm * tn


def _device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    return dev


def _workspace(dev: torch.device, ints: int) -> torch.Tensor:
    """The device's splitk workspace, zero at rest (every launch leaves it
    so); grown, never cleared, so a call needs no memset and no sync. One
    a ``kernels.scratch_slot`` (launches on concurrent streams)."""
    dev = _device(dev)
    key = kernels.scratch_key(dev)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < ints:
        ws = torch.zeros(max(ints, 1), dtype=torch.int32, device=dev)
        _workspaces[key] = ws
    return ws


def guard_rows(dev: torch.device) -> torch.Tensor:
    """The device's count of rows that took the ordered f32 walk (int32
    [1]); a caller that reads it zeroes it first."""
    dev = _device(dev)
    g = _guard_rows.get(dev)
    if g is None:
        g = torch.zeros(1, dtype=torch.int32, device=dev)
        _guard_rows[dev] = g
    return g


def _check_kmajor(w: mxlib.MXW, dev: torch.device) -> None:
    k, n = w.codes.shape
    for t, name, rows in ((w.codes, "codes", k), (w.exps, "exps", k // 32)):
        if (t.device != dev or t.dtype != torch.int8
                or tuple(t.shape) != (rows, n)
                or (n > 1 and t.stride(1) != rows)
                or (rows > 1 and t.stride(0) != 1) or t.data_ptr() % 16):
            raise ValueError(f"cim_linear: {name} must be K-major int8 "
                             f"[{rows}, {n}] on {dev}, 16-byte aligned "
                             "(core.mx.kmajor)")


def _scalar(t, dtype, dev: torch.device, name: str) -> torch.Tensor:
    """A calibration scalar as the kernel reads it: a one-element device
    tensor of ``dtype`` (no copy when it already is one)."""
    t = torch.as_tensor(t, device=dev)
    if t.numel() != 1:
        raise ValueError(f"cim_linear: {name} must be a scalar")
    return t.to(dtype).contiguous()


def cost(m: int, k: int, n: int, x_bytes: int) -> tuple[float, float, str]:
    """(bytes, operations, their type) of one call: x read once, the int8
    codes (K x N) and block exponents (K/32 x N) once, the two calibration
    scalars, the f32 output written once; 2 M N K int8 operations. The
    bound of ``chip_smoke.py``'s rows and the dry-run's count."""
    n_bytes = m * k * x_bytes + k * n + (k // 32) * n + 8 + m * n * 4
    return n_bytes, 2.0 * m * n * k, "int8"


def _meta(xm: torch.Tensor, w: mxlib.MXW) -> torch.Tensor:
    """:func:`_launch` on ``meta``: the output (and the ``wgmma`` route's
    activation pre-pass buffers) the launch would allocate, and the call
    recorded with :func:`cost` on its route; nothing runs. (The
    ``splitk`` route's workspace persists a device; not counted.)"""
    _build.refuse_grad("cim_linear", xm)
    m, k = xm.shape
    n = w.codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=xm.device)
    if m == 0 or n == 0:
        return out
    route = pick_route(m, k, n)
    if route == "wgmma":
        torch.empty((m, k), dtype=torch.float16, device=xm.device)
        torch.empty((m, k // mxlib.BLOCK), dtype=torch.float32,
                    device=xm.device)
    n_bytes, ops, _ = cost(m, k, n, xm.element_size())
    cost_mod.record_kernel("cim_linear", route, ops, n_bytes)
    return out


@_build.on_device
def _launch(xm: torch.Tensor, w: mxlib.MXW, calib: cimlib.LayerCalib,
            cfg: cimlib.CIMConfig, route: str | None = None) -> torch.Tensor:
    """Launch the kernel on ``route`` (default :func:`pick_route`); a caller
    names it only to time both routes on one shape (``chip_smoke.py``)."""
    _build.refuse_grad("cim_linear", xm)
    m, k = xm.shape
    n = w.codes.shape[1]
    if k % mxlib.BLOCK:
        raise ValueError(f"cim_linear kernel needs K % 32 == 0, got K={k}")
    if not 1 <= cfg.cm_bits <= CM_MAX:
        raise ValueError(f"cim_linear kernel takes 1 <= cm_bits <= {CM_MAX}")
    _check_kmajor(w, xm.device)
    e_n = _scalar(calib.e_n, torch.int32, xm.device, "e_n")
    fs = _scalar(calib.adc_fs, torch.float32, xm.device, "adc_fs")
    out = torch.empty((m, n), dtype=torch.float32, device=xm.device)
    if m == 0 or n == 0:
        return out
    route = route or pick_route(m, k, n)
    cm = cfg.cm_bits
    adc = -1 if cfg.adc_bits is None else cfg.adc_bits
    stream = torch.cuda.current_stream(xm.device).cuda_stream
    if route == "wgmma":
        if k % TC_BK:
            raise ValueError(f"cim_linear: the wgmma route needs K % {TC_BK} "
                             "== 0")
        xq = torch.empty((m, k), dtype=torch.float16, device=xm.device)
        xu = torch.empty((m, k // mxlib.BLOCK), dtype=torch.float32,
                         device=xm.device)
        fn = _build.function("cim_linear", "cim_linear_tc_launch",
                             _ARGTYPES_TC)
        err = fn(xm.data_ptr(), int(xm.dtype == torch.bfloat16),
                 w.codes.data_ptr(), w.exps.data_ptr(), e_n.data_ptr(),
                 fs.data_ptr(), out.data_ptr(), xq.data_ptr(), xu.data_ptr(),
                 m, k, n, cm, adc, int(cfg.two_pass), stream)
    else:
        bm, wk = pick_tile(m, n)
        splits = pick_splits(m, k, n)
        ws = _workspace(xm.device, workspace_ints(m, k, n))
        fn = _build.function("cim_linear", "cim_linear_splitk_launch",
                             _ARGTYPES)
        err = fn(xm.data_ptr(), int(xm.dtype == torch.bfloat16),
                 w.codes.data_ptr(), w.exps.data_ptr(), e_n.data_ptr(),
                 fs.data_ptr(), out.data_ptr(), ws.data_ptr(),
                 guard_rows(xm.device).data_ptr(), m, k, n, bm, wk, splits,
                 cm, adc, int(cfg.two_pass), int(needs_guard(k, cm)), stream)
    cim_linear.launches += 1
    cim_linear.route_launches[route] += 1
    _build.check(err, "cim_linear")
    return out


def cim_linear(x: torch.Tensor, w: mxlib.MXW, calib: cimlib.LayerCalib, *,
               cfg: cimlib.CIMConfig | None = None, obs=None) -> torch.Tensor:
    """x [..., K] float -> [..., N] f32 through the analog CIM datapath."""
    cfg = cfg or cimlib.CIMConfig()
    if cfg.strategy != "row_hist" or cfg.collect_stats:
        raise ValueError("the CIM kernel runs the row_hist strategy only, "
                         "without stats")
    if x.device.type == "cpu":
        return profiled_call("cim_linear.ref", obs,
                             lambda: cim_linear_ref(x, w, calib, cfg))
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"cim_linear: unsupported device {x.device}")
    k, n = w.codes.shape
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])[:, :k]
    if xm.dtype not in (torch.float32, torch.bfloat16):
        xm = xm.to(torch.float32)
    pk = k - xm.shape[1]  # activations shorter than the padded weight K
    if pk:
        xm = F.pad(xm, (0, pk))
    if x.is_meta:
        return _meta(xm.contiguous(), w).reshape(lead + (n,))
    out = profiled_call("cim_linear", obs, lambda: _launch(
        xm.contiguous(), w, calib, cfg))
    return out.reshape(lead + (n,))


cim_linear.launches = 0
cim_linear.route_launches = {r: 0 for r in ROUTES}
