#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. Device: exits non-zero without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Build: compiles all five kernels from ``src/repro_torch/csrc`` (one
   nvcc each, in parallel) into the git-ignored ``build/kernels``.
3. Kernels against their plain PyTorch versions, on the card, at the
   shapes the serving paths give them (``flash_attention``: the prefill
   shape the model would give it); times (CUDA events, warmed, median),
   the plain version's time, the bound (bytes over 3.35 TB/s vs
   operations over the peak rate of their type, H100 SXM data sheet) and,
   where one PyTorch call computes the same function, that call's time
   (``library_ms``; timed here only, never used by the port).
   ``cim_linear`` rows must be bitwise their plain version; each names its
   route (``splitk``: integer sums, K split over ``splits`` blocks;
   ``wgmma``: tensor-core block dots, ordered f32 alignment, an activation
   pre-pass launched with it, one count), the rows that took the ordered
   walk (``guard_rows``) and the alignment's ALU floor (``align_floor_ms``)
   beside the bound; a constructed input at K=18432 whose ordered sum
   rounds must be bitwise with its one guarded row, and the ``route
   crossover`` lines time both routes on w1 at M = 16..128.
   ``mxfp4_matmul`` rows name their route (``mma`` for bf16 decode rows,
   ``wgmma`` for bf16 prefill, ``fma`` for f32 x, picked from shape and
   dtype) and the route's counter must move; w1 is also run with f32 x at
   M=192 and at the ragged M=100, and timed on all three routes at small M
   (``route crossover`` lines). ``paged_decode_mx`` rows name the query
   heads a block takes. ``paged_decode`` rows name their key split
   (``split_width``, ``splits``). ``flash_attention``
   rows name their route (``wgmma``: bf16 with D 64 or 128; ``fma``: f32)
   and SQNR; the bf16 rows must take ``wgmma``, and the ``tile`` line
   times both routes on one bf16 shape.
4. Serve ``--backend cim``: starcoder2-7b at full width with the depth cut
   to 8 of 32 layers, through the launcher's entry points: 8 staggered
   requests, 4 lanes, 6 slots, prompts up to 192 tokens, 64 new tokens.
   Every kernel's launch counter is zeroed just before and read just
   after: ``cim_linear`` and ``paged_decode_mx`` must have launched, the
   other kernels not. Output checks: every request's tokens are in the
   vocabulary and as many as asked; prefill logits of a 192-token prompt
   through the kernels agree with ``impl="ref"`` on the card (SQNR >= 30
   dB); a tiny model with the same weights gives the same logits on the
   card as on the CPU. Then one 192-token prefill and 8 decode steps (4
   live lanes), each under ``torch.profiler``: device time by kernel, wall
   time and the device's busy share; a window whose trace misses a launch
   the wrappers counted is run again (``timer`` names the figure's
   source). ``cim_linear`` launches by route must
   show both routes in the serve, ``wgmma`` in the prefill (M = 192 with
   N > 1024) and ``splitk`` only in the decode steps.
5. Serve ``--backend mxfp4`` the same way at full width and full depth (32
   layers): ``mxfp4_matmul`` (both routes) and ``paged_decode`` must have
   launched, ``cim_linear`` and ``paged_decode_mx`` not; the same output
   checks and profiles, where the prefill's linears must take the
   ``wgmma`` route and the decode step's the ``mma`` route only.
6. Prints the kernels line, then the card's name and power limit, then
   the device line, as the last line.

Every measured shape is printed on a line of its own (``cim_linear {...}``,
``paged_decode_mx {...}``, ``mxfp4_matmul {...}``, ``paged_decode {...}``,
``flash_attention {...}``, ``serve {...}``, ``prefill profile {...}``,
``decode profile {...}``).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12  # H100 SXM
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
# cim_linear's alignment floor: integer instructions per (row, column,
# block) triple, and 64 INT32 lanes a clock on 132 SMs at ~1.75 GHz
ALIGN_OPS = 6
INT32_OPS_S = 14.8e12
TRACE_ARGS = ["--no-tiny", "--serve-trace", "--kv-layout", "fused",
              "--requests", "8", "--lanes", "4", "--slots", "6",
              "--prompt-len", "192", "--tokens", "64"]
SERVE_ARGS = {  # backend -> launcher arguments
    "cim": TRACE_ARGS + ["--backend", "cim", "--layers", "8",
                         "--calib-batches", "2", "--batch", "2"],
    "mxfp4": TRACE_ARGS + ["--backend", "mxfp4"],
}
OWN_KERNELS = {"cim": ("cim_linear", "paged_decode_mx"),
               "mxfp4": ("mxfp4_matmul", "paged_decode")}
# each wrapper's main device kernels: exactly one of them per wrapper launch
MAIN_KERNELS = {
    "cim_linear": ("cim_splitk_kernel", "cim_tc_kernel"),
    "paged_decode_mx": ("paged_decode_mx_kernel",),
    "mxfp4_matmul": ("mxfp4_matmul_kernel", "mxfp4_matmul_tc_kernel",
                     "mxfp4_matmul_mma_kernel"),
    "paged_decode": ("paged_decode_split_kernel",),
    "flash_attention": ("flash_attention_kernel", "flash_attention_tc_kernel"),
}
PROFILE_ATTEMPTS = 3  # profiler windows before their launch counts are used
# (K, N) of the static linears at starcoder2-7b width: wq/wo, wk/wv, w1,
# w2, the LM head
LINEAR_SHAPES = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608),
              (4608, 49152)]
M_PREFILL = 192  # rows of a prefill linear (the served prompt length)
M_RAGGED = 100  # a prefill row count that is not a multiple of 64
CROSSOVER_M = (4, 8, 16, 32, 64)  # rows at which the matmul routes are timed
CIM_CROSSOVER_M = (16, 32, 64, 128)  # the same for cim_linear's routes
DECODE_DIMS = (4, 4, 9, 128)  # lanes, KV heads, heads per KV head, head_dim
PAGES = ((48, [0, 1, 33, 48]), (256, [0, 31, 129, 256]))  # W, lengths
# flash_attention at the prefill shape the model would give it:
# (B, S, H, Hkv, D) of starcoder2-7b with a 2048-token prompt
FA_SHAPE = (1, 2048, 36, 4, 128)
FA_F32_S = 512  # sequence length of the f32 (fma route) row
FA_MIN_SQNR_DB = 40.0  # bf16 rows: P is rounded to bf16 for the PV product


def _device_events(prof) -> list:
    """The device's own events of a ``torch.profiler`` run, by kernel name
    (a CPU op's self device time repeats its kernels' time, so it is not
    counted again)."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def _device_kernels_ms(prof) -> dict:
    """Device time by kernel name from a ``torch.profiler`` run."""
    out: dict = {}
    for ev in _device_events(prof):
        out[ev.key] = out.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    return out


def _device_ms(fn, reps: int) -> float:
    """Device time per call: the kernels that ``reps`` warmed calls launch,
    summed (``torch.profiler``), over ``reps``. Host dispatch is not in it;
    :func:`_time_ms` around one call includes it. The profiler's device
    trace has come back empty, or with a kernel one launch short (which
    reads low), now and then on the H100 machine: a trace in which some
    kernel's launches are not a multiple of ``reps`` is taken again, and
    after three such traces the call is timed with CUDA events
    around ``reps`` calls queued behind a sleep kernel that outlasts their
    host dispatch, so that the events time the device and not the host
    (gaps between launches included, so an upper bound), and a line says
    so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        short = [ev for ev in events if ev.count % reps]
        if events and not short:
            return sum(ev.self_device_time_total for ev in events) / 1e3 / reps
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # twice the host's dispatch time of the calls, in cycles at <= 2 GHz
    torch.cuda._sleep(int(min(2e9, 4e9 * reps * host_s)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    last = (f"{short[0].count} launches of {short[0].key[:60]} in {reps} "
            "calls" if short else "no kernel")
    print(f"device timer: three empty or partial profiler traces (the last: "
          f"{last}), timed with CUDA events behind a sleep kernel",
          flush=True)
    return a.elapsed_time(b) / reps


def _time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median of ``reps`` CUDA-event-timed calls after ``warm`` calls; the
    host's dispatch of the call is inside the interval."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _kernel_wrappers() -> dict:
    """Every kernel wrapper (its ``launches`` counter) by kernel name."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pops

    return {"cim_linear": cim_ops.cim_linear,
            "paged_decode_mx": pops.paged_flash_decode_mx,
            "mxfp4_matmul": mm_ops.mxfp4_matmul,
            "paged_decode": pops.paged_flash_decode,
            "flash_attention": fa_ops.flash_attention}


def _bound_ms(n_bytes: float, ops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sqnr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    err = float(((ref - got) ** 2).sum())
    return float("inf") if err == 0 else 10 * np.log10(
        float((ref ** 2).sum()) / err)


def _align_floor_ms(m: int, k: int, n: int) -> float:
    """The alignment's ALU floor: m*n*(k/32) (row, column, block) triples
    at ``ALIGN_OPS`` integer instructions each over ``INT32_OPS_S``."""
    return m * n * (k // 32) * ALIGN_OPS / INT32_OPS_S * 1e3


def _rounding_input(dev):
    """The constructed input whose ordered f32 sum rounds (K = 18432, CM =
    3): row 0 has 460 32-blocks of products 12 * 12 at factor 1 (past 2^24
    units of 2^-3) and then 116 blocks of one product 1 * 1 at factor 2^-3,
    half an ulp each, which the ordered sum drops; row 1 has a quarter of
    the big products and stays exact. Returns (x, K-major w, calib, cfg)."""
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib

    k, big, n, cm = 18432, 460, 4608, 3
    x = torch.zeros((2, k), device=dev)
    x[0, :big * 32] = 6.0
    x[1, :big * 32:4] = 6.0
    x[:, big * 32::32] = 6.0
    x[:, big * 32 + 1::32] = 0.5
    codes = torch.zeros((k, n), dtype=torch.int8, device=dev)
    codes[:big * 32] = 12
    codes[big * 32 + 1::32] = 1
    exps = torch.zeros((k // 32, n), dtype=torch.int8, device=dev)
    exps[big:] = -cm
    w = mxlib.MXW(mxlib.kmajor(codes), mxlib.kmajor(exps))
    cal = cimlib.LayerCalib(torch.tensor(0, dtype=torch.int32, device=dev),
                            torch.tensor(1.0e7, device=dev))
    return x, w, cal, cimlib.CIMConfig(adc_bits=None, cm_bits=cm)


def check_cim_linear(dev, m_prefill: int) -> list:
    """Every linear shape at decode (M=4) and prefill (M=192), then the
    constructed rounding input at K=18432: each row bitwise its plain
    version (a mismatch raises), with its route, K splits, the rows that
    took the ordered walk (``guard_rows``, device counter) and the
    alignment's ALU floor beside the bytes/ops bound."""
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.cim_linear.ref import cim_linear_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = cimlib.CIMConfig()
    counter = cim_ops.guard_rows(dev)
    rows = []

    def row(x, w, cal, cfg, extra):
        m, k = x.shape
        n = w.codes.shape[1]
        route = cim_ops.pick_route(m, k, n)
        counter.zero_()
        before = cim_ops.cim_linear.route_launches[route]
        got = cim_ops.cim_linear(x, w, cal, cfg=cfg)
        if cim_ops.cim_linear.route_launches[route] != before + 1:
            raise AssertionError(f"cim_linear did not take the {route} route "
                                 f"at {(m, k, n)}")
        ref = cim_linear_ref(x, w, cal, cfg)
        torch.cuda.synchronize()
        guarded = int(counter)
        err = (got - ref).abs()
        n_bytes = m * k * 4 + k * n + (k // 32) * n + 8 + m * n * 4
        bound, by = _bound_ms(n_bytes, 2.0 * m * n * k, "int8")
        rows.append(extra | dict(
            m=m, k=k, n=n, route=route, splits=cim_ops.pick_splits(m, k, n),
            guard_rows=guarded, max_abs_err=float(err.max()),
            bitwise=bool(torch.equal(got, ref)),
            ms=_device_ms(lambda: cim_ops.cim_linear(x, w, cal, cfg=cfg), 20),
            call_ms=_time_ms(lambda: cim_ops.cim_linear(x, w, cal, cfg=cfg),
                             20),
            plain_ms=_device_ms(lambda: cim_linear_ref(x, w, cal, cfg), 3),
            bound_ms=bound, bound_by=by,
            align_floor_ms=_align_floor_ms(m, k, n)))
        rows[-1]["ok"] = rows[-1]["bitwise"]
        print("cim_linear", json.dumps(rows[-1]), flush=True)
        if not rows[-1]["ok"]:
            raise AssertionError(f"cim_linear kernel is not bitwise its "
                                 f"plain version at {(m, k, n)}")

    for k, n in LINEAR_SHAPES:
        w = mxlib.quantize_w(torch.randn((k, n), generator=gen, device=dev)
                             * k ** -0.5)
        for m in (4, m_prefill):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16).float()
            row(x, w, cimlib.calibrate_rowhist([x], w, cfg), cfg, {})
        if (k, n) == LINEAR_SHAPES[2]:
            cim_route_crossover(w, gen, dev, cfg)
    x, w, cal, rcfg = _rounding_input(dev)
    row(x, w, cal, rcfg, {"case": "rounding"})
    if rows[-1]["guard_rows"] != 1:
        raise AssertionError(f"cim_linear rounding input: "
                             f"{rows[-1]['guard_rows']} guarded rows, not 1")
    return rows


def cim_route_crossover(w, gen, dev, cfg) -> None:
    """Both routes of ``cim_linear`` on one shape (w1) at the row counts
    around ``TC_MIN_M``, bitwise each: where the tensor-core route starts
    to win."""
    from repro_torch.core import cim as cimlib
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.cim_linear.ref import cim_linear_ref

    k, n = w.codes.shape
    for m in CIM_CROSSOVER_M:
        x = torch.randn((m, k), generator=gen, device=dev)
        cal = cimlib.calibrate_rowhist([x], w, cfg)
        ref = cim_linear_ref(x, w, cal, cfg)
        ms = {}
        for r in cim_ops.ROUTES:
            if not torch.equal(cim_ops._launch(x, w, cal, cfg, route=r), ref):
                raise AssertionError(f"cim_linear route {r} is not bitwise "
                                     f"its plain version at M={m}")
            ms[f"{r}_ms"] = _device_ms(
                lambda: cim_ops._launch(x, w, cal, cfg, route=r), 20)
        print("cim_linear route crossover", json.dumps(
            {"m": m, "k": k, "n": n, "picked": cim_ops.pick_route(m, k, n)}
            | ms), flush=True)


def check_paged_decode(dev) -> list:
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.paged_attention import layout
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import ref as pref

    (lanes, hkv, g, dh), pool = DECODE_DIMS, 10
    scale = dh ** -0.5
    gen = torch.Generator(device=dev).manual_seed(2)
    rows_out = []
    for w, lens in PAGES:
        kv = (torch.randn((pool, w, 2 * hkv, dh), generator=gen, device=dev)
              * 0.7).to(torch.bfloat16)
        k, v = layout.split_kv(kv)
        quant = layout.quant_page_full(k, v)
        q = mxlib.fake_quant((torch.randn((lanes, hkv, g, dh), generator=gen,
                                          device=dev) * 0.7).to(torch.bfloat16))
        rows = torch.tensor([7, 0, 3, 9], device=dev, dtype=torch.int32)
        lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
        bk = pops.pick_bk(w)

        def kernel():
            return pops.ragged_paged_decode(q, rows, lengths, quant=quant,
                                            scale=scale)

        def plain():
            return pref.paged_flash_decode_mx_ref(
                q, quant["kv_codes"], quant["k_exps"], quant["v_exps"], rows,
                lengths, scale=scale, bk=bk)

        got, ref = kernel().float(), plain().float()
        dense = pref.ragged_paged_decode_ref(q, rows, lengths, quant=quant,
                                             scale=scale).float()
        torch.cuda.synchronize()
        live = lengths > 0
        err = float((got - ref).abs().max())
        sq_plain = _sqnr_db(ref[live], got[live])
        sq_dense = _sqnr_db(dense[live], got[live])
        ok = (sq_plain > 40.0 and err <= 0.05 and sq_dense > 13.0
              and float((got - dense).abs().max()) <= 0.35
              and bool((got[~live] == 0).all()))
        hb, nbd = quant["kv_codes"].shape[-1], quant["k_exps"].shape[-1]
        n_bytes = sum(hkv * (n * (2 * hb + nbd) + -(-n // 32) * dh)
                      for n in lens) + 2 * 2 * q.numel() + 8 * lanes
        ops = sum(4.0 * n * hkv * g * dh for n in lens)
        bound, by = _bound_ms(n_bytes, ops, "bf16")
        rows_out.append(dict(
            lanes=lanes, hkv=hkv, g=g, dh=dh, w=w, bk=bk, lengths=lens,
            heads_per_block=pops.pick_heads(g), max_abs_err=err, sqnr_vs_plain_db=sq_plain,
            sqnr_vs_dense_db=sq_dense, ok=ok, ms=_device_ms(kernel, 50),
            call_ms=_time_ms(kernel, 50), plain_ms=_device_ms(plain, 5),
            bound_ms=bound, bound_by=by))
        print("paged_decode_mx", json.dumps(rows_out[-1]), flush=True)
        if not ok:
            raise AssertionError(f"paged_decode_mx kernel disagrees at W={w}")
    return rows_out


def check_mxfp4_matmul(dev, m_prefill: int) -> list:
    """Every linear shape at decode (M=4) and prefill (M=192) in bf16, plus
    w1 at M=192 with f32 x (the fma route) and at the ragged M=100 in
    bf16. Each row names its route; the route's counter must move."""
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.mxfp4_matmul.ref import mxfp4_matmul_ref
    from repro_torch.layers import backends

    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for k, n in LINEAR_SHAPES:
        packed = backends._quantize_packed(
            torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        codes, exps = packed["codes"], packed["exps"]
        w_bf16 = backends._dequant_packed(codes, exps)  # library operand
        cases = [(4, torch.bfloat16), (m_prefill, torch.bfloat16)]
        if (k, n) == LINEAR_SHAPES[2]:
            cases += [(m_prefill, torch.float32), (M_RAGGED, torch.bfloat16)]
        for m, dtype in cases:
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            w_lib = w_bf16 if dtype == torch.bfloat16 else w_bf16.float()
            route = mm_ops.pick_route(m, k, n, dtype)
            before = mm_ops.mxfp4_matmul.route_launches[route]
            got = mm_ops.mxfp4_matmul(x, codes, exps).float()
            if mm_ops.mxfp4_matmul.route_launches[route] != before + 1:
                raise AssertionError(f"mxfp4_matmul did not take the {route} "
                                     f"route at {(m, k, n)}")
            ref = mxfp4_matmul_ref(x, codes, exps).float()
            torch.cuda.synchronize()
            err = (got - ref).abs()
            ok = bool((err <= 2e-2 * ref.abs() + 2e-2 * ref.abs().max()).all())
            n_bytes = (x.element_size() * m * k + k * n // 2 + k * n // 32
                       + 2 * m * n)
            bound, by = _bound_ms(n_bytes, 2.0 * m * n * k,
                                  "bf16" if dtype == torch.bfloat16 else "f32")
            rows.append(dict(
                m=m, k=k, n=n, x_dtype=str(dtype).split(".")[-1], route=route,
                max_abs_err=float(err.max()), sqnr_db=_sqnr_db(ref, got),
                ok=ok,
                ms=_device_ms(lambda: mm_ops.mxfp4_matmul(x, codes, exps), 20),
                call_ms=_time_ms(lambda: mm_ops.mxfp4_matmul(x, codes, exps),
                                 20),
                plain_ms=_device_ms(lambda: mxfp4_matmul_ref(x, codes, exps),
                                    3),
                bound_ms=bound, bound_by=by,
                library_ms=_device_ms(lambda: torch.matmul(x, w_lib), 20)))
            print("mxfp4_matmul", json.dumps(rows[-1]), flush=True)
            if not ok:
                raise AssertionError(f"mxfp4_matmul kernel disagrees with its "
                                     f"plain version at {(m, k, n)}")
        if (k, n) == LINEAR_SHAPES[2]:
            route_crossover(codes, exps, gen, dev)
        del packed, codes, exps, w_bf16
    return rows


def route_crossover(codes, exps, gen, dev) -> None:
    """All three routes of ``mxfp4_matmul`` on one shape (w1) at small M,
    bf16 x: where the warpgroup route starts to win over the warp-level
    one (``TC_MIN_M``); null where a route does not take M (mma past
    ``MMA_MAX_M`` rows)."""
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops

    k = codes.shape[0] * 2
    for m in CROSSOVER_M:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        ms = {r: None if r == "mma" and m > mm_ops.MMA_MAX_M else _device_ms(
            lambda: mm_ops._launch(x, codes, exps, route=r), 20)
            for r in mm_ops.ROUTES}
        print("mxfp4_matmul route crossover", json.dumps(
            {"m": m, "k": k, "n": codes.shape[1],
             "picked": mm_ops.pick_route(m, k, codes.shape[1], x.dtype)}
            | {f"{r}_ms": t for r, t in ms.items()}), flush=True)


def check_paged_decode_float(dev) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import layout
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import ref as pref

    (lanes, hkv, g, dh), pool = DECODE_DIMS, 10
    scale = dh ** -0.5
    gen = torch.Generator(device=dev).manual_seed(7)
    rows_out = []
    for w, lens in PAGES:
        kv = (torch.randn((pool, w, 2 * hkv, dh), generator=gen, device=dev)
              * 0.7).to(torch.bfloat16)
        q = (torch.randn((lanes, hkv, g, dh), generator=gen, device=dev)
             * 0.7).to(torch.bfloat16)
        rows = torch.tensor([7, 0, 3, 9], device=dev, dtype=torch.int32)
        lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
        bk = pops.pick_bk(w)

        def kernel():
            return pops.ragged_paged_decode(q, rows, lengths, kv=kv,
                                            scale=scale)

        def plain():
            return pref.paged_flash_decode_ref(q, kv, rows, lengths,
                                               scale=scale, bk=bk)

        got, ref = kernel().float(), plain().float()
        dense = pref.ragged_paged_decode_ref(q, rows, lengths, kv=kv,
                                             scale=scale).float()
        torch.cuda.synchronize()
        live = lengths > 0
        err = float((got - ref).abs().max())
        sq_plain = _sqnr_db(ref[live], got[live])
        ok = (sq_plain > 40.0 and err <= 1e-2
              and bool(((got - dense).abs()
                        <= 0.04 + 0.05 * dense.abs()).all())
              and bool((got[~live] == 0).all()))
        # the library call: SDPA over the lanes' pages, gathered (and the
        # length mask built) outside the timing
        kd, vd = layout.split_kv(kv[rows.long()])  # [L, W, Hkv, Dh]
        kd, vd = kd.transpose(1, 2), vd.transpose(1, 2)
        qs = q.reshape(lanes, hkv * g, 1, dh)
        mask = (torch.arange(w, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        n_bytes = sum(hkv * n * 2 * dh * 2 for n in lens) + 2 * 2 * q.numel() \
            + 8 * lanes
        ops = sum(4.0 * n * hkv * g * dh for n in lens)
        bound, by = _bound_ms(n_bytes, ops, "bf16")
        sw, splits = pops.pick_splits(w)
        rows_out.append(dict(
            lanes=lanes, hkv=hkv, g=g, dh=dh, w=w, bk=bk, split_width=sw,
            splits=splits, lengths=lens,
            max_abs_err=err, sqnr_vs_plain_db=sq_plain,
            sqnr_vs_dense_db=_sqnr_db(dense[live], got[live]), ok=ok,
            ms=_device_ms(kernel, 50), call_ms=_time_ms(kernel, 50),
            plain_ms=_device_ms(plain, 5), bound_ms=bound, bound_by=by,
            library_ms=_device_ms(lambda: F.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True),
                50)))
        print("paged_decode", json.dumps(rows_out[-1]), flush=True)
        if not ok:
            raise AssertionError(f"paged_decode kernel disagrees at W={w}")
    return rows_out


def check_flash_attention(dev) -> list:
    """At ``FA_SHAPE`` in bf16 (the ``wgmma`` route): causal over the whole
    prompt, a sliding window of half of it, and the last eighth of the
    queries at their offset (256 queries at 1792 for S = 2048); then causal
    with D = 64 (``wgmma``) and causal in f32 at ``FA_F32_S`` (the ``fma``
    route). Each row names its route, whose counter must move; bf16 rows
    must take ``wgmma`` and reach ``FA_MIN_SQNR_DB``. Then the ``tile``
    line times both routes on the causal bf16 shape."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    b, s, h, hkv, d = FA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = [(torch.bfloat16, d, s, s, 0, 0),
             (torch.bfloat16, d, s, s, s // 2, 0),
             (torch.bfloat16, d, s, s // 8, 0, s - s // 8),
             (torch.bfloat16, 64, s, s, 0, 0),
             (torch.float32, d, FA_F32_S, FA_F32_S, 0, 0)]
    rows = []
    for dtype, dh, sk, sq, window, off in cases:
        k, v, q_full = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                        for shape in ((b, sk, hkv, dh), (b, sk, hkv, dh),
                                      (b, sk, h, dh)))
        q = q_full[:, sk - sq:].contiguous()
        rows.append(_flash_attention_row(q, k, v, window, off))
        print("flash_attention", json.dumps(rows[-1]), flush=True)
        if not rows[-1]["ok"]:
            raise AssertionError(f"flash_attention kernel disagrees at "
                                 f"{rows[-1]}")
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    tile = {f"{r}_ms": _device_ms(lambda: fa_ops._launch(
        q, k, v, True, 0, 0, route=r), reps) for r, reps in (
            ("wgmma", 10), ("fma", 5))}
    print("flash_attention tile", json.dumps(
        {"b": b, "s": s, "h": h, "hkv": hkv, "d": d, "causal": True} | tile),
        flush=True)
    return rows


def _flash_attention_row(q, k, v, window: int, off: int) -> dict:
    """One causal ``flash_attention`` shape against its plain version:
    |err| <= 1e-2 + 1e-2 |ref| everywhere, and SQNR >= ``FA_MIN_SQNR_DB``
    in bf16; the picked route's counter moves by one. The library time is
    SDPA's with the boolean mask, or, where ``is_causal`` computes the same
    function (square, no window, no offset), the faster of that and
    ``is_causal=True``, which may take a faster backend; ``library_call``
    names the one kept."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    kw = dict(causal=True, window=window, q_offset=off)
    route = fa_ops.pick_route(sq, sk, d, q.dtype)
    if q.dtype == torch.bfloat16 and route != "wgmma":
        raise AssertionError(f"flash_attention picked {route} for bf16 at "
                             f"{tuple(q.shape)}")
    before = fa_ops.flash_attention.route_launches[route]
    got = fa_ops.flash_attention(q, k, v, **kw).float()
    if fa_ops.flash_attention.route_launches[route] != before + 1:
        raise AssertionError(f"flash_attention did not take the {route} "
                             f"route at {tuple(q.shape)}")
    ref = flash_attention_ref(q, k, v, **kw).float()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    sqnr = _sqnr_db(ref, got)
    ok = bool((err <= 1e-2 + 1e-2 * ref.abs()).all()) and bool(
        q.dtype != torch.bfloat16 or sqnr >= FA_MIN_SQNR_DB)
    qp = torch.arange(sq, device=dev)[:, None] + off
    kp = torch.arange(sk, device=dev)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > qp - window
    pairs = float(mask.sum())
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
    bound, by = _bound_ms(n_bytes, 4.0 * b * h * d * pairs, kind)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    library = {"attn_mask": _device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 10)}
    if sq == sk and not window and not off:
        library["is_causal"] = _device_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    library_call = min(library, key=library.get)
    return dict(
        b=b, sq=sq, sk=sk, h=h, hkv=hkv, d=d, dtype=kind, window=window,
        q_offset=off, route=route, max_abs_err=float(err.max()),
        sqnr_db=sqnr, ok=ok,
        ms=_device_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 10),
        call_ms=_time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 10),
        plain_ms=_device_ms(lambda: flash_attention_ref(q, k, v, **kw), 3),
        bound_ms=bound, bound_by=by, library_ms=library[library_call],
        library_call=library_call,
        library_by_call=library)


def check_tiny_agreement(dev, backend: str) -> None:
    """The tiny model with the same weights on the card (kernels) and on
    the CPU (plain versions): prefill into a fused page, then
    teacher-forced decode steps; logits SQNR >= 30 dB at every step."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(
        ["--serve-trace", "--backend", backend, "--device", "cpu",
         "--log-level", "warning"])
    cfg, cpu_params, ctx, cpu = serve.build_model(args)
    ids = torch.randint(0, cfg.vocab_size, (1, 40),
                        generator=torch.Generator().manual_seed(4))
    runs = []
    with torch.no_grad():
        for params, d in ((cpu_params, cpu), (_to(cpu_params, dev), dev)):
            caches = lm.init_cache(cfg, 1, 48, fused=True, device=d,
                                   mx_digital=ctx.hybrid_digital_sdpa)
            lo, caches = lm.forward(params, cfg, ctx,
                                    {"ids": ids[:, :36].to(d)}, caches=caches)
            steps = [lo[:, -1]]
            for p in range(36, 40):
                lo, caches = lm.decode_step(params, cfg, ctx,
                                            ids[:, p:p + 1].to(d), p, caches)
                steps.append(lo)
            runs.append([t.float().cpu() for t in steps])
    sq = [_sqnr_db(a, b) for a, b in zip(*runs)]
    print(f"tiny model [{backend}], card vs CPU plain versions, logits SQNR "
          f"per step (prefill, 4 decode): {sq}", flush=True)
    if min(sq) < 30.0:
        raise AssertionError(f"tiny model [{backend}]: card and CPU logits "
                             "disagree")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def serve_full_width(backend: str) -> dict:
    from repro_torch import obs as obs_lib
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(SERVE_ARGS[backend])
    obs = obs_lib.Obs()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, ctx, dev = serve.build_model(args, obs=obs)
    print(f"[{backend}] depth: {cfg.name} n_layers 32 -> {cfg.n_layers} "
          f"(full width: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size})", flush=True)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    resident = sum(t.numel() * t.element_size() for t in _leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    summary = serve.serve_trace(args, cfg, params, ctx, obs, dev)
    launches, routes = _read_counts()
    cim_routes = _cim_routes()
    peak = torch.cuda.max_memory_allocated()
    print("serve", json.dumps({"backend": backend, "layers": cfg.n_layers}
                              | {k: v for k, v in summary.items() if k != "out"}
                              | {"launches": launches,
                                 "mxfp4_matmul_routes": routes,
                                 "cim_linear_routes": cim_routes,
                                 "peak_mem_gib": peak / 2**30,
                                 "build_peak_mem_gib": build_peak / 2**30,
                                 "resident_params_gib": resident / 2**30,
                                 "model_build_s": build_s}), flush=True)
    own = OWN_KERNELS[backend]
    if any(launches[k] < 1 for k in own) or any(
            v for k, v in launches.items() if k not in own):
        raise AssertionError(f"[{backend}] launches {launches}: the path's "
                             f"own kernels are {own}, and only those")
    if backend == "mxfp4" and not (routes["mma"] and routes["wgmma"]):
        raise AssertionError(f"[mxfp4] mxfp4_matmul routes {routes}: the "
                             "serve must run mma (decode) and wgmma "
                             "(prefill)")
    if backend == "cim" and not all(cim_routes.values()):
        raise AssertionError(f"[cim] cim_linear routes {cim_routes}: the "
                             "serve must run both")
    for v in summary["out"].values():
        if not v or not all(0 <= t < cfg.vocab_size for t in v):
            raise AssertionError("served tokens out of the vocabulary")
    if summary["tokens"] != 8 * args.tokens:
        raise AssertionError(f"expected {8 * args.tokens} tokens, got "
                             f"{summary['tokens']}")
    # prefill logits of a 192-token prompt: kernels vs plain versions
    ids = torch.randint(0, cfg.vocab_size, (1, 192), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    with torch.no_grad():
        got, _ = lm.forward(params, cfg, ctx, {"ids": ids})
        ref, _ = lm.forward(params, cfg, dataclasses.replace(
            ctx, impl="ref", obs=None), {"ids": ids})
    sq = _sqnr_db(ref.float(), got.float())
    finite = bool(torch.isfinite(got.float()).all())
    print(f"[{backend}] full-width prefill logits, kernels vs impl=ref: SQNR "
          f"{sq} dB, finite {finite}, bitwise {bool(torch.equal(got, ref))}",
          flush=True)
    if not finite or sq < 30.0:
        raise AssertionError(f"[{backend}] full-width prefill logits disagree")
    prof = {"prefill": profile_prefill(cfg, params, ctx),
            "decode": profile_decode(cfg, params, ctx)}
    return {"launches": launches, "summary": summary, "profile": prof}


def _zero_counts() -> None:
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops

    for fn in _kernel_wrappers().values():
        fn.launches = 0
    for r in mm_ops.ROUTES:
        mm_ops.mxfp4_matmul.route_launches[r] = 0
    for r in cim_ops.ROUTES:
        cim_ops.cim_linear.route_launches[r] = 0
    for r in fa_ops.ROUTES:
        fa_ops.flash_attention.route_launches[r] = 0


def _read_counts() -> tuple[dict, dict]:
    """(launches by kernel, ``mxfp4_matmul`` launches by route)."""
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops

    return ({name: fn.launches for name, fn in _kernel_wrappers().items()},
            dict(mm_ops.mxfp4_matmul.route_launches))


def _cim_routes() -> dict:
    """``cim_linear`` launches by route since the counts were zeroed."""
    from repro_torch.kernels.cim_linear import ops as cim_ops

    return dict(cim_ops.cim_linear.route_launches)


def _engine(params, cfg, ctx):
    from repro_torch.serving import Engine, EngineConfig

    return Engine(params, cfg, dataclasses.replace(ctx, obs=None),
                  EngineConfig(lanes=4, num_slots=4, page_len=256,
                               prefill_len=M_PREFILL))


def _kernel_name(key: str) -> str:
    """The function name of a profiler kernel event (no namespace, template
    arguments or parameters)."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1]


def _own_launches(events) -> dict:
    """Launches of each wrapper's main kernel in a trace, by wrapper name
    (``MAIN_KERNELS``: one of them per wrapper launch)."""
    seen: dict = {}
    for ev in events:
        for wrapper, names in MAIN_KERNELS.items():
            if _kernel_name(ev.key) in names:
                seen[wrapper] = seen.get(wrapper, 0) + ev.count
    return seen


def _profiled(label: str, ctx, steps: int, step, prepare=None) -> dict:
    """Run ``step`` ``steps`` times under ``torch.profiler``: device time by
    kernel (device events only) against the window's wall clock, and the
    launch counts of the window. A window whose trace holds another count
    of some wrapper's main kernel than the wrapper's counter says is run
    again (``prepare``, if given, readies each window outside it); after
    ``PROFILE_ATTEMPTS`` such windows the last one's times of the short
    kernels are scaled to the counted launches, ``timer`` says so and a
    ``profile timer:`` line names them."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        _zero_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches, routes = _read_counts()
        events = _device_events(prof)
        seen = _own_launches(events)
        short = {k: (seen.get(k, 0), n) for k, n in launches.items()
                 if seen.get(k, 0) != n}
        if not short:
            break
    by_name = _device_kernels_ms(prof)
    timer = "trace"
    if short:
        timer = "trace, launch-count scaled"
        for ev in events:
            wrapper = next((w for w, names in MAIN_KERNELS.items()
                            if _kernel_name(ev.key) in names), None)
            if wrapper in short and short[wrapper][0]:
                got, want = short[wrapper]
                by_name[ev.key] *= want / got
        print(f"profile timer: {label} [{ctx.quant}]: {PROFILE_ATTEMPTS} "
              f"traces with other launch counts than the wrappers' "
              f"(traced, counted) {short}; the last one's times of those "
              f"kernels scaled to the counted launches", flush=True)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": device_ms / steps if device_ms else None,
           "device_busy_share": device_ms / wall_ms if device_ms else None,
           "timer": timer,
           "top_kernels_ms_per_step": {k: v / steps for k, v in top},
           "launches": {k: v for k, v in launches.items() if v},
           "mxfp4_matmul_routes": routes}
    print(label, json.dumps({"backend": ctx.quant} | out), flush=True)
    return out


def profile_prefill(cfg, params, ctx) -> dict:
    """One 192-token prefill through the engine (the request's first step)
    under ``torch.profiler``. Under ``mxfp4`` its linears must take the
    tensor-core route."""
    eng = _engine(params, cfg, ctx)
    rng = np.random.default_rng(9)
    eng.add_request(rng.integers(0, cfg.vocab_size, M_PREFILL // 3).tolist(),
                    max_new=2)
    eng.step()  # a warm prefill outside the window

    def prepare():  # finish what runs, then queue the prompt of the window
        while eng.sched.running or eng.sched.waiting:
            eng.step()
        eng.add_request(rng.integers(0, cfg.vocab_size, M_PREFILL).tolist(),
                        max_new=2)

    out = _profiled("prefill profile", ctx, 1, eng.step, prepare)
    if ctx.quant == "mxfp4_wonly" and not out["mxfp4_matmul_routes"]["wgmma"]:
        raise AssertionError("[mxfp4] the prefill did not take the wgmma "
                             f"route: {out['mxfp4_matmul_routes']}")
    if ctx.quant == "cim" and not _cim_routes()["wgmma"]:
        raise AssertionError("[cim] the prefill did not take the wgmma "
                             f"route: {_cim_routes()}")
    return out


def profile_decode(cfg, params, ctx, steps: int = 8) -> dict:
    """A steady window of decode steps (4 live lanes) under
    ``torch.profiler`` (the requests outlast every window it may take).
    Under ``mxfp4`` its linears (M = 4) must take the mma route only."""
    eng = _engine(params, cfg, ctx)
    rng = np.random.default_rng(5)
    for _ in range(4):
        eng.add_request(rng.integers(0, cfg.vocab_size, 128).tolist(),
                        max_new=PROFILE_ATTEMPTS * steps + 4)
    while len(eng.sched.running) < 4:  # the four prefills
        eng.step()
    eng.step()  # one decode step outside the window
    out = _profiled("decode profile", ctx, steps, eng.step)
    routes = out["mxfp4_matmul_routes"]
    if ctx.quant == "mxfp4_wonly" and (routes["wgmma"] or routes["fma"]
                                       or not routes["mma"]):
        raise AssertionError(f"[mxfp4] decode took the routes {routes}")
    cim_routes = _cim_routes()
    if ctx.quant == "cim" and (cim_routes["wgmma"]
                               or not cim_routes["splitk"]):
        raise AssertionError(f"[cim] decode took the routes {cim_routes}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "arning")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()

    def phase(name, fn, *a):
        out = fn(*a)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"phase {name} done at {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    rows = {"cim_linear": phase("cim_linear", check_cim_linear, dev,
                                M_PREFILL),
            "paged_decode_mx": phase("paged_decode_mx", check_paged_decode,
                                     dev),
            "mxfp4_matmul": phase("mxfp4_matmul", check_mxfp4_matmul, dev,
                                  M_PREFILL),
            "paged_decode": phase("paged_decode", check_paged_decode_float,
                                  dev),
            "flash_attention": phase("flash_attention", check_flash_attention,
                                     dev)}
    for backend in ("cim", "mxfp4"):
        phase(f"tiny {backend}", check_tiny_agreement, dev, backend)
    # one backend's model at a time: each run's model is freed on return
    runs = {b: phase(f"serve {b}", serve_full_width, b)
            for b in ("cim", "mxfp4")}
    launches = {k: max(r["launches"][k] for r in runs.values())
                for k in _kernel_wrappers()}

    def entry(name, replaces, pick, shape):
        main_row = next(r for r in rows[name] if pick(r))
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row.get("library_ms"),
                "call_ms": main_row["call_ms"],
                "kernel_route": main_row.get("route"),
                "shape": shape.format(**main_row)}

    w1 = (4,) + LINEAR_SHAPES[2]  # the decode step's ffn w1
    lin_shape = "M={m} K={k} N={n} (decode, ffn w1)"
    page_shape = "L={lanes} Hkv={hkv} G={g} Dh={dh} W={w} lengths {lengths}"
    kernels = [
        entry("cim_linear", "src/repro/kernels/cim_linear/kernel.py:127",
              lambda r: (r["m"], r["k"], r["n"]) == w1, lin_shape),
        entry("paged_decode_mx",
              "src/repro/kernels/paged_attention/kernel.py:275",
              lambda r: r["w"] == PAGES[-1][0], page_shape),
        entry("mxfp4_matmul", "src/repro/kernels/mxfp4_matmul/kernel.py:69",
              lambda r: (r["m"], r["k"], r["n"]) == w1, lin_shape),
        entry("paged_decode", "src/repro/kernels/paged_attention/kernel.py:228",
              lambda r: r["w"] == PAGES[-1][0], page_shape),
        entry("flash_attention",
              "src/repro/kernels/flash_attention/kernel.py:90",
              lambda r: (r["sq"], r["d"], r["dtype"], r["window"])
              == (FA_SHAPE[1], FA_SHAPE[4], "bf16", 0),
              "B={b} S={sq} H={h} Hkv={hkv} D={d} bf16 causal"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
