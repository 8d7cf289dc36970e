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
4. Serve ``--backend cim``: starcoder2-7b at full width with the depth cut
   to 8 of 32 layers, through the launcher's entry points: 8 staggered
   requests, 4 lanes, 6 slots, prompts up to 192 tokens, 64 new tokens.
   Every kernel's launch counter is zeroed just before and read just
   after: ``cim_linear`` and ``paged_decode_mx`` must have launched, the
   other kernels not. Output checks: every request's tokens are in the
   vocabulary and as many as asked; prefill logits of a 192-token prompt
   through the kernels agree with ``impl="ref"`` on the card (SQNR >= 30
   dB); a tiny model with the same weights gives the same logits on the
   card as on the CPU. Then 8 decode steps (4 live lanes) under
   ``torch.profiler``: device time by kernel and the device's busy share.
5. Serve ``--backend mxfp4`` the same way at full width and full depth (32
   layers): ``mxfp4_matmul`` and ``paged_decode`` must have launched,
   ``cim_linear`` and ``paged_decode_mx`` not; the same output checks and
   the decode profile.
6. Prints the kernels line, then the card's name and power limit, then
   the device line, as the last line.

Every measured shape is printed on a line of its own (``cim_linear {...}``,
``paged_decode_mx {...}``, ``mxfp4_matmul {...}``, ``paged_decode {...}``,
``flash_attention {...}``, ``serve {...}``, ``decode profile {...}``).
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
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12}
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
# (K, N) of the static linears at starcoder2-7b width: wq/wo, wk/wv, w1,
# w2, the LM head
LINEAR_SHAPES = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608),
              (4608, 49152)]
M_PREFILL = 192  # rows of a prefill linear (the served prompt length)
DECODE_DIMS = (4, 4, 9, 128)  # lanes, KV heads, heads per KV head, head_dim
PAGES = ((48, [0, 1, 33, 48]), (256, [0, 31, 129, 256]))  # W, lengths
# flash_attention at the prefill shape the model would give it:
# (B, S, H, Hkv, D) of starcoder2-7b with a 2048-token prompt
FA_SHAPE = (1, 2048, 36, 4, 128)


def _device_kernels_ms(prof) -> dict:
    """Device time by kernel name from a ``torch.profiler`` run: only the
    device's own events (a CPU op's self device time repeats its kernels'
    time, so it is not added again)."""
    from torch.autograd import DeviceType

    out: dict = {}
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            out[ev.key] = out.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    return out


def _device_ms(fn, reps: int) -> float:
    """Device time per call: the kernels that ``reps`` warmed calls launch,
    summed (``torch.profiler``), over ``reps``. Host dispatch is not in it;
    :func:`_time_ms` around one call includes it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_kernels_ms(prof).values())
    if total <= 0:
        raise AssertionError("the profiler saw no device time")
    return total / reps


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


def check_cim_linear(dev, m_prefill: int) -> list:
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.cim_linear.ref import cim_linear_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = cimlib.CIMConfig()
    rows = []
    for k, n in LINEAR_SHAPES:
        w = mxlib.quantize_w(torch.randn((k, n), generator=gen, device=dev)
                             * k ** -0.5)
        for m in (4, m_prefill):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16).float()
            cal = cimlib.calibrate_rowhist([x], w, cfg)
            got = cim_ops.cim_linear(x, w, cal, cfg=cfg)
            ref = cim_linear_ref(x, w, cal, cfg)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            ok = bool((err <= 1e-5 + 1e-5 * ref.abs()).all())
            n_bytes = m * k * 4 + k * n + (k // 32) * n + 8 + m * n * 4
            bound, by = _bound_ms(n_bytes, 2.0 * m * n * k, "int8")
            rows.append(dict(
                m=m, k=k, n=n, max_abs_err=float(err.max()),
                bitwise=bool(torch.equal(got, ref)), ok=ok,
                ms=_device_ms(lambda: cim_ops.cim_linear(x, w, cal, cfg=cfg), 20),
                call_ms=_time_ms(lambda: cim_ops.cim_linear(x, w, cal, cfg=cfg),
                                 20),
                plain_ms=_device_ms(lambda: cim_linear_ref(x, w, cal, cfg), 3),
                bound_ms=bound, bound_by=by))
            print("cim_linear", json.dumps(rows[-1]), flush=True)
            if not ok:
                raise AssertionError(f"cim_linear kernel disagrees with its "
                                     f"plain version at {(m, k, n)}")
    return rows


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
            max_abs_err=err, sqnr_vs_plain_db=sq_plain,
            sqnr_vs_dense_db=sq_dense, ok=ok, ms=_device_ms(kernel, 50),
            call_ms=_time_ms(kernel, 50), plain_ms=_device_ms(plain, 5),
            bound_ms=bound, bound_by=by))
        print("paged_decode_mx", json.dumps(rows_out[-1]), flush=True)
        if not ok:
            raise AssertionError(f"paged_decode_mx kernel disagrees at W={w}")
    return rows_out


def check_mxfp4_matmul(dev, m_prefill: int) -> list:
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
        for m in (4, m_prefill):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            got = mm_ops.mxfp4_matmul(x, codes, exps).float()
            ref = mxfp4_matmul_ref(x, codes, exps).float()
            torch.cuda.synchronize()
            err = (got - ref).abs()
            ok = bool((err <= 2e-2 * ref.abs() + 2e-2 * ref.abs().max()).all())
            n_bytes = 2 * m * k + k * n // 2 + k * n // 32 + 2 * m * n
            bound, by = _bound_ms(n_bytes, 2.0 * m * n * k, "bf16")
            rows.append(dict(
                m=m, k=k, n=n, max_abs_err=float(err.max()),
                sqnr_db=_sqnr_db(ref, got), ok=ok,
                ms=_device_ms(lambda: mm_ops.mxfp4_matmul(x, codes, exps), 20),
                call_ms=_time_ms(lambda: mm_ops.mxfp4_matmul(x, codes, exps),
                                 20),
                plain_ms=_device_ms(lambda: mxfp4_matmul_ref(x, codes, exps),
                                    3),
                bound_ms=bound, bound_by=by,
                library_ms=_device_ms(lambda: torch.matmul(x, w_bf16), 20)))
            print("mxfp4_matmul", json.dumps(rows[-1]), flush=True)
            if not ok:
                raise AssertionError(f"mxfp4_matmul kernel disagrees with its "
                                     f"plain version at {(m, k, n)}")
        del packed, codes, exps, w_bf16
    return rows


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
        rows_out.append(dict(
            lanes=lanes, hkv=hkv, g=g, dh=dh, w=w, bk=bk, lengths=lens,
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
    """At ``FA_SHAPE`` in bf16: causal over the whole prompt, a sliding
    window of half of it, and the last eighth of the queries at their
    offset (256 queries at 1792 for S = 2048)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, s, h, hkv, d = FA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(8)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q_full = torch.randn((b, s, h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    rows = []
    for sq, window, off in ((s, 0, 0), (s, s // 2, 0), (s // 8, 0, s - s // 8)):
        q = q_full[:, s - sq:].contiguous()
        kw = dict(causal=True, window=window, q_offset=off)
        got = fa_ops.flash_attention(q, k, v, **kw).float()
        ref = flash_attention_ref(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        ok = bool((err <= 1e-2 + 1e-2 * ref.abs()).all())
        qp = torch.arange(sq, device=dev)[:, None] + off
        kp = torch.arange(s, device=dev)[None, :]
        mask = kp <= qp
        if window:
            mask &= kp > qp - window
        pairs = float(mask.sum())
        n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bound, by = _bound_ms(n_bytes, 4.0 * b * h * d * pairs, "bf16")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        rows.append(dict(
            b=b, sq=sq, sk=s, h=h, hkv=hkv, d=d, window=window, q_offset=off,
            max_abs_err=float(err.max()), sqnr_db=_sqnr_db(ref, got), ok=ok,
            ms=_device_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 10),
            call_ms=_time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 10),
            plain_ms=_device_ms(lambda: flash_attention_ref(q, k, v, **kw), 3),
            bound_ms=bound, bound_by=by,
            library_ms=_device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 10)))
        print("flash_attention", json.dumps(rows[-1]), flush=True)
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees at "
                                 f"{(sq, window, off)}")
    return rows


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
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    summary = serve.serve_trace(args, cfg, params, ctx, obs, dev)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    print("serve", json.dumps({"backend": backend, "layers": cfg.n_layers}
                              | {k: v for k, v in summary.items() if k != "out"}
                              | {"launches": launches,
                                 "peak_mem_gib": peak / 2**30,
                                 "build_peak_mem_gib": build_peak / 2**30,
                                 "resident_params_gib": resident / 2**30,
                                 "model_build_s": build_s}), flush=True)
    own = OWN_KERNELS[backend]
    if any(launches[k] < 1 for k in own) or any(
            v for k, v in launches.items() if k not in own):
        raise AssertionError(f"[{backend}] launches {launches}: the path's "
                             f"own kernels are {own}, and only those")
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
    prof = profile_decode(cfg, params, ctx, dev)
    return {"launches": launches, "summary": summary, "profile": prof}


def profile_decode(cfg, params, ctx, dev, steps: int = 8) -> dict:
    """Device time by kernel over a steady window of decode steps (4 live
    lanes) under ``torch.profiler``, against the window's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Engine, EngineConfig

    eng = Engine(params, cfg, dataclasses.replace(ctx, obs=None),
                 EngineConfig(lanes=4, num_slots=4, page_len=256,
                              prefill_len=192))
    rng = np.random.default_rng(5)
    for _ in range(4):
        eng.add_request(rng.integers(0, cfg.vocab_size, 128).tolist(),
                        max_new=steps + 4)
    while len(eng.sched.running) < 4:  # the four prefills
        eng.step()
    eng.step()  # one decode step outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = _device_kernels_ms(prof)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": device_ms / steps if device_ms else None,
           "device_busy_share": device_ms / wall_ms if device_ms else None,
           "top_kernels_ms_per_step": {k: v / steps for k, v in top}}
    print("decode profile", json.dumps({"backend": ctx.quant} | out),
          flush=True)
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
            if "registers" in line or "spill" in line:
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
              lambda r: r["sq"] == FA_SHAPE[1] and r["window"] == 0,
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
