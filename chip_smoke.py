#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. Device: exits non-zero without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel from ``src/repro_torch/csrc`` (one nvcc
   each, in parallel) into the git-ignored ``build/kernels``.
3. Kernels against their plain PyTorch versions, on the card, at the
   shapes the serving path gives them; times (CUDA events, warmed,
   median), the plain version's time and the bound (bytes over 3.35 TB/s
   vs operations over the peak rate of their type, H100 SXM data sheet).
4. Serve: starcoder2-7b at full width with the depth cut to 8 of 32
   layers, ``--backend cim --kv-layout fused``, through the launcher's
   entry points: 8 staggered requests, 4 lanes, 6 slots, prompts up to
   192 tokens, 64 new tokens. Both kernels' launch counters are zeroed
   just before and read just after; each must have launched. Output
   checks: every request's tokens are in the vocabulary and as many as
   asked; prefill logits of a 192-token prompt through the kernels agree
   with the plain versions on the card (SQNR >= 30 dB); a tiny model with
   the same weights gives the same logits on the card as on the CPU.
5. Profiles 8 decode steps (4 live lanes) with ``torch.profiler``:
   device time by kernel and the device's busy share of the wall clock.
6. Prints the kernels line, then the device line, as the last line.

Every measured shape is printed on a line of its own (``cim_linear {...}``,
``paged_decode_mx {...}``, ``serve {...}``, ``decode profile {...}``).
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
SERVE_ARGS = ["--no-tiny", "--layers", "8", "--serve-trace", "--backend",
              "cim", "--kv-layout", "fused", "--requests", "8", "--lanes",
              "4", "--slots", "6", "--prompt-len", "192", "--tokens", "64",
              "--calib-batches", "2", "--batch", "2"]
CIM_SHAPES = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608),
              (4608, 49152)]


def _time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median of ``reps`` CUDA-event-timed calls after ``warm`` calls."""
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
    for k, n in CIM_SHAPES:
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
                ms=_time_ms(lambda: cim_ops.cim_linear(x, w, cal, cfg=cfg), 20),
                plain_ms=_time_ms(lambda: cim_linear_ref(x, w, cal, cfg), 3, 1),
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

    lanes, hkv, g, dh, pool = 4, 4, 9, 128, 10
    scale = dh ** -0.5
    gen = torch.Generator(device=dev).manual_seed(2)
    rows_out = []
    for w, lens in ((48, [0, 1, 33, 48]), (256, [0, 31, 129, 256])):
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
            sqnr_vs_dense_db=sq_dense, ok=ok, ms=_time_ms(kernel, 50),
            plain_ms=_time_ms(plain, 5, 1), bound_ms=bound, bound_by=by))
        print("paged_decode_mx", json.dumps(rows_out[-1]), flush=True)
        if not ok:
            raise AssertionError(f"paged_decode_mx kernel disagrees at W={w}")
    return rows_out


def check_tiny_agreement(dev) -> None:
    """The tiny model with the same weights on the card (kernels) and on
    the CPU (plain versions): prefill into a fused page, then
    teacher-forced decode steps; logits SQNR >= 30 dB at every step."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(
        ["--serve-trace", "--device", "cpu", "--log-level", "warning"])
    cfg, cpu_params, ctx, cpu = serve.build_model(args)
    ids = torch.randint(0, cfg.vocab_size, (1, 40),
                        generator=torch.Generator().manual_seed(4))
    runs = []
    with torch.no_grad():
        for params, d in ((cpu_params, cpu), (_to(cpu_params, dev), dev)):
            caches = lm.init_cache(cfg, 1, 48, mx_digital=True, fused=True,
                                   device=d)
            lo, caches = lm.forward(params, cfg, ctx,
                                    {"ids": ids[:, :36].to(d)}, caches=caches)
            steps = [lo[:, -1]]
            for p in range(36, 40):
                lo, caches = lm.decode_step(params, cfg, ctx,
                                            ids[:, p:p + 1].to(d), p, caches)
                steps.append(lo)
            runs.append([t.float().cpu() for t in steps])
    sq = [_sqnr_db(a, b) for a, b in zip(*runs)]
    print(f"tiny model, card vs CPU plain versions, logits SQNR per step "
          f"(prefill, 4 decode): {sq}", flush=True)
    if min(sq) < 30.0:
        raise AssertionError("tiny model: card and CPU logits disagree")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def serve_full_width():
    from repro_torch import obs as obs_lib
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(SERVE_ARGS)
    obs = obs_lib.Obs()
    t0 = time.perf_counter()
    cfg, params, ctx, dev = serve.build_model(args, obs=obs)
    print(f"depth cut: {cfg.name} n_layers 32 -> {cfg.n_layers} (full width: "
          f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size})",
          flush=True)
    build_s = time.perf_counter() - t0
    resident = sum(t.numel() * t.element_size() for t in _leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cim_ops.cim_linear.launches = 0
    pops.ragged_paged_decode.launches = 0
    summary = serve.serve_trace(args, cfg, params, ctx, obs, dev)
    launches = {"cim_linear": cim_ops.cim_linear.launches,
                "paged_decode_mx": pops.ragged_paged_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    print("serve", json.dumps({k: v for k, v in summary.items() if k != "out"}
                              | {"launches": launches,
                                 "peak_mem_gib": peak / 2**30,
                                 "resident_params_gib": resident / 2**30,
                                 "model_build_s": build_s}), flush=True)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
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
    print(f"full-width prefill logits, kernels vs plain: SQNR {sq} dB, "
          f"finite {finite}, bitwise {bool(torch.equal(got, ref))}", flush=True)
    if not finite or sq < 30.0:
        raise AssertionError("full-width prefill logits disagree")
    profile_decode(cfg, params, ctx, dev)
    return launches


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
    by_name: dict = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": device_ms / steps if device_ms else None,
           "device_busy_share": device_ms / wall_ms if device_ms else None,
           "top_kernels_ms_per_step": {k: v / steps for k, v in top}}
    print("decode profile", json.dumps(out), flush=True)
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

    cim_rows = check_cim_linear(dev, 192)
    paged_rows = check_paged_decode(dev)
    check_tiny_agreement(dev)
    launches = serve_full_width()

    main_cim = next(r for r in cim_rows if (r["m"], r["k"], r["n"])
                    == (4, 4608, 18432))
    main_paged = next(r for r in paged_rows if r["w"] == 256)
    kernels = [
        {"name": "cim_linear", "route": "cuda",
         "source": "src/repro_torch/csrc/cim_linear.cu",
         "replaces": "src/repro/kernels/cim_linear/kernel.py:127",
         "launches": launches["cim_linear"],
         "max_abs_err": max(r["max_abs_err"] for r in cim_rows),
         "ms": main_cim["ms"], "plain_ms": main_cim["plain_ms"],
         "bound_ms": main_cim["bound_ms"], "bound_by": main_cim["bound_by"],
         "library_ms": None, "shape": "M=4 K=4608 N=18432 (decode, ffn w1)"},
        {"name": "paged_decode_mx", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode_mx.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:275",
         "launches": launches["paged_decode_mx"],
         "max_abs_err": max(r["max_abs_err"] for r in paged_rows),
         "ms": main_paged["ms"], "plain_ms": main_paged["plain_ms"],
         "bound_ms": main_paged["bound_ms"],
         "bound_by": main_paged["bound_by"], "library_ms": None,
         "shape": "L=4 Hkv=4 G=9 Dh=128 W=256 lengths 0/31/129/256"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
