"""Serving launcher for the port: the LM served by the continuous-batching
engine on the fused paged KV pool.

``--backend mxfp4`` (default): every static linear is resident as packed
MXFP4 (4.25 bits/param) and runs through the hand-written
``mxfp4_matmul`` kernel; decode runs over float pages through the
``paged_flash_decode`` kernel. ``--backend cim``: the hybrid analog/digital
model; static linears are calibrated offline (Row-Hist) on synthetic
token batches, converted to resident INT5 codes and run on the analog
CTT-CIM arrays (``cim_linear`` kernel), SDPA runs on the digital MXFP4
path, decode through ``paged_flash_decode_mx`` over quantized-resident
pages. ``--backend float``: bf16 linears, float pages. Weights are random
from a seed.

``--arch vit-b16`` / ``--arch vit-l32`` (or ``--model``) serve the
paper's vision workloads instead: ``--frames`` synthetic frames stream one
at a time through the ViT (``serving/vision.py``; vit-l32 as a two-chip
chain, 12+12 layers, on the one device), and the measured token traffic
drives the FWS pipeline model of the MXFormer chip, checked against the
paper's Table 7 row. The ``vision-stream:`` line gives the device's own
frame rate (``fps_host``, host wall clock); the ``fws-pipeline:`` line
gives the analytical model's (``fws_model_fps``, beside ``paper_fps``),
not a speed of the device. ``--tiny`` (the default) keeps the token
geometry and layer count and shrinks the width; ``--no-tiny`` runs the
full model.

``--arrivals poisson:RATE | burst:N:GAP_S | trace:FILE`` replays an
arrival process on the host wall clock through the engine instead
(``serving/load.py``): mixed prompt and output lengths, shared system
prompts, the steps warmed up (and captured) on a throwaway request
first. Telemetry: ``--metrics-out PATH`` writes the run's metrics as a
JSON snapshot at PATH and the Prometheus text exposition beside it (a
``.prom`` suffix); ``--slo-ttft-ms`` / ``--slo-token-ms`` score the
finished requests against p99 targets (``obs/slo.py``).

Runs on CUDA unless ``--device cpu`` is given (then the kernels' plain
versions run); without a GPU and without ``--device cpu`` it raises.

  python -m repro_torch.launch.serve --no-tiny --serve-trace \\
      --backend mxfp4 --kv-layout fused     # full width, 32 layers
  python -m repro_torch.launch.serve --serve-trace --backend cim \\
      --kv-layout fused                     # tiny starcoder2-7b on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-trace \\
      --backend float --device cpu          # tiny, CPU plain versions
  python -m repro_torch.launch.serve --arch vit-b16 --no-tiny \\
      --backend cim --frames 64             # full ViT-B/16 on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch vit-l32 \\
      --backend mxfp4 --device cpu          # geometry-true tiny, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --backend cim --arrivals burst:4:0.05 --chunk-len 4 \\
      --policy chunked --prefix-cache --metrics-out /tmp/m.json \\
      --slo-ttft-ms 60000                   # load replay, tiny, CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch import obs as obs_lib
from repro_torch import resolve_device
from repro_torch.core import cim as cimlib
from repro_torch.layers.common import RunCtx, convert_params_mxfp4
from repro_torch.hwmodel import specs as S
from repro_torch.models import calibrate, lm, vit


def conversion_args(args) -> dict:
    """Backend-conversion knobs, read from the CLI in exactly one place;
    ``min_n`` gates MXFP4 packing and CIM conversion alike."""
    return dict(min_n=args.cim_min_n, adc_bits=args.adc_bits,
                cm_bits=args.cm_bits, calib_batches=args.calib_batches)


def build_backend(args, cfg, params, device, obs=None, batches=None,
                  forward_fn=None):
    """(converted_params, RunCtx) for ``--backend``: ``float`` serves the
    parameters as they are, ``mxfp4`` packs the static linears, ``cim``
    runs Row-Hist calibration and the analog conversion on ``batches``
    through ``forward_fn`` (default: token batches through
    ``lm.forward``; the vision path passes images and ``vit.forward``)."""
    conv_kw = conversion_args(args)
    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    if args.backend == "float":
        return params, RunCtx(dense_attn_max=256, obs=obs)
    if args.backend == "mxfp4":
        return (convert_params_mxfp4(params, min_n=conv_kw["min_n"]),
                RunCtx(quant="mxfp4_wonly", dense_attn_max=256, obs=obs))
    if args.backend != "cim":
        raise SystemExit(f"unknown --backend {args.backend!r}")
    cim_cfg = cimlib.CIMConfig(adc_bits=conv_kw["adc_bits"],
                               cm_bits=conv_kw["cm_bits"], two_pass=True)
    base_ctx = RunCtx(dense_attn_max=256)
    if batches is None:
        batches = calibrate.calibration_batches(
            cfg, n_batches=conv_kw["calib_batches"], batch=args.batch,
            seq=args.prompt_len, device=device)
    t0 = time.perf_counter()
    conv, calibs = calibrate.convert_model_cim(
        params, cfg, base_ctx, batches, cim_cfg=cim_cfg,
        min_n=conv_kw["min_n"], forward_fn=forward_fn)
    log.info("row-hist calibration: %s", obs_lib.kv(
        linears=len(calibs), wall_s=time.perf_counter() - t0))
    return conv, RunCtx(quant="cim", cim=cim_cfg, dense_attn_max=256, obs=obs)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# serve_trace summary keys that hold data, not figures
SUMMARY_DATA = ("ecfg", "prompts", "out")


def page_budget(cfg, prompt_len: int, tokens: int) -> tuple[int, int]:
    """(page_len, prefill_len) of a serve: a page takes the prompt and its
    new tokens, but stays inside the narrowest attention window (no ring
    wrap; gemma3-1b's 512-slot local layers cap it at 512), as in the
    reference's launcher; the prefill gets what the new tokens leave."""
    windows = [s.attn.window for s in lm.build_segments(cfg)
               if s.attn.window > 0]
    page_len = prompt_len + tokens
    if windows:
        page_len = min(page_len, min(windows))
    return page_len, max(2, page_len - tokens)


def _finish_metrics(args, obs: obs_lib.Obs, log) -> dict | None:
    """Score SLOs (when targets are given) and write the metrics snapshot
    (``--metrics-out``). Returns the SLO report, or None without
    targets."""
    targets = obs_lib.SLOTargets(
        ttft_p99_s=args.slo_ttft_ms / 1e3 if args.slo_ttft_ms else None,
        token_p99_s=args.slo_token_ms / 1e3 if args.slo_token_ms else None,
    )
    slo = None
    if any(v is not None for v in targets.asdict().values()):
        slo = obs_lib.evaluate_slo(obs.finished, targets)
        log.info("slo: %s", obs_lib.kv(
            ok=slo["pass"], **{k: v for k, v in slo["violations"].items()}))
    if args.metrics_out:
        extra = {"requests": obs.request_summary()}
        if slo is not None:
            extra["slo"] = slo
        jp, pp = obs_lib.write_metrics(obs.registry, args.metrics_out,
                                       extra=extra)
        log.info("metrics written: %s", obs_lib.kv(json=jp, prom=pp))
    return slo


def serve_trace(args, cfg, params, ctx, obs: obs_lib.Obs, device) -> dict:
    """A burst of staggered synthetic requests through the engine.
    Returns a summary: requests, tokens, wall, tokens/s, TTFT and
    decode-step percentiles (host wall clock, steps end in a host read),
    and the prompts and their tokens by request id."""
    from repro_torch.serving import Engine, EngineConfig

    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    page_len, prefill_len = page_budget(cfg, args.prompt_len, args.tokens)
    ecfg = EngineConfig(lanes=args.lanes, num_slots=args.slots,
                        page_len=page_len, prefill_len=prefill_len,
                        policy=args.policy, kv_layout=args.kv_layout,
                        chunk_len=args.chunk_len or None,
                        prefix_cache=args.prefix_cache)
    eng = Engine(params, cfg, ctx, ecfg, obs=obs)
    rng = np.random.default_rng(args.seed)
    prompts = {}
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        n = int(rng.integers(2, prefill_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=n).tolist()
        rid = eng.add_request(prompt, max_new=min(args.tokens, page_len - n))
        prompts[rid] = prompt
        for _ in range(int(rng.integers(0, 3))):  # staggered arrivals
            eng.step()
    out = eng.run()
    _sync(device)
    wall = time.perf_counter() - t0
    n_tok = sum(len(v) for v in out.values())
    host = obs.request_summary()
    dec = [e.wall_s for e in obs.steps if e.kind == "decode"]
    pre = [e.wall_s for e in obs.steps if e.kind == "prefill"]
    summary = {
        "requests": len(out), "tokens": n_tok, "wall_s": wall,
        "tok_s": n_tok / wall, "page_len": page_len,
        "prefill_len": prefill_len, "decode_steps": len(dec),
        "decode_step_ms_p50": float(np.median(dec)) * 1e3 if dec else None,
        "prefill_ms_p50": float(np.median(pre)) * 1e3 if pre else None,
        "ttft_ms_p50": host["ttft_s"]["p50"] * 1e3 if host["ttft_s"] else None,
        "ttft_ms_p99": host["ttft_s"]["p99"] * 1e3 if host["ttft_s"] else None,
        "slot_util": eng.slot_utilization, "prefix": eng.prefix_stats(),
        "ecfg": ecfg, "prompts": prompts, "out": out,
    }
    log.info("%s [%s] serve-trace done: %s", cfg.name, args.backend,
             obs_lib.kv(**{k: v for k, v in summary.items()
                           if k not in SUMMARY_DATA + ("prefix",)}))
    if eng.prefix is not None:
        log.info("prefix-cache: %s", obs_lib.kv(**eng.prefix_stats()))
    _finish_metrics(args, obs, log)
    return summary


def serve_load(args, cfg, params, ctx, obs: obs_lib.Obs, device) -> dict:
    """``--arrivals``: the trace-driven load harness. Replays a Poisson,
    scripted-burst or recorded arrival process with mixed prompt and
    output lengths (and shared system prompts, what the prefix cache
    deduplicates) through the engine on the host wall clock, then scores
    SLOs and publishes the load report. Returns ``{"report": the load
    report, "slo": the SLO report or None, "trace", "out": tokens by
    request id, "ecfg", "graphs": each captured step's capture s and pool
    MiB}``."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving import load as load_mod

    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    page_len, prefill_len = page_budget(cfg, args.prompt_len, args.tokens)
    chunk = args.chunk_len or None
    ecfg = EngineConfig(lanes=args.lanes, num_slots=args.slots,
                        page_len=page_len, prefill_len=prefill_len,
                        policy=args.policy, kv_layout=args.kv_layout,
                        chunk_len=chunk, prefix_cache=args.prefix_cache)
    eng = Engine(params, cfg, ctx, ecfg, obs=obs)

    kind, val = load_mod.parse_arrivals(args.arrivals)
    rng = np.random.default_rng(args.seed)
    if kind == "trace":
        trace = load_mod.load_trace(val)
    else:
        max_prompt = (page_len if chunk else prefill_len) - 1
        sys_len = max(2, min(2 * chunk if chunk else 4, max_prompt - 2))
        spec = load_mod.WorkloadSpec(
            vocab_size=cfg.vocab_size,
            prompt_len=(2, max(2, max_prompt - sys_len)),
            out_len=(2, max(2, args.tokens)),
            system_len=sys_len, max_prompt=max_prompt)
        reqs = load_mod.synth_requests(spec, args.requests, rng)
        times = (load_mod.poisson_arrivals(val, len(reqs), rng)
                 if kind == "poisson"
                 else load_mod.burst_arrivals(len(reqs), *val))
        trace = load_mod.make_trace(times, reqs)

    # warm the steps up (on CUDA: capture their graphs) on a throwaway
    # request, so the replay's arrival clock measures serving
    eng.add_request(list(trace[0].prompt), max_new=2)
    eng.run()
    obs.reset()

    log.info("load: replaying %s", obs_lib.kv(
        arrivals=args.arrivals, requests=len(trace), chunk_len=chunk or 0,
        prefix_cache=args.prefix_cache, policy=ecfg.policy))
    res = load_mod.replay(eng, trace)
    rep = load_mod.load_report(eng, wall_s=res["wall_s"])
    eng.trace_report().publish(obs.registry)
    ttft = rep["ttft_s"] or {}
    tokl = rep["token_latency_s"] or {}
    log.info("load done: %s", obs_lib.kv(
        requests=rep["n_requests"], tokens=rep["tokens_generated"],
        wall_s=rep["wall_s"], tok_s=rep["tokens_per_s_wall"],
        ttft_p50_ms=ttft.get("p50", 0) * 1e3,
        ttft_p99_ms=ttft.get("p99", 0) * 1e3,
        token_p50_ms=tokl.get("p50", 0) * 1e3,
        token_p99_ms=tokl.get("p99", 0) * 1e3,
        page_evictions=rep["page_evictions"]))
    if rep["prefix"]:
        log.info("prefix-cache: %s", obs_lib.kv(**rep["prefix"]))
    slo = _finish_metrics(args, obs, log)
    graphs = {name: {"capture_s": g.capture_s,
                     "pool_mib": (g.pool_bytes or 0) / 2**20}
              for name, g in eng.graphs.items() if g.graph is not None}
    return {"report": rep, "slo": slo, "trace": trace, "out": res["out"],
            "ecfg": ecfg, "graphs": graphs}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", "--model", dest="arch", default="starcoder2-7b",
                    choices=sorted(C.ARCHS | C.VISION_ARCHS),
                    help="an LM (served by the continuous-batching engine) "
                         "or a vision workload (streamed frames)")
    ap.add_argument("--tiny", action="store_true", default=True,
                    help="reduced smoke config (default)")
    ap.add_argument("--no-tiny", dest="tiny", action="store_false",
                    help="run the full-size architecture")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, widths kept "
                         "(0: the config's own depth)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and requests")
    ap.add_argument("--batch", type=int, default=4,
                    help="calibration batch size")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--backend", default="mxfp4",
                    choices=("float", "mxfp4", "cim"),
                    help="linear backend: packed MXFP4 weight-only "
                         "(default), hybrid analog CIM, or bf16")
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--cim-min-n", type=int, default=32)
    ap.add_argument("--adc-bits", type=int, default=10)
    ap.add_argument("--cm-bits", type=int, default=3)
    ap.add_argument("--serve-trace", action="store_true",
                    help="continuous-batching engine run over staggered "
                         "synthetic requests (the ported serving mode)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--slots", type=int, default=6)
    ap.add_argument("--kv-layout", default="fused", choices=("fused",))
    ap.add_argument("--policy", default="prefill",
                    choices=("prefill", "decode", "chunked"),
                    help="admission policy; 'chunked' interleaves prefill "
                         "chunks with decode steps (needs --chunk-len)")
    ap.add_argument("--chunk-len", type=int, default=0,
                    help="chunked prefill: run prompts through a fixed "
                         "[1, chunk_len] step in absolute-position "
                         "windows, lifting the prompt cap from "
                         "prefill_len to page_len (0 = single-shot "
                         "padded prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the KV page pool: "
                         "shared prompt prefixes reuse refcounted, "
                         "content-addressed pages (requires --chunk-len)")
    ap.add_argument("--arrivals", default=None,
                    help="trace-driven load harness: replay this arrival "
                         "process through the engine on the host wall "
                         "clock (poisson:RATE | trace:FILE | "
                         "burst:N:GAP_S) instead of the --serve-trace "
                         "staggered run")
    ap.add_argument("--frames", type=int, default=4,
                    help="synthetic frames streamed (vision archs)")
    ap.add_argument("--metrics-out", default=None,
                    help="write a JSON metrics snapshot here (plus the "
                         "Prometheus text exposition at the same path "
                         "with a .prom suffix)")
    ap.add_argument("--log-level", default="info", choices=obs_lib.log.LEVELS)
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT p99 SLO target in ms (host wall)")
    ap.add_argument("--slo-token-ms", type=float, default=None,
                    help="per-token latency p99 SLO target in ms")
    return ap


def build_model(args, obs=None):
    """Config, converted parameters and RunCtx for the run: random weights
    from ``--seed`` on the run's device, converted for ``--backend``.
    Raises if CUDA is asked for (the default) and missing."""
    device = resolve_device(args.device)
    cfg = C.tiny(C.ARCHS[args.arch]) if args.tiny else C.ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        fparams = lm.init_model(cfg, gen)
        params, ctx = build_backend(args, cfg, fparams, device, obs=obs)
    del fparams
    log.info("model ready: %s", obs_lib.kv(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        device=str(device), wall_s=time.perf_counter() - t0))
    return cfg, params, ctx, device


def build_vision_model(args, obs=None):
    """Config, converted parameters and RunCtx of a vision arch: random
    weights from ``--seed``; ``cim`` calibrates on synthetic images
    (``vit.calibration_images``). ``--tiny`` keeps the token geometry
    (patch grid, layers, chips) and shrinks the width."""
    device = resolve_device(args.device)
    full = C.VISION_ARCHS[args.arch]
    cfg = C.geometry_tiny_vit(full) if args.tiny else full
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        fparams = vit.init_model(cfg, gen)
        batches = vit.calibration_images(
            cfg, n_batches=args.calib_batches, batch=args.batch,
            device=device) if args.backend == "cim" else None
        params, ctx = build_backend(args, cfg, fparams, device, obs=obs,
                                    batches=batches, forward_fn=vit.forward)
    del fparams, batches
    log.info("model ready: %s", obs_lib.kv(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        tokens=cfg.seq_len, chips=cfg.chips, device=str(device),
        wall_s=time.perf_counter() - t0))
    return cfg, params, ctx, device


def serve_vision(args, cfg, params, ctx, obs: obs_lib.Obs, device) -> dict:
    """Stream ``--frames`` synthetic frames through the ViT (one at a
    time, the Table 7 operating mode), then map the measured stage
    traffic onto the FWS pipeline model at the workload's hardware shape.
    Returns a summary: the device's own frame rate and frame wall times
    (host wall clock, each frame ends in a host read), and, apart, the
    analytical model's ``fws_model_fps`` beside the paper's."""
    from repro_torch.serving import VisionEngine

    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    eng = VisionEngine(params, cfg, ctx, obs=obs)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    frames = torch.randn((args.frames, cfg.image_size, cfg.image_size,
                          cfg.in_channels), generator=gen, device=device)
    _sync(device)
    t0 = time.perf_counter()
    labels = eng.stream(frames)
    _sync(device)
    wall = time.perf_counter() - t0
    frame_s = [e.wall_s for e in obs.steps if e.kind == "frame"]
    summary = {"model": cfg.name, "backend": args.backend,
               "layers": cfg.n_layers, "chips": eng.chips,
               "frames": len(labels), "tokens_each": cfg.seq_len,
               "wall_s": wall, "fps_host": len(labels) / wall,
               "frame_ms_p50": float(np.median(frame_s)) * 1e3,
               "top1": labels}
    log.info("%s [%s] vision-stream: %s", cfg.name, args.backend,
             obs_lib.kv(**{k: v for k, v in summary.items()
                           if k not in ("model", "backend")}))
    workload = cfg.name if cfg.name in S.WORKLOADS else None
    rep = eng.fws_report(workload=workload)
    rep.publish(obs.registry)
    fws = dict(chips=rep.chips, d=rep.d_model, n_tokens=rep.n_tokens,
               fws_model_fps=rep.fps,
               frame_latency_us=rep.frame_latency_s * 1e6,
               stage_occupancy=rep.pipeline.stage_utilization,
               bubble=rep.pipeline.bubble_fraction)
    if rep.paper_fps:
        fws.update(paper_fps=rep.paper_fps, err_pct=100 * rep.fps_error)
    log.info("fws-pipeline: %s", obs_lib.kv(**fws))
    _finish_metrics(args, obs, log)
    return summary | {"fws": fws}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.arch in C.VISION_ARCHS:
        obs = obs_lib.Obs()
        cfg, params, ctx, device = build_vision_model(args, obs=obs)
        return serve_vision(args, cfg, params, ctx, obs, device)
    if not (args.serve_trace or args.arrivals):
        raise SystemExit("only --serve-trace and --arrivals are ported (the "
                         "greedy legacy-cache decode is in ROADMAP.md "
                         "Queue 1)")
    obs = obs_lib.Obs()
    cfg, params, ctx, device = build_model(args, obs=obs)
    if args.arrivals:
        return serve_load(args, cfg, params, ctx, obs, device)
    return serve_trace(args, cfg, params, ctx, obs, device)


if __name__ == "__main__":
    main()
