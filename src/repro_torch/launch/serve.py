"""Serving launcher for the port. Without ``--serve-trace`` or
``--arrivals`` (the reference's default) the LM greedy-decodes a batch of
random prompts from the legacy split K/V cache and the recurrent states
(:func:`greedy_decode`, the only way the recurrent archs xlstm-125m and
zamba2-1.2b are served; hubert-xlarge is encoder-only and exits); with
them it is served by the continuous-batching engine on a paged KV pool,
``--kv-layout legacy`` (the default, as in the reference: split K/V
pages, gathered and scattered around each decode step) or ``fused``
(decoded in place by the paged decode kernels).

``--backend mxfp4`` (default): every static linear is resident as packed
MXFP4 (4.25 bits/param) and runs through the hand-written
``mxfp4_matmul`` kernel; decode runs over float pages (on a fused pool
through the ``paged_flash_decode`` kernel). ``--backend cim``: the
hybrid analog/digital model; static linears are calibrated offline
(Row-Hist) on synthetic token batches, converted to resident INT5 codes
and run on the analog CTT-CIM arrays (``cim_linear`` kernel), SDPA runs
on the digital MXFP4 path, decode over quantized-resident pages (on a
fused pool through ``paged_flash_decode_mx``). ``--backend float``: bf16
linears, float pages. Weights are random from a seed.

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
finished requests against p99 targets (``obs/slo.py``); ``--profile``
records each eager kernel call's wall time after a device synchronize
(``kernel_wall_seconds``); ``--log-every N`` logs a progress line every N
engine steps. ``--fidelity`` runs a numerical-fidelity pass over the
freshly built serving tree before serving (``obs/fidelity.py``: per-layer
SQNR against the float tree, MXFP4 clip / underflow counters, ADC
saturation and code-utilization histograms, the calibration-drift check);
its metrics land in the ``--metrics-out`` snapshot. ``--impl ref`` runs
the reference's own compositions instead of the kernels, eagerly.

``--stages S`` / ``--mesh RxS`` (with ``--microbatches M``) run the
forward stage-parallel instead (``distributed/pipeline_exec.py``): the
layer stack cut into S stages, each resident on its own device of an R x
S grid (one CUDA device a grid place; with ``--device cpu`` the places
share the host), microbatches streamed stage to stage on the GPipe
schedule. A vision arch streams its frames through the pipeline and adds
the ``pipelined mesh:`` and ``fws-pipeline-measured:`` lines (the
device's own measured stage walls, bubble and frame rate); an LM runs
the prefill / scoring forward on a batch of ``--batch`` prompts,
measured, and held to the one-device forward (``parity=bitwise`` or
``diverged``). :func:`serve_vision` and :func:`serve_pipelined_lm` also
take a ready grid (``mesh=``), which may repeat one device.

Runs on CUDA unless ``--device cpu`` is given (then the kernels' plain
versions run); without a GPU and without ``--device cpu`` it raises.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --device cpu                          # greedy decode, tiny, CPU
  python -m repro_torch.launch.serve --arch xlstm-125m --no-tiny \\
      --batch 4 --prompt-len 512 --tokens 64  # greedy decode, full width
  python -m repro_torch.launch.serve --no-tiny --serve-trace \\
      --backend mxfp4 --kv-layout fused     # full width, 32 layers
  python -m repro_torch.launch.serve --serve-trace \\
      --backend cim                         # tiny, GPU, legacy pool
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-trace \\
      --device cpu --kv-layout legacy --chunk-len 4 --policy chunked \\
      --prefix-cache                        # legacy pool, chunked, CPU
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
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --backend cim --serve-trace --fidelity \\
      --metrics-out /tmp/f.json             # fidelity pass, tiny, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch vit-l32 \\
      --device cpu --stages 2 --microbatches 4 --frames 8  # 2 stages
  python -m repro_torch.launch.serve --no-tiny --layers 8 --backend cim \\
      --mesh 1x4 --microbatches 2 --prompt-len 192  # 4 cards, 4 stages
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
                  forward_fn=None, free_float: bool = False):
    """(converted_params, RunCtx) for ``--backend``: ``float`` serves the
    parameters as they are, ``mxfp4`` packs the static linears and the
    MoE expert banks, ``cim`` runs Row-Hist calibration and the analog
    conversion on ``batches`` through ``forward_fn`` (default: token
    batches through ``lm.forward``; the vision path passes images and
    ``vit.forward``).
    With ``free_float`` the conversion drops each float layer of
    ``params`` once it is converted (the conversions' ``free``)."""
    conv_kw = conversion_args(args)
    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    kw = dict(dense_attn_max=256, impl=args.impl, obs=obs)
    if args.backend == "float":
        return params, RunCtx(**kw)
    if args.backend == "mxfp4":
        return (convert_params_mxfp4(params, min_n=conv_kw["min_n"],
                                     free=free_float),
                RunCtx(quant="mxfp4_wonly", **kw))
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
        min_n=conv_kw["min_n"], forward_fn=forward_fn, free=free_float)
    log.info("row-hist calibration: %s", obs_lib.kv(
        linears=len(calibs), wall_s=time.perf_counter() - t0))
    return conv, RunCtx(quant="cim", cim=cim_cfg, **kw)


def run_fidelity(args, cfg, fparams, params, ctx, obs: obs_lib.Obs, batch,
                 forward_fn=None) -> dict:
    """``--fidelity``: one numerical-fidelity pass over the serving tree
    (``obs.run_fidelity_pass``), published into the run's registry: per
    layer SQNR against the float tree, quantizer / ADC health and the
    calibration-drift check. Under ``cim`` the reference runs on the
    digital MXFP4 path (the calibration-matched distribution, so the
    analog stack's noise stands alone); under the other backends on bf16
    float (all the quantization error). Returns the pass's report with
    its wall seconds (``wall_s``, ending in a device synchronize)."""
    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    device = batch[next(iter(batch))].device
    ref_quant = "mxfp4_digital" if args.backend == "cim" else "none"
    _sync(device)
    t0 = time.perf_counter()
    _, rep = obs_lib.run_fidelity_pass(
        fparams, params, cfg, ctx, batch, obs=obs, forward_fn=forward_fn,
        ref_quant=ref_quant, quant=ctx.quant, min_n=args.cim_min_n)
    _sync(device)
    rep["wall_s"] = time.perf_counter() - t0
    log.info("fidelity: %s", obs_lib.kv(
        layers=len(rep["layers"]), output_sqnr_db=rep["sqnr_db"]["output"],
        drifted=rep["drift"]["n_drifted"], wall_s=rep["wall_s"]))
    return rep


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pipeline_shape(args) -> tuple[int, int] | None:
    """(replicas, stages) from ``--mesh RxS`` / ``--stages``, or None when
    pipelined execution is off."""
    if args.mesh:
        try:
            r, s = args.mesh.lower().split("x")
            shape = (int(r), int(s))
        except ValueError:
            raise SystemExit(f"--mesh wants REPLICASxSTAGES, got "
                             f"{args.mesh!r}")
        if shape[0] < 1 or shape[1] < 1:
            raise SystemExit(f"--mesh axes must be >= 1, got {args.mesh!r}")
        return shape
    if args.stages:
        return (1, args.stages)
    return None


def pipeline_mesh(pshape: tuple[int, int], device):
    """The grid of ``pshape`` (replicas, stages): one CUDA device a grid
    place (raises with fewer cards), or the host for every place under
    ``--device cpu``."""
    from repro_torch.distributed import pipeline_exec as pex

    replicas, stages = pshape
    devices = ([device] * (replicas * stages) if device.type == "cpu"
               else None)
    return pex.make_pipeline_mesh(stages, replicas, devices=devices)


def _captures(ctx, mesh) -> bool:
    """Whether the pipelined step is captured: on one card, not under
    ``impl="ref"`` (a grid over several cards runs eagerly)."""
    return ctx.impl != "ref" and len(
        {d for row in mesh.devices for d in row}) == 1


# serve_trace summary keys that hold data, not figures
SUMMARY_DATA = ("ecfg", "prompts", "out")


def page_budget(cfg, prompt_len: int, tokens: int) -> tuple[int, int]:
    """(page_len, prefill_len) of a serve: a page takes the prompt and its
    new tokens, but stays inside the narrowest attention window (no ring
    wrap; gemma3-1b's 512-slot local layers cap it at 512), as in the
    reference's launcher; the prefill gets what the new tokens leave."""
    windows = [s.attn.window for s in lm.build_segments(cfg)
               if s.attn is not None and s.attn.window > 0]
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
                        prefix_cache=args.prefix_cache,
                        cuda_graphs=ctx.impl != "ref")
    eng = Engine(params, cfg, ctx, ecfg, obs=obs)
    rng = np.random.default_rng(args.seed)
    prompts = {}
    _sync(device)
    t0 = time.perf_counter()
    tokens_done = 0

    def step_logged():
        nonlocal tokens_done
        eng.step()
        if not obs.steps:
            return
        ev = obs.steps[-1]
        tokens_done += len(ev.rids) if ev.kind == "decode" else 1
        if len(obs.steps) % args.log_every == 0:
            log.info("progress %s", obs_lib.kv(
                step=len(obs.steps), live=eng.sched.num_active,
                free_slots=eng.kv.num_free, queued=len(eng.sched.waiting),
                tokens=tokens_done,
                tok_s=tokens_done / max(time.perf_counter() - t0, 1e-9)))

    for _ in range(args.requests):
        n = int(rng.integers(2, prefill_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=n).tolist()
        rid = eng.add_request(prompt, max_new=min(args.tokens, page_len - n))
        prompts[rid] = prompt
        for _ in range(int(rng.integers(0, 3))):  # staggered arrivals
            step_logged()
    while eng.sched.has_work:
        step_logged()
    out = {rid: list(r.out) for rid, r in eng.requests.items()}
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
                        chunk_len=chunk, prefix_cache=args.prefix_cache,
                        cuda_graphs=ctx.impl != "ref")
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


def _copy_into(dst, src) -> None:
    """Copy each tensor leaf of ``src`` into ``dst``'s (a ``None`` on
    either side skips that subtree)."""
    if dst is None or src is None:
        return
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy_into(v, src[k])
    elif isinstance(dst, list):
        for d, t in zip(dst, src):
            _copy_into(d, t)
    else:
        dst.copy_(src)


@torch.no_grad()
def _greedy_step(params, cfg, ctx, caches, nxt, step_in) -> torch.Tensor:
    """One ``[B, 1]`` decode step on ``step_in`` (int64 [B + 1]: the ids,
    then the position): K/V rows are written into ``caches`` in place,
    the new recurrent states into ``nxt``; returns the greedy ids (int64
    [B]). It reads the states of ``caches`` and writes only what the same
    input writes again, so a rerun gives the same result, which a graph
    capture's warm-up needs."""
    b = step_in.shape[0] - 1
    logits, new = lm.decode_step(params, cfg, ctx, step_in[:b, None],
                                 step_in[b], caches)
    _copy_into(nxt, new)
    return torch.argmax(logits.float(), -1)


@torch.no_grad()
def _commit_step(caches, nxt, step_in) -> None:
    """Make the states :func:`_greedy_step` wrote the current ones."""
    _copy_into(caches, nxt)


class GreedyDecoder:
    """The reference launcher's greedy decode on one batch: the caches of
    ``lm.init_cache(cfg, batch, max_len)`` (the legacy split K/V cache and
    the recurrent states), a :meth:`prefill` and one :meth:`step` a token.
    On CUDA with ``cuda_graphs`` a step is two captured graphs
    (``serving/graphs.py::StepGraph``): the decode step, which writes the
    new states beside the current ones, and the commit that copies them
    over; the caches stay static buffers written in place. The prefill
    runs eagerly (the reference jits only its step)."""

    def __init__(self, params, cfg, ctx, batch: int, max_len: int, device,
                 cuda_graphs: bool = True):
        self.params, self.cfg, self.ctx = params, cfg, ctx
        self._shape = (batch, max_len, device)
        self.caches = lm.init_cache(cfg, batch, max_len, device=device)
        # the recurrent layers' next states (attention layers write in
        # place)
        nxt = [[None if seg.kind in lm.ATTN_KINDS
                else {k: torch.empty_like(v) for k, v in c.items()}
                for c in seg_caches]
               for seg, seg_caches in zip(lm.build_segments(cfg),
                                          self.caches)]
        self.step_in = torch.zeros((batch + 1,), dtype=torch.int64,
                                   device=device)
        decode = functools.partial(_greedy_step, params, cfg, ctx,
                                   self.caches, nxt)
        commit = functools.partial(_commit_step, self.caches, nxt)
        self.graphs: list = []
        if torch.device(device).type == "cuda" and cuda_graphs:
            from repro_torch.serving.graphs import StepGraph

            self.graphs = [StepGraph(decode, self.step_in, obs=ctx.obs),
                           StepGraph(commit, self.step_in, obs=ctx.obs)]
            self._decode, self._commit = self.graphs
        else:
            self._decode = functools.partial(decode, self.step_in)
            self._commit = functools.partial(commit, self.step_in)
        self.ids: torch.Tensor | None = None
        self.pos = 0

    @property
    def state_bytes(self) -> int:
        """The caches' bytes a lane."""
        return sum(t.numel() * t.element_size()
                   for t in _tensors(self.caches)) // (
            self.step_in.shape[0] - 1)

    @torch.no_grad()
    def prefill(self, prompt: torch.Tensor) -> torch.Tensor:
        """Prompt ``prompt`` (int64 [B, S]) into empty caches (an mLSTM or
        sLSTM prefill continues from the state it is given), copied into
        the static ones; the head on the last position only, argmax in
        f32. Returns the ids [B]."""
        b, max_len, device = self._shape
        hidden, new = lm.forward(self.params, self.cfg, self.ctx,
                                 {"ids": prompt},
                                 caches=lm.init_cache(self.cfg, b, max_len,
                                                      device=device),
                                 return_hidden=True)
        _copy_into(self.caches, new)
        logits = lm._head(self.ctx, self.cfg, self.params, hidden[:, -1:])
        self.ids = torch.argmax(logits[:, -1].float(), -1)
        self.pos = prompt.shape[1]
        return self.ids

    def step(self) -> torch.Tensor:
        """One decode step from the last ids at the next position; returns
        the new ids [B] (on CUDA a graph's static output: valid until the
        next step)."""
        b = self.step_in.shape[0] - 1
        self.step_in[:b].copy_(self.ids)
        self.step_in[b].fill_(self.pos)
        self.ids = self._decode()
        self._commit()
        self.pos += 1
        return self.ids

    @property
    def capture_s(self) -> float | None:
        return (sum(g.capture_s or 0.0 for g in self.graphs)
                if self.graphs else None)

    @property
    def pool_bytes(self) -> int | None:
        return (sum(g.pool_bytes or 0 for g in self.graphs)
                if self.graphs else None)


def greedy_decode(params, cfg, ctx, prompt: torch.Tensor, tokens: int, *,
                  obs: obs_lib.Obs | None = None,
                  cuda_graphs: bool = True) -> dict:
    """The reference launcher's greedy decode (its default path) through a
    :class:`GreedyDecoder`: ``prompt`` (int64 [B, S] on the run's device)
    prefilled into caches of ``S + tokens`` positions, then ``tokens - 1``
    decode steps at a scalar position. With ``obs`` each inter-token gap
    (host wall, each step ends in a device synchronize) lands in its
    ``serve_token_latency_seconds`` histogram. Returns ``{"ids": int64
    [B, tokens] on the host, "token_s": the gaps, "prefill_s",
    "decode_s", "capture_s", "pool_bytes", "state_bytes": the caches'
    bytes a lane}``."""
    dev = prompt.device
    b, plen = prompt.shape
    dec = GreedyDecoder(params, cfg, ctx, b, plen + tokens, dev,
                        cuda_graphs=cuda_graphs)
    _sync(dev)
    t0 = time.perf_counter()
    outs = [dec.prefill(prompt).clone()]
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    hist = (obs.registry.histogram("serve_token_latency_seconds",
                                   "inter-token decode gap (host wall)")
            if obs is not None else None)
    gaps = []
    t0 = t_prev = time.perf_counter()
    for _ in range(tokens - 1):
        outs.append(dec.step().clone())
        _sync(dev)
        now = time.perf_counter()
        gaps.append(now - t_prev)
        if hist is not None:
            hist.observe(now - t_prev)
        t_prev = now
    return {"ids": torch.stack(outs, dim=1).cpu(), "token_s": gaps,
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0,
            "capture_s": dec.capture_s, "pool_bytes": dec.pool_bytes,
            "state_bytes": dec.state_bytes}


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


def serve_greedy(args, cfg, params, ctx, obs: obs_lib.Obs, device) -> dict:
    """The launcher's default path: ``--batch`` random prompts of
    ``--prompt-len`` tokens (from ``--seed``) greedy-decoded for
    ``--tokens`` tokens (:func:`greedy_decode`), logged with the first
    lane's ids as the reference logs them; then the metrics
    (``--metrics-out``, SLO targets). Returns :func:`greedy_decode`'s
    dict with the ``prompt``, ``wall_s`` (the decode steps) and
    ``tok_s``."""
    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    out = greedy_decode(params, cfg, ctx, prompt, args.tokens, obs=obs,
                        cuda_graphs=ctx.impl != "ref")
    n = (args.tokens - 1) * args.batch
    out.update(prompt=prompt, wall_s=out["decode_s"],
               tok_s=n / out["decode_s"] if out["decode_s"] else None)
    p50 = float(np.median(out["token_s"])) * 1e3 if out["token_s"] else None
    log.info("%s [%s] greedy decode: %s", cfg.name, args.backend, obs_lib.kv(
        tokens=n, wall_s=out["decode_s"], token_p50_ms=p50,
        ids0=out["ids"][0].tolist()))
    _finish_metrics(args, obs, log)
    return out


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
                    help="calibration batch size; the greedy decode's lanes")
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
    ap.add_argument("--impl", default="auto", choices=("auto", "ref"),
                    help="auto: the kernels (their plain versions on the "
                         "CPU); ref: the reference's own compositions, "
                         "eagerly")
    ap.add_argument("--serve-trace", action="store_true",
                    help="continuous-batching engine run over staggered "
                         "synthetic requests (the ported serving mode)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--slots", type=int, default=6)
    ap.add_argument("--kv-layout", default="legacy",
                    choices=("legacy", "fused"),
                    help="KV pool layout: legacy split K/V pages, or the "
                         "fused head-interleaved paged layout decoded by "
                         "the ragged paged flash-decode path")
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
    ap.add_argument("--stages", type=int, default=0,
                    help="run the forward stage-parallel over this many "
                         "pipeline stages (one device each, weights "
                         "resident a stage); 0 = off")
    ap.add_argument("--microbatches", type=int, default=2,
                    help="overlapping microbatches a pipeline replica for "
                         "--stages / --mesh")
    ap.add_argument("--mesh", default=None,
                    help="REPLICASxSTAGES device grid for pipelined "
                         "execution (e.g. 2x4: two data-parallel pipeline "
                         "replicas of four stages, eight cards); overrides "
                         "--stages")
    ap.add_argument("--metrics-out", default=None,
                    help="write a JSON metrics snapshot here (plus the "
                         "Prometheus text exposition at the same path "
                         "with a .prom suffix)")
    ap.add_argument("--fidelity", action="store_true",
                    help="numerical-fidelity pass after the backend build: "
                         "per-layer SQNR vs the float tree, MXFP4 clip/"
                         "underflow + ADC saturation/code-utilization "
                         "counters, calibration-drift check (eager; "
                         "metrics land in --metrics-out)")
    ap.add_argument("--profile", action="store_true",
                    help="record each eager kernel call's wall time after a "
                         "device synchronize (kernel_wall_seconds); off by "
                         "default, it serializes dispatch")
    ap.add_argument("--log-level", default="info", choices=obs_lib.log.LEVELS)
    ap.add_argument("--log-every", type=int, default=16,
                    help="info-level progress line every N engine steps")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT p99 SLO target in ms (host wall)")
    ap.add_argument("--slo-token-ms", type=float, default=None,
                    help="per-token latency p99 SLO target in ms")
    return ap


def init_lm(args):
    """Config, float parameters and device of an LM: random weights from
    ``--seed`` on the run's device. Raises if CUDA is asked for (the
    default) and missing."""
    device = resolve_device(args.device)
    cfg = lm_config(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        return cfg, lm.init_model(cfg, gen), device


def lm_config(args):
    """The LM config of ``--arch``, tiny under ``--tiny``, its depth cut to
    ``--layers`` when given."""
    cfg = C.tiny(C.ARCHS[args.arch]) if args.tiny else C.ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def fidelity_batch(args, cfg, device) -> dict:
    """The batch ``--fidelity`` probes an LM on: the first calibration
    batch (so ``cim`` calibration traffic)."""
    return calibrate.calibration_batches(
        cfg, n_batches=1, batch=args.batch, seq=args.prompt_len,
        device=device)[0]


def build_model(args, obs=None, batches=None):
    """Config, converted parameters and RunCtx for the run: random weights
    from ``--seed`` on the run's device, converted for ``--backend``, and
    with ``--fidelity`` the fidelity pass (:func:`run_fidelity`) while the
    float tree is still there. Without ``--fidelity`` the conversion drops
    each float layer once it is converted, so the float tree never sits
    whole beside the converted one (a full-width MoE layer is ~10 GB in
    float32). ``batches`` are the ``cim`` calibration batches (default:
    ``calibration_batches``' token ids; an audio arch needs ``emb``
    batches)."""
    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    t0 = time.perf_counter()
    cfg, fparams, device = init_lm(args)
    with torch.no_grad():
        params, ctx = build_backend(args, cfg, fparams, device, obs=obs,
                                    batches=batches,
                                    free_float=not args.fidelity)
    if args.fidelity:
        run_fidelity(args, cfg, fparams, params, ctx, obs,
                     batches[0] if batches else
                     fidelity_batch(args, cfg, device))
    del fparams
    log.info("model ready: %s", obs_lib.kv(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        device=str(device), wall_s=time.perf_counter() - t0))
    return cfg, params, ctx, device


def init_vit(args):
    """Config, float parameters, device and calibration images (under
    ``cim`` or ``--fidelity``, else None) of a vision arch: random weights
    from ``--seed``.
    ``--tiny`` keeps the token geometry (patch grid, layers, chips) and
    shrinks the width."""
    device = resolve_device(args.device)
    full = C.VISION_ARCHS[args.arch]
    cfg = C.geometry_tiny_vit(full) if args.tiny else full
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        fparams = vit.init_model(cfg, gen)
    batches = vit.calibration_images(
        cfg, n_batches=args.calib_batches, batch=args.batch,
        device=device) if args.backend == "cim" or args.fidelity else None
    return cfg, fparams, device, batches


def build_vision_model(args, obs=None):
    """Config, converted parameters and RunCtx of a vision arch: random
    weights from ``--seed``; ``cim`` calibrates on synthetic images
    (``vit.calibration_images``); ``--fidelity`` probes the first of them
    (:func:`run_fidelity`)."""
    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    t0 = time.perf_counter()
    cfg, fparams, device, batches = init_vit(args)
    with torch.no_grad():
        params, ctx = build_backend(args, cfg, fparams, device, obs=obs,
                                    batches=batches, forward_fn=vit.forward)
    if args.fidelity:
        run_fidelity(args, cfg, fparams, params, ctx, obs, batches[0],
                     forward_fn=vit.forward)
    del fparams, batches
    log.info("model ready: %s", obs_lib.kv(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        tokens=cfg.seq_len, chips=cfg.chips, device=str(device),
        wall_s=time.perf_counter() - t0))
    return cfg, params, ctx, device


def serve_vision(args, cfg, params, ctx, obs: obs_lib.Obs, device,
                 mesh=None) -> dict:
    """Stream ``--frames`` synthetic frames through the ViT (one at a
    time, the Table 7 operating mode), then map the measured stage
    traffic onto the FWS pipeline model at the workload's hardware shape.
    With ``--stages`` / ``--mesh`` (or a grid given as ``mesh``) the
    frames run through the stage-parallel pipeline instead, in slabs of
    its capacity (``--microbatches`` microbatches a replica), and the
    pipeline is measured (``MeasuredReport``, published). Returns a
    summary: the device's own frame rate and frame wall times (host wall
    clock, each frame or slab ends in a host read), and, apart, the
    analytical model's ``fws_model_fps`` beside the paper's; with a
    pipeline also ``measured`` (its report's figures) and ``runner``."""
    from repro_torch.serving import VisionEngine

    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    runner = None
    pshape = pipeline_shape(args)
    if mesh is None and pshape is not None:
        mesh = pipeline_mesh(pshape, device)
    if mesh is not None:
        from repro_torch.distributed import pipeline_exec as pex

        replicas, stages = mesh.shape["replica"], mesh.shape["stage"]
        runner = pex.build_vit_pipeline(
            params, cfg, ctx, stages=stages, replicas=replicas,
            microbatches=args.microbatches,
            mb_size=max(1, -(-args.frames // (replicas * args.microbatches))),
            mesh=mesh, cuda_graphs=_captures(ctx, mesh))
        log.info("pipelined mesh: %s", obs_lib.kv(
            replicas=replicas, stages=stages, microbatches=args.microbatches,
            capacity=runner.capacity, stage_cuts=runner.bounds,
            trunk_mb=runner.trunk_bytes / 2**20,
            captured=runner.graphs is not None))
    eng = VisionEngine(params, cfg, ctx, obs=obs, runner=runner,
                       cuda_graphs=ctx.impl != "ref")
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
    out = summary | {"fws": fws}
    if runner is not None:
        mrep = eng.measured_report(frames, reps=2)
        mrep.publish(obs.registry)
        out["measured"] = dict(
            stages=mrep.n_stages, replicas=mrep.n_replicas,
            step_wall_ms=mrep.step_wall_s * 1e3,
            fps=mrep.throughput_items_per_s,
            steady_fps=mrep.steady_items_per_s,
            bubble=mrep.bubble_fraction, fill_ms=mrep.fill_latency_s * 1e3,
            stage_wall_ms=[w * 1e3 for w in mrep.stage_walls_s])
        log.info("fws-pipeline-measured: %s", obs_lib.kv(**{
            k: v for k, v in out["measured"].items()
            if k != "stage_wall_ms"}))
        out.update(runner=runner, images=frames)
    _finish_metrics(args, obs, log)
    return out


def serve_pipelined_lm(args, cfg, params, ctx, obs: obs_lib.Obs, device,
                       mesh=None) -> dict:
    """``--stages`` / ``--mesh``: the LM's prefill / scoring forward runs
    stage-parallel on a device grid (``mesh``, default the flags' grid):
    per-stage resident weights, ``--microbatches`` overlapping
    microbatches a replica, on ``--batch`` random prompts of
    ``--prompt-len`` tokens. It is measured (published) and held to the
    one-device forward on the same batch and backend (``parity``:
    ``bitwise`` or ``diverged``). Returns ``{"logits", "ref", "parity",
    "report", "runner", "batch", "base_wall_s"}``."""
    log = obs_lib.get_logger("repro_torch.serve", args.log_level)
    if mesh is None:
        mesh = pipeline_mesh(pipeline_shape(args), device)
    replicas, stages = mesh.shape["replica"], mesh.shape["stage"]
    mb = max(1, -(-args.batch // (replicas * args.microbatches)))
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    batch = {"ids": torch.randint(0, cfg.vocab_size,
                                  (args.batch, args.prompt_len),
                                  generator=gen, device=device)}
    out, runner = lm.forward_pipelined(
        params, cfg, ctx, batch, stages=stages, replicas=replicas,
        microbatches=args.microbatches, mb_size=mb, mesh=mesh,
        seq_len=args.prompt_len, cuda_graphs=_captures(ctx, mesh))
    log.info("pipelined mesh: %s", obs_lib.kv(
        replicas=replicas, stages=stages, microbatches=args.microbatches,
        mb_size=mb, capacity=runner.capacity, stage_cuts=runner.bounds,
        trunk_mb=runner.trunk_bytes / 2**20,
        captured=runner.graphs is not None))
    rep = runner.measure(batch, reps=2)
    rep.publish(obs.registry)
    # the one-device forward on the same batch, same backend
    with torch.no_grad():
        lm.forward(params, cfg, ctx, batch)
        _sync(device)
        t0 = time.perf_counter()
        ref = lm.forward(params, cfg, ctx, batch)[0]
        _sync(device)
    base_wall = time.perf_counter() - t0
    out = out.to(ref.device)  # the head ran on the last stage's device
    parity = "bitwise" if torch.equal(out, ref) else "diverged"
    log.info("%s [%s] pipelined forward: %s", cfg.name, args.backend,
             obs_lib.kv(rows=args.batch,
                        tokens=args.batch * args.prompt_len,
                        step_wall_ms=rep.step_wall_s * 1e3,
                        base_wall_ms=base_wall * 1e3,
                        rows_s=rep.throughput_items_per_s,
                        steady_rows_s=rep.steady_items_per_s,
                        bubble=rep.bubble_fraction,
                        fill_ms=rep.fill_latency_s * 1e3, parity=parity))
    _finish_metrics(args, obs, log)
    return {"logits": out, "ref": ref, "parity": parity, "report": rep,
            "runner": runner, "batch": batch, "base_wall_s": base_wall}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    obs = obs_lib.Obs(profile=args.profile)
    if args.arch in C.VISION_ARCHS:
        cfg, params, ctx, device = build_vision_model(args, obs=obs)
        return serve_vision(args, cfg, params, ctx, obs, device)
    cfg = lm_config(args)
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode")
    cfg, params, ctx, device = build_model(args, obs=obs)
    if pipeline_shape(args) is not None:
        return serve_pipelined_lm(args, cfg, params, ctx, obs, device)
    if args.arrivals:
        return serve_load(args, cfg, params, ctx, obs, device)
    if args.serve_trace:
        return serve_trace(args, cfg, params, ctx, obs, device)
    return serve_greedy(args, cfg, params, ctx, obs, device)


if __name__ == "__main__":
    main()
