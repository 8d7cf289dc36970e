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
   Every serve runs its prefill, chunk, clone and decode steps through
   captured CUDA graphs (``serving/graphs.py``; phases 4-7 and 9). Each
   profiled prefill and decode window runs twice on the same requests,
   eager (``EngineConfig(cuda_graphs=False)``) and captured: the ids (the
   prefill's one id, the decode tokens) and the launches by kernel and
   route must be equal, and the ``serve`` line carries both windows' wall
   and device ms a step, busy share (and tok/s), with the capture's
   seconds and graph pool bytes; a ``prefill eager vs captured`` line
   gives the prefill's, unprofiled wall the median of ``PREFILL_WALLS``.
5. Serve ``--backend mxfp4`` the same way at full width with the depth
   cut to 16 of 32 layers (the run's time limit): ``mxfp4_matmul`` (both
   routes) and ``paged_decode`` must have launched, ``cim_linear`` and
   ``paged_decode_mx`` not; the same output checks and profiles, where the
   prefill's linears must take the ``wgmma`` route and the decode step's
   the ``mma`` route only.
6. Serve long [``mxfp4``]: phase 5's model through the launcher's
   ``serve_trace`` with 4 prompts of up to 2048 tokens (every prefill
   [1, 2048], past ``dense_attn_max``) and 32 new tokens: ``flash_attention``
   must launch once a layer a prefill, all on ``wgmma``, beside
   ``mxfp4_matmul`` and ``paged_decode`` (``cim_linear`` and
   ``paged_decode_mx`` not); 2048-token prefill logits against
   ``impl="ref"`` (the torch-op ``_flash_attn``) at SQNR >= 30 dB; one
   2048-token prefill and 8 decode steps at the 2080-slot page profiled as
   in phase 4, with kernel E's device ms a prefill beside its bound.
7. Serve chunked + prefix [``cim``]: phase 4's model in an engine with
   256-token chunks, the ``chunked`` policy and 1088-slot pages serves 8
   requests (6 share a 512-token system prompt) with the prefix cache off
   and then on: bitwise equal tokens, hits and no verify failure, fewer
   prefill-chunk steps, and ``cim_linear`` and ``paged_decode_mx`` (only)
   launched; a ``serve chunked`` line a run. Then one load replay of the
   same model through the launcher's ``serve_load`` (``LOAD_ARGS``: 24
   Poisson arrivals at 4 requests/s, chunked, prefix cache, metrics
   written to a temporary directory, SLO targets scored) and the same
   trace, saved and loaded, replayed on an eager engine: tokens bitwise
   equal a request, the Prometheus file parsing back to the registry's
   counters, ``kernel_calls_total`` counting every launch, only
   ``cim_linear`` and ``paged_decode_mx`` launched; a ``serve load`` line
   a replay (TTFT, token latency and queue wait p50/p99, wall tok/s,
   steps, prefix hits, page evictions, the SLO verdict).
8. Serve vision: the paper's Table 7 workloads at full width and depth
   through the launcher's ``build_vision_model`` and ``serve_vision``,
   ``VISION_FRAMES`` single-stream frames (B=1) each: ViT-B/16 (197
   tokens, 12 layers) under ``cim`` and then ``mxfp4``, and ViT-L/32 (145
   tokens, 24 layers) under ``cim`` as the two-chip chain (12+12) on the
   one card. Only the backend's matmul kernel launches (``cim_linear``:
   ``splitk`` and ``wgmma``; ``mxfp4_matmul``: ``wgmma`` and ``fma``, no
   ``mma``), exactly on the routes a frame's shapes pick; no paged or
   flash kernel. Logits of 4 frames against ``impl="ref"`` (SQNR >= 30
   dB), the ViT-L/32 chain against the monolithic forward (bitwise), and
   one frame under the profiler (device ms by kernel and route, wall ms,
   busy share), eager and captured: ``WINDOW_FRAMES`` frames each way,
   logits bitwise between the two (each chip's step one graph; the
   chain's hidden state is the static buffer between them). A ``serve
   vision`` line a run gives the card's own
   ``fps_host`` and frame times beside, apart and labelled as the
   analytical model's, the FWS pipeline's ``fws_model_fps``, the paper's
   Table 7 ``paper_fps`` and ``err_pct`` (which must stay under 5%).
   ``tiny_vit`` gives the same logits on the card as on the CPU (SQNR >=
   30 dB), and phase 3 also holds both matmul kernels at ViT-B/16's
   shapes (``VIT_CIM_SHAPES``, ``VIT_MM_SHAPES``).
9. Serve the other dense families: gemma3-1b (26 layers, 5:1
   local:global, head_dim 256, one KV head, tied head),
   h2o-danube-1.8b (24 layers, 4096-slot window, head_dim 80) at full
   width and depth, and nemotron-4-15b (squared ReLU, LayerNorm, head_dim
   128, untied 256000-row head) at full width with the depth cut to 8 of
   32 layers (``DENSE_LAYERS``), through the launcher's ``build_model``
   and ``serve_trace`` under ``mxfp4`` and ``cim`` (``DENSE_RUNS``): 8
   staggered requests of up to 384-token prompts ([1, 384] prefills, past
   ``dense_attn_max``) and 64 new tokens, 4 lanes, 6 slots, page 448.
   Launch counts by kernel and route must be exactly those the code gives
   (``_dense_launches``; ``flash_attention`` on ``fma`` under ``mxfp4``);
   logits of a 384-token prefill and 4 decode steps against
   ``impl="ref"`` with the chunked plain decode (SQNR >= 30 dB; the dense
   ``impl="ref"`` figure is printed beside it); each request served alone
   gives its first 32 staggered tokens bitwise; the tied head timed; one
   prefill and 8 decode steps profiled eager and captured (one window
   each); a ``serve dense`` line a run. First, the kernel rows at these
   archs' shapes (``DENSE_SHAPES``): B and D at head widths 256, 80 and
   128 (page 448, lengths 0, 1, W/2, W), E at the [1, 384] prefill shapes
   in bf16 and at D 256 in f32, A and C at the new linear shapes at M = 4
   and 384 (nemotron's head 6144 x 256000 among them).
10. Prints the kernels line (phase 9 adds B, D and E at head widths
    256, 80 and 128), then the card's name and power limit, then the
    device line, as the last line.

Every measured shape is printed on a line of its own (``cim_linear {...}``,
``paged_decode_mx {...}``, ``mxfp4_matmul {...}``, ``paged_decode {...}``,
``flash_attention {...}``, ``serve {...}``, ``prefill profile {...}``,
``decode profile {...}``, ``serve long {...}``, ``serve chunked {...}``,
``serve load {...}``, ``prefill eager vs captured {...}``,
``decode eager vs captured {...}``, ``frame profile <arch> <mode>
{...}``, ``frame eager vs captured {...}``, ``serve vision {...}``,
``serve dense {...}``).
The decode kernels are also checked at the page widths of phases 6 and 7
(``FLOAT_PAGES``, ``MX_PAGES``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import subprocess
import sys
import tempfile
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
    # 16 of 32 layers: the run's time limit, with phase 9
    "mxfp4": TRACE_ARGS + ["--backend", "mxfp4", "--layers", "16"],
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
PREFILL_WALLS = 3  # prefills a mode timed without the profiler (median)
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
# the long serve (phase 6): 2048-token prompts, 32 new tokens, phase 5's
# 16 layers
LONG_PROMPT, LONG_TOKENS, LONG_REQUESTS = 2048, 32, 4
LONG_PAGE = LONG_PROMPT + LONG_TOKENS
# the chunked serve with the prefix cache (phase 7), cim, 8 layers
CHUNK_ECFG = dict(lanes=4, num_slots=6, page_len=1088, prefill_len=256,
                  chunk_len=256, policy="chunked")
SYS_PROMPT, CHUNK_TOKENS = 512, 32  # the shared prefix, new tokens a request
# phase 7's load replay: phase 4's model through the launcher's serve_load,
# 24 Poisson arrivals at 4 requests/s (~6 s of arrivals) of prompts up to
# 1087 tokens (a 512-token system prompt on 3 in 4), up to 32 new tokens,
# CHUNK_ECFG's engine (the page of 1056 + 32 slots). The SLO targets only
# exercise the scoring: no cell sets an SLO yet (PERF.md §2).
LOAD_ARGS = ["--arrivals", "poisson:4", "--requests", "24", "--chunk-len",
             "256", "--policy", "chunked", "--prefix-cache", "--prompt-len",
             "1056", "--tokens", "32", "--lanes", "4", "--slots", "6",
             "--slo-ttft-ms", "2000", "--slo-token-ms", "100"]
# each decode kernel also at the page width of the serve that runs it
MX_PAGES = PAGES + ((CHUNK_ECFG["page_len"], [0, 545, 1000, 1088]),)
FLOAT_PAGES = PAGES + ((LONG_PAGE, [0, 1029, 1900, LONG_PAGE]),)
# flash_attention at the prefill shape the model would give it:
# (B, S, H, Hkv, D) of starcoder2-7b with a 2048-token prompt
FA_SHAPE = (1, 2048, 36, 4, 128)
FA_F32_S = 512  # sequence length of the f32 (fma route) row
FA_MIN_SQNR_DB = 40.0  # bf16 rows: P is rounded to bf16 for the PV product
# the vision phase (phase 8): the paper's Table 7 workloads at full size,
# single-stream frames through the launcher's serve_vision
VISION_FRAMES = 64
VISION_RUNS = (("vit-b16", "cim"), ("vit-b16", "mxfp4"), ("vit-l32", "cim"))
VISION_ARGS = ["--no-tiny", "--frames", str(VISION_FRAMES),
               "--calib-batches", "2", "--batch", "2"]
VISION_KERNEL = {"cim": "cim_linear", "mxfp4": "mxfp4_matmul"}
VISION_CHECK_FRAMES = 4  # frames whose logits are held to impl="ref"
WINDOW_FRAMES = 8  # frames a profiled window, eager and captured
# ViT-B/16's linears at the shapes a frame gives them (PERF.md §6):
# cim_linear (M, K, N) and mxfp4_matmul (M, K, N, x dtype)
VIT_CIM_SHAPES = ((197, 768, 768), (197, 768, 3072))
VIT_MM_SHAPES = ((197, 768, 3072, torch.bfloat16),
                 (196, 768, 768, torch.float32),
                 (1, 768, 1000, torch.bfloat16))
# the two other dense families (phase 9) at full width and depth through
# the launcher's serve_trace: 8 staggered requests of up to 384-token
# prompts ([1, 384] prefills, past dense_attn_max) and 64 new tokens, page
# 448 (inside gemma3-1b's 512-slot local window)
DENSE_RUNS = (("gemma3-1b", "mxfp4"), ("gemma3-1b", "cim"),
              ("h2o-danube-1.8b", "mxfp4"), ("h2o-danube-1.8b", "cim"),
              ("nemotron-4-15b", "mxfp4"), ("nemotron-4-15b", "cim"))
# depth cuts of phase 9 (width kept): nemotron-4-15b's f32 weights before
# conversion are ~62 GB at 32 layers (390 M parameters a layer, 1.57 G in
# each of the embedding and the untied head), ~25 GB at 8
DENSE_LAYERS = {"nemotron-4-15b": 8}
DENSE_PROMPT, DENSE_TOKENS, DENSE_PAGE = 384, 64, 448
DENSE_ARGS = ["--no-tiny", "--serve-trace", "--requests", "8", "--lanes",
              "4", "--slots", "6", "--prompt-len", str(DENSE_PROMPT),
              "--tokens", str(DENSE_TOKENS), "--calib-batches", "2",
              "--batch", "2"]
DENSE_STEPS = 4  # teacher-forced decode steps held to impl="ref"
SOLO_TOKENS = 32  # each request alone: its first tokens of the serve
# per arch: decode dims (lanes, KV heads, heads per KV head, head_dim),
# flash_attention's prefill shape (B, S, H, Hkv, D, window) and the static
# linears (K, N): wq, wk / wv, wo, w1 / w3, w2 (and danube's head)
DENSE_SHAPES = {
    "gemma3-1b": ((4, 1, 4, 256), (1, DENSE_PROMPT, 4, 1, 256, 512),
                  ((1152, 1024), (1152, 256), (1024, 1152), (1152, 6912),
                   (6912, 1152))),
    "h2o-danube-1.8b": ((4, 8, 4, 80), (1, DENSE_PROMPT, 32, 8, 80, 4096),
                        ((2560, 2560), (2560, 640), (2560, 6912),
                         (6912, 2560), (2560, 32000))),
    # wq / wo, wk / wv, w1 (squared ReLU: no w3), w2, the untied head
    "nemotron-4-15b": ((4, 8, 6, 128), (1, DENSE_PROMPT, 48, 8, 128, 0),
                       ((6144, 6144), (6144, 1024), (6144, 24576),
                        (24576, 6144), (6144, 256000))),
}
DENSE_LENGTHS = [0, 1, DENSE_PAGE // 2, DENSE_PAGE]
# kernel function -> wrapper and route, for device time by route
KERNEL_ROUTES = {
    "cim_splitk_kernel": "cim_linear splitk",
    "cim_quant_kernel": "cim_linear wgmma (pre-pass)",
    "cim_tc_kernel": "cim_linear wgmma",
    "mxfp4_matmul_kernel": "mxfp4_matmul fma",
    "mxfp4_matmul_tc_kernel": "mxfp4_matmul wgmma",
    "mxfp4_matmul_mma_kernel": "mxfp4_matmul mma",
    "splitk_sum_kernel": "mxfp4_matmul split-K sum",
}


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


def _flash_bound(b, sq, sk, h, hkv, d, elt: int, pairs: float):
    """``flash_attention``'s bound: q, k, v read and out written once, 4 d
    operations a (query, visible key) pair and head."""
    n_bytes = elt * (2 * b * sq * h * d + 2 * b * sk * hkv * d)
    return _bound_ms(n_bytes, 4.0 * b * h * d * pairs,
                     "bf16" if elt == 2 else "f32")


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


def _cim_row(x, w, cal, cfg, extra: dict) -> dict:
    """One ``cim_linear`` shape on the card: bitwise its plain version (a
    mismatch raises), its route (whose counter must move), K splits, the
    rows that took the ordered walk (``guard_rows``, device counter), the
    times and the alignment's ALU floor beside the bytes/ops bound."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.cim_linear.ref import cim_linear_ref

    m, k = x.shape
    n = w.codes.shape[1]
    counter = cim_ops.guard_rows(x.device)
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
    n_bytes = m * k * x.element_size() + k * n + (k // 32) * n + 8 + m * n * 4
    bound, by = _bound_ms(n_bytes, 2.0 * m * n * k, "int8")
    row = extra | dict(
        m=m, k=k, n=n, x_dtype=str(x.dtype).split(".")[-1], route=route,
        splits=cim_ops.pick_splits(m, k, n), guard_rows=guarded,
        max_abs_err=float(err.max()), bitwise=bool(torch.equal(got, ref)),
        ms=_device_ms(lambda: cim_ops.cim_linear(x, w, cal, cfg=cfg), 20),
        call_ms=_time_ms(lambda: cim_ops.cim_linear(x, w, cal, cfg=cfg), 20),
        # one traced call: at nemotron-4-15b's head the plain version
        # takes ~0.9 s a call
        plain_ms=_device_ms(lambda: cim_linear_ref(x, w, cal, cfg), 1),
        bound_ms=bound, bound_by=by, library_ms=None,
        align_floor_ms=_align_floor_ms(m, k, n))
    row["ok"] = row["bitwise"]
    print("cim_linear", json.dumps(row), flush=True)
    if not row["ok"]:
        raise AssertionError(f"cim_linear kernel is not bitwise its plain "
                             f"version at {(m, k, n)}")
    return row


def check_cim_linear(dev, m_prefill: int) -> list:
    """Every linear shape at decode (M=4) and prefill (M=192), then the
    constructed rounding input at K=18432: each row bitwise its plain
    version (a mismatch raises), with its route, K splits, the rows that
    took the ordered walk (``guard_rows``, device counter) and the
    alignment's ALU floor beside the bytes/ops bound."""
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib

    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = cimlib.CIMConfig()
    rows = []
    for k, n in LINEAR_SHAPES:
        w = mxlib.quantize_w(torch.randn((k, n), generator=gen, device=dev)
                             * k ** -0.5)
        for m in (4, m_prefill):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16).float()
            rows.append(_cim_row(x, w, cimlib.calibrate_rowhist([x], w, cfg),
                                 cfg, {}))
        if (k, n) == LINEAR_SHAPES[2]:
            cim_route_crossover(w, gen, dev, cfg)
    x, w, cal, rcfg = _rounding_input(dev)
    rows.append(_cim_row(x, w, cal, rcfg, {"case": "rounding"}))
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


def check_paged_decode(dev, dims=DECODE_DIMS, pages=MX_PAGES,
                       extra: dict | None = None) -> list:
    """``paged_decode_mx`` at ``dims`` (lanes, KV heads, heads per KV head,
    head_dim) and each width of ``pages`` against its plain version (and,
    loosely, the dense reference)."""
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.paged_attention import layout
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import ref as pref

    (lanes, hkv, g, dh), pool = dims, 10
    scale = dh ** -0.5
    gen = torch.Generator(device=dev).manual_seed(2)
    rows_out = []
    for w, lens in pages:
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
        rows_out.append((extra or {}) | dict(
            lanes=lanes, hkv=hkv, g=g, dh=dh, w=w, bk=bk, lengths=lens,
            heads_per_block=pops.pick_heads(g), max_abs_err=err, sqnr_vs_plain_db=sq_plain,
            sqnr_vs_dense_db=sq_dense, ok=ok, ms=_device_ms(kernel, 50),
            call_ms=_time_ms(kernel, 50), plain_ms=_device_ms(plain, 5),
            bound_ms=bound, bound_by=by))
        print("paged_decode_mx", json.dumps(rows_out[-1]), flush=True)
        if not ok:
            raise AssertionError(f"paged_decode_mx kernel disagrees at W={w}")
    return rows_out


def _mxfp4_row(x, codes, exps, w_bf16, extra: dict) -> dict:
    """One ``mxfp4_matmul`` shape on the card against its plain version
    (a disagreement raises): its route (whose counter must move), times,
    the bound and ``torch.matmul`` on the weight dequantized outside the
    timing (``w_bf16``) as the library call."""
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.mxfp4_matmul.ref import mxfp4_matmul_ref

    (m, k), n, dtype = x.shape, codes.shape[1], x.dtype
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
    n_bytes = x.element_size() * m * k + k * n // 2 + k * n // 32 + 2 * m * n
    bound, by = _bound_ms(n_bytes, 2.0 * m * n * k,
                          "bf16" if dtype == torch.bfloat16 else "f32")
    row = extra | dict(
        m=m, k=k, n=n, x_dtype=str(dtype).split(".")[-1], route=route,
        max_abs_err=float(err.max()), sqnr_db=_sqnr_db(ref, got), ok=ok,
        ms=_device_ms(lambda: mm_ops.mxfp4_matmul(x, codes, exps), 20),
        call_ms=_time_ms(lambda: mm_ops.mxfp4_matmul(x, codes, exps), 20),
        plain_ms=_device_ms(lambda: mxfp4_matmul_ref(x, codes, exps), 1),
        bound_ms=bound, bound_by=by,
        library_ms=_device_ms(lambda: torch.matmul(x, w_lib), 20))
    print("mxfp4_matmul", json.dumps(row), flush=True)
    if not ok:
        raise AssertionError(f"mxfp4_matmul kernel disagrees with its plain "
                             f"version at {(m, k, n)}")
    return row


def check_mxfp4_matmul(dev, m_prefill: int) -> list:
    """Every linear shape at decode (M=4) and prefill (M=192) in bf16, plus
    w1 at M=192 with f32 x (the fma route) and at the ragged M=100 in
    bf16. Each row names its route; the route's counter must move."""
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
            rows.append(_mxfp4_row(x, codes, exps, w_bf16, {}))
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


def check_paged_decode_float(dev, dims=DECODE_DIMS, pages=FLOAT_PAGES,
                             extra: dict | None = None) -> list:
    """``paged_decode`` at ``dims`` and each width of ``pages`` against its
    plain version, the dense reference and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import layout
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import ref as pref

    (lanes, hkv, g, dh), pool = dims, 10
    scale = dh ** -0.5
    gen = torch.Generator(device=dev).manual_seed(7)
    rows_out = []
    for w, lens in pages:
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
        rows_out.append((extra or {}) | dict(
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
    in bf16 (bf16 with D 64 or 128 must take ``wgmma``); the picked
    route's counter moves by one. The library time is
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
    if q.dtype == torch.bfloat16 and d in fa_ops.TC_D and route != "wgmma":
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
    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
    bound, by = _flash_bound(b, sq, sk, h, hkv, d, q.element_size(),
                             float(mask.sum()))
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


def serve_full_width(backend: str) -> tuple[dict, tuple]:
    """Phases 4 and 5; returns the run and the model (cfg, params, ctx),
    which phases 6 and 7 serve again."""
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
    line = ({"backend": backend, "layers": cfg.n_layers}
            | {k: v for k, v in summary.items()
               if k not in serve.SUMMARY_DATA}
            | {"launches": launches, "mxfp4_matmul_routes": routes,
               "cim_linear_routes": cim_routes, "peak_mem_gib": peak / 2**30,
               "build_peak_mem_gib": build_peak / 2**30,
               "resident_params_gib": resident / 2**30,
               "model_build_s": build_s})
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
    print("serve", json.dumps(line | {"prefill": _step_pair(prof["prefill"]),
                                      "decode": _step_pair(prof["decode"])}),
          flush=True)
    return ({"launches": launches, "summary": summary, "profile": prof},
            (cfg, params, ctx))


def serve_long(cfg, params, ctx) -> dict:
    """Phase 6: the 16-layer ``mxfp4`` model of phase 5 serves
    ``LONG_REQUESTS`` prompts of up to ``LONG_PROMPT`` tokens through the
    launcher's ``serve_trace``. Every prefill is [1, 2048], past
    ``dense_attn_max``: ``flash_attention`` must launch once a layer a
    prefill, all on ``wgmma``, with ``mxfp4_matmul`` and ``paged_decode``
    and without ``cim_linear`` and ``paged_decode_mx``. Then logits of one
    2048-token prompt against ``impl="ref"`` (torch-op ``_flash_attn``),
    and one 2048-token prefill and 8 decode steps at the long page under
    the profiler, with kernel E's device ms a prefill beside its bound."""
    from repro_torch import obs as obs_lib
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(SERVE_ARGS["mxfp4"] + [
        "--prompt-len", str(LONG_PROMPT), "--tokens", str(LONG_TOKENS),
        "--requests", str(LONG_REQUESTS)])
    obs = obs_lib.Obs()
    ctx = dataclasses.replace(ctx, obs=obs)
    dev = params["embed"]["emb"].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    summary = serve.serve_trace(args, cfg, params, ctx, obs, dev)
    launches, routes = _read_counts()
    fa_routes = dict(fa_ops.flash_attention.route_launches)
    peak = torch.cuda.max_memory_allocated()
    line = ({"backend": "mxfp4", "layers": cfg.n_layers}
            | {k: v for k, v in summary.items()
               if k not in serve.SUMMARY_DATA + ("prefix",)}
            | {"launches": launches, "mxfp4_matmul_routes": routes,
               "flash_attention_routes": fa_routes,
               "peak_mem_gib": peak / 2**30})
    want = cfg.n_layers * LONG_REQUESTS  # one [1, 2048] prefill a request
    if launches["flash_attention"] != want or fa_routes["wgmma"] != want:
        raise AssertionError(f"[mxfp4 long] flash_attention launches "
                             f"{launches['flash_attention']} ({fa_routes}), "
                             f"want {want}, all wgmma")
    if (not launches["mxfp4_matmul"] or not launches["paged_decode"]
            or launches["cim_linear"] or launches["paged_decode_mx"]):
        raise AssertionError(f"[mxfp4 long] launches {launches}")
    for v in summary["out"].values():
        if not v or not all(0 <= t < cfg.vocab_size for t in v):
            raise AssertionError("served tokens out of the vocabulary")
    if summary["tokens"] != LONG_REQUESTS * LONG_TOKENS:
        raise AssertionError(f"[mxfp4 long] {summary['tokens']} tokens")
    ids = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(13))
    with torch.no_grad():
        got, _ = lm.forward(params, cfg, ctx, {"ids": ids})
        ref, _ = lm.forward(params, cfg, dataclasses.replace(
            ctx, impl="ref", obs=None), {"ids": ids})
    sq = _sqnr_db(ref.float(), got.float())
    finite = bool(torch.isfinite(got.float()).all())
    print(f"[mxfp4 long] {LONG_PROMPT}-token prefill logits, kernels vs "
          f"impl=ref: SQNR {sq} dB, finite {finite}", flush=True)
    del got, ref
    if not finite or sq < 30.0:
        raise AssertionError("[mxfp4 long] prefill logits disagree")
    prof = {"prefill": profile_prefill(cfg, params, ctx, LONG_PROMPT,
                                       LONG_PAGE),
            # two attempts: 3 windows of 8 steps and the prefill's token
            # fill the 32 slots the long page leaves a request
            "decode": profile_decode(cfg, params, ctx, prompt_len=LONG_PROMPT,
                                     page_len=LONG_PAGE, attempts=2)}
    print("serve long", json.dumps(
        line | {"prefill": _step_pair(prof["prefill"]),
                "decode": _step_pair(prof["decode"])}), flush=True)
    fa_prof = prof["prefill"]["captured"]["launches"].get("flash_attention",
                                                          0)
    if fa_prof != cfg.n_layers:
        raise AssertionError(f"[mxfp4 long] the profiled prefill launched "
                             f"flash_attention {fa_prof} times")
    s = LONG_PROMPT  # the kernel runs every row, pad rows too, causally
    bound, by = _flash_bound(1, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 2,
                             s * (s + 1) / 2)
    fa_ms = prof["prefill"]["captured"]["kernel_ms_per_step"].get(
        "flash_attention")
    print("flash_attention in the long prefill", json.dumps(
        {"launches_a_prefill": fa_prof, "device_ms_a_prefill": fa_ms,
         "device_ms_a_launch": fa_ms / fa_prof if fa_ms else None,
         "bound_ms_a_launch": bound, "bound_by": by,
         "timer": prof["prefill"]["captured"]["timer"]}), flush=True)
    return {"launches": launches, "summary": summary, "profile": prof,
            "logits_sqnr_db": sq}


def _chunked_prompts(vocab: int) -> list:
    """8 prompts: 6 open with one ``SYS_PROMPT``-token system prompt and
    go on with 64..448 tokens of their own, 2 share nothing (64..960
    tokens); in a seeded order."""
    rng = np.random.default_rng(12)
    tokens = lambda n: rng.integers(0, vocab, int(n)).tolist()  # noqa: E731
    system = tokens(SYS_PROMPT)
    prompts = [system + tokens(rng.integers(64, 449)) for _ in range(6)]
    prompts += [tokens(rng.integers(64, 961)) for _ in range(2)]
    return [prompts[i] for i in rng.permutation(len(prompts))]


def serve_chunked_prefix(cfg, params, ctx) -> dict:
    """Phase 7: the 8-layer ``cim`` model of phase 4 in an engine with
    ``CHUNK_ECFG`` (chunked prefill, 256-token chunks, 1088-slot pages)
    serves :func:`_chunked_prompts` with the prefix cache off, then on.
    The tokens must be bitwise equal, the cache must hit with no verify
    failure and save prefill-chunk steps, and ``cim_linear`` and
    ``paged_decode_mx`` must launch (and no other kernel)."""
    from repro_torch import obs as obs_lib
    from repro_torch.serving import Engine, EngineConfig

    prompts = _chunked_prompts(cfg.vocab_size)
    runs = {}
    _zero_counts()
    for cached in (False, True):
        obs = obs_lib.Obs()
        eng = Engine(params, cfg, dataclasses.replace(ctx, obs=obs),
                     EngineConfig(**CHUNK_ECFG, prefix_cache=cached), obs=obs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rids = [eng.add_request(p, max_new=CHUNK_TOKENS) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunks = [e.wall_s for e in obs.steps if e.kind == "prefill"]
        decodes = [e.wall_s for e in obs.steps if e.kind == "decode"]
        ttft = obs.request_summary()["ttft_s"]
        n_tok = sum(len(v) for v in out.values())
        runs[cached] = {"tokens": [out[r] for r in rids], "line": {
            "backend": "cim", "layers": cfg.n_layers, "prefix_cache": cached,
            "requests": len(out), "tokens": n_tok, "wall_s": wall,
            "tok_s": n_tok / wall, "prefill_chunk_steps": len(chunks),
            "chunk_step_ms_p50": float(np.median(chunks)) * 1e3,
            "decode_steps": len(decodes),
            "decode_step_ms_p50": float(np.median(decodes)) * 1e3,
            "ttft_ms_p50": ttft["p50"] * 1e3, "ttft_ms_p99": ttft["p99"] * 1e3,
            "prefix": eng.prefix_stats(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}}
        print("serve chunked", json.dumps(runs[cached]["line"]), flush=True)
        del eng
    launches, _ = _read_counts()
    cim_routes = _cim_routes()
    print("serve chunked launches", json.dumps(
        {"launches": launches, "cim_linear_routes": cim_routes}), flush=True)
    off, on = runs[False], runs[True]
    stats = on["line"]["prefix"]
    if on["tokens"] != off["tokens"]:
        raise AssertionError("[cim chunked] prefix cache on and off give "
                             "other tokens")
    if not stats["hits"] or stats["verify_failures"]:
        raise AssertionError(f"[cim chunked] prefix stats {stats}")
    if on["line"]["prefill_chunk_steps"] >= off["line"]["prefill_chunk_steps"]:
        raise AssertionError("[cim chunked] the prefix cache saved no chunk")
    if (not launches["cim_linear"] or not launches["paged_decode_mx"]
            or any(launches[k] for k in ("mxfp4_matmul", "paged_decode",
                                         "flash_attention"))):
        raise AssertionError(f"[cim chunked] launches {launches}")
    for v in on["tokens"]:
        if len(v) != CHUNK_TOKENS or not all(0 <= t < cfg.vocab_size
                                             for t in v):
            raise AssertionError("[cim chunked] served tokens")
    return {"launches": launches, "off": off["line"], "on": on["line"]}


def _load_line(mode: str, rep: dict, slo: dict, launches: dict,
               graphs: dict | None = None) -> dict:
    """The ``serve load`` line of one replay (host wall clock, ms)."""
    def ms(key, q):
        return (rep[key] or {}).get(q, 0) * 1e3

    return {"mode": mode, "requests": rep["n_requests"],
            "tokens": rep["tokens_generated"], "wall_s": rep["wall_s"],
            "tok_s_wall": rep["tokens_per_s_wall"],
            "ttft_ms_p50": ms("ttft_s", "p50"),
            "ttft_ms_p99": ms("ttft_s", "p99"),
            "token_ms_p50": ms("token_latency_s", "p50"),
            "token_ms_p99": ms("token_latency_s", "p99"),
            "queue_wait_ms_p50": ms("queue_wait_s", "p50"),
            "queue_wait_ms_p99": ms("queue_wait_s", "p99"),
            "prefill_steps": rep["steps"]["prefill"],
            "decode_steps": rep["steps"]["decode"],
            "prefix_hits": rep["prefix"].get("hits"),
            "page_evictions": rep["page_evictions"],
            "slo_pass": slo["pass"], "slo_observed": slo["observed"],
            "launches": {k: v for k, v in launches.items() if v},
            "graphs": graphs}


def serve_load_replay(cfg, params, ctx) -> dict:
    """Phase 7's load replay: phase 4's model through the launcher's
    ``serve_load`` (``LOAD_ARGS``: Poisson arrivals, chunked prefill, the
    prefix cache; every step captured, warmed up on a throwaway request),
    writing its metrics under a temporary directory; then the same trace,
    saved and loaded again, through ``load.replay`` on an engine of the
    same config with ``cuda_graphs=False``, warmed up the same way. Each
    request's tokens must be bitwise equal between the two (lane
    isolation: admission order may differ), the Prometheus file must
    parse back to the registry's counters, ``kernel_calls_total`` must
    count every launch, and only ``cim_linear`` and ``paged_decode_mx``
    may launch. A ``serve load`` line a replay."""
    from repro_torch import obs as obs_lib
    from repro_torch.launch import serve
    from repro_torch.serving import Engine
    from repro_torch.serving import load as load_mod

    dev = params["embed"]["emb"].device
    lines, outs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        args = serve.build_parser().parse_args(
            SERVE_ARGS["cim"] + LOAD_ARGS
            + ["--metrics-out", f"{tmp}/metrics.json"])
        obs = obs_lib.Obs()
        _zero_counts()
        res = serve.serve_load(args, cfg, params,
                               dataclasses.replace(ctx, obs=obs), obs, dev)
        launches, _ = _read_counts()
        prom = obs_lib.parse_prometheus(Path(tmp, "metrics.prom").read_text())
        calls = 0.0
        for fam in obs.registry.families():
            if fam.kind != "counter":
                continue
            for key, child in fam.children.items():
                got = prom.get((fam.name, tuple((k, str(v)) for k, v in key)))
                if got != child.value:
                    raise AssertionError(f"[cim load] {fam.name}{key}: "
                                         f"{child.value} in the registry, "
                                         f"{got} in the Prometheus file")
                if fam.name == "kernel_calls_total":
                    calls += child.value
        if calls != sum(launches.values()):
            raise AssertionError(f"[cim load] kernel_calls_total {calls}, "
                                 f"launches {launches}")
        lines["captured"] = _load_line("captured", res["report"], res["slo"],
                                       launches, res["graphs"])
        outs["captured"] = res["out"]
        load_mod.save_trace(f"{tmp}/trace.json", res["trace"])
        trace = load_mod.load_trace(f"{tmp}/trace.json")
    if trace != res["trace"]:
        raise AssertionError("[cim load] the trace did not round-trip")
    obs = obs_lib.Obs()
    eng = Engine(params, cfg, dataclasses.replace(ctx, obs=obs),
                 dataclasses.replace(res["ecfg"], cuda_graphs=False), obs=obs)
    eng.add_request(list(trace[0].prompt), max_new=2)  # serve_load's warm-up
    eng.run()
    obs.reset()
    _zero_counts()
    rep = load_mod.replay(eng, trace)
    eager_launches, _ = _read_counts()
    targets = obs_lib.SLOTargets(ttft_p99_s=args.slo_ttft_ms / 1e3,
                                 token_p99_s=args.slo_token_ms / 1e3)
    lines["eager"] = _load_line(
        "eager", load_mod.load_report(eng, wall_s=rep["wall_s"]),
        obs_lib.evaluate_slo(obs.finished, targets), eager_launches)
    outs["eager"] = rep["out"]
    del eng
    for mode in ("captured", "eager"):
        print("serve load", json.dumps(lines[mode]), flush=True)
    if outs["captured"] != outs["eager"]:
        diff = [r for r in outs["eager"]
                if outs["captured"].get(r) != outs["eager"][r]]
        raise AssertionError(f"[cim load] requests {diff}: captured and "
                             "eager replays gave other tokens")
    for mode, line in lines.items():
        if (set(line["launches"]) != {"cim_linear", "paged_decode_mx"}
                or line["requests"] != len(trace)):
            raise AssertionError(f"[cim load] {mode}: {line}")
        for v in outs[mode].values():
            if not v or not all(0 <= t < cfg.vocab_size for t in v):
                raise AssertionError("[cim load] served tokens")
    return {"launches": launches, "lines": lines}


def check_vit_linears(dev) -> tuple[list, list]:
    """``cim_linear`` and ``mxfp4_matmul`` at ViT-B/16's shapes
    (``VIT_CIM_SHAPES``, ``VIT_MM_SHAPES``): the trunk at a frame's 197
    rows, the patch embedding's f32 x at 196 rows and the classifier's
    CLS row at N = 1000; each row against its plain version, as in
    phase 3."""
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.layers import backends

    gen = torch.Generator(device=dev).manual_seed(8)
    cfg = cimlib.CIMConfig()
    cim_rows, mm_rows = [], []
    for m, k, n in VIT_CIM_SHAPES:
        w = mxlib.quantize_w(torch.randn((k, n), generator=gen, device=dev)
                             * k ** -0.5)
        x = torch.randn((m, k), generator=gen, device=dev).to(
            torch.bfloat16).float()
        cim_rows.append(_cim_row(x, w, cimlib.calibrate_rowhist([x], w, cfg),
                                 cfg, {"case": "vit-b16"}))
    for m, k, n, dtype in VIT_MM_SHAPES:
        packed = backends._quantize_packed(
            torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        w_bf16 = backends._dequant_packed(packed["codes"], packed["exps"])
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        mm_rows.append(_mxfp4_row(x, packed["codes"], packed["exps"], w_bf16,
                                  {"case": "vit-b16"}))
    return cim_rows, mm_rows


def _vit_routes(cfg, backend: str) -> dict:
    """Launches by route that one frame of ``cfg`` must make: the patch
    embedding (f32 x), six linears a layer at a frame's rows and the
    classifier over the CLS row, each on the route its picker takes."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops

    s, d, f = cfg.seq_len, cfg.d_model, cfg.d_ff
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = ([(cfg.n_patches, cfg.patch_dim, d, f32)]
              + cfg.n_layers * [(s, d, d, bf16)] * 4
              + cfg.n_layers * [(s, d, f, bf16), (s, f, d, bf16)]
              + [(1, d, cfg.n_classes, bf16)])
    routes: dict = {}
    for m, k, n, dtype in shapes:
        r = (cim_ops.pick_route(m, k, n) if backend == "cim"
             else mm_ops.pick_route(m, k, n, dtype))
        routes[r] = routes.get(r, 0) + 1
    return routes


def check_tiny_vit_agreement(dev, backend: str) -> None:
    """``tiny_vit`` with the same weights on the card (kernels) and on
    the CPU (plain versions): logits SQNR >= 30 dB."""
    from repro_torch import configs as C
    from repro_torch.launch import serve
    from repro_torch.models import vit

    args = serve.build_parser().parse_args(
        ["--arch", "vit-b16", "--backend", backend, "--device", "cpu",
         "--log-level", "warning"])
    cfg = C.tiny_vit(C.VIT_B16)
    cpu = torch.device("cpu")
    with torch.no_grad():
        fparams = vit.init_model(cfg, torch.Generator().manual_seed(0))
        params, ctx = serve.build_backend(
            args, cfg, fparams, cpu, forward_fn=vit.forward,
            batches=vit.calibration_images(cfg, device=cpu))
        images = vit.calibration_images(cfg, 1, 2, seed=4, device=cpu)[0]
        runs = [vit.forward(p, cfg, ctx, {"images": images["images"].to(d)}
                            )[0].float().cpu()
                for p, d in ((params, cpu), (_to(params, dev), dev))]
    sq = _sqnr_db(*runs)
    print(f"tiny_vit [{backend}], card vs CPU plain versions, logits SQNR "
          f"{sq} dB", flush=True)
    if sq < 30.0:
        raise AssertionError(f"tiny_vit [{backend}]: card and CPU logits "
                             "disagree")


def serve_vision_full(arch: str, backend: str) -> dict:
    """Phase 8, one run: ``arch`` at full width and depth through the
    launcher's ``build_vision_model`` and ``serve_vision``,
    ``VISION_FRAMES`` single-stream frames (vit-l32: the two-chip chain,
    12+12 layers, on the one card). Only the backend's matmul kernel may
    launch, on exactly the routes ``_vit_routes`` gives a frame. Then
    logits of ``VISION_CHECK_FRAMES`` frames against ``impl="ref"``
    (SQNR >= 30 dB), the chain against the monolithic forward (bitwise,
    vit-l32) and one frame under the profiler."""
    from repro_torch import obs as obs_lib
    from repro_torch.launch import serve
    from repro_torch.models import vit
    from repro_torch.serving import VisionEngine

    args = serve.build_parser().parse_args(
        ["--arch", arch, "--backend", backend] + VISION_ARGS)
    obs = obs_lib.Obs()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, ctx, dev = serve.build_vision_model(args, obs=obs)
    build_s = time.perf_counter() - t0
    print(f"[{backend}] {cfg.name}: full width and depth (image "
          f"{cfg.image_size}, patch {cfg.patch_size}, {cfg.seq_len} tokens, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}, d_ff {cfg.d_ff}, {cfg.n_classes} classes, "
          f"{cfg.chips} chip(s))", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    summary = serve.serve_vision(args, cfg, params, ctx, obs, dev)
    launches, mm_routes = _read_counts()
    routes = _cim_routes() if backend == "cim" else mm_routes
    peak = torch.cuda.max_memory_allocated()
    kernel = VISION_KERNEL[backend]
    want = {r: VISION_FRAMES * n for r, n in _vit_routes(cfg, backend).items()}
    if (launches[kernel] != sum(want.values())
            or any(v for k, v in launches.items() if k != kernel)
            or {r: n for r, n in routes.items() if n} != want):
        raise AssertionError(f"[{backend} {arch}] launches {launches}, "
                             f"routes {routes}; want only {kernel} on {want}")
    if summary["frames"] != VISION_FRAMES or not all(
            0 <= t < cfg.n_classes for t in summary["top1"]):
        raise AssertionError(f"[{backend} {arch}] served frames {summary}")
    t1 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(21)
    frames = torch.randn((VISION_CHECK_FRAMES, cfg.image_size,
                          cfg.image_size, cfg.in_channels), generator=gen,
                         device=dev)
    ref_ctx = dataclasses.replace(ctx, impl="ref", obs=None)
    with torch.no_grad():
        got = torch.cat([vit.forward(params, cfg, ctx, {"images": f[None]})[0]
                         for f in frames]).float()
        ref = torch.cat([vit.forward(params, cfg, ref_ctx,
                                     {"images": f[None]})[0]
                         for f in frames]).float()
    sq = _sqnr_db(ref, got)
    finite = bool(torch.isfinite(got).all())
    print(f"[{backend} {arch}] logits of {VISION_CHECK_FRAMES} frames, "
          f"kernels vs impl=ref: SQNR {sq} dB, finite {finite}, bitwise "
          f"{bool(torch.equal(got, ref))}", flush=True)
    if not finite or sq < 30.0:
        raise AssertionError(f"[{backend} {arch}] logits disagree")
    chain_bitwise = None
    if cfg.chips > 1:  # the eager chain over a batch of two frames
        eng = VisionEngine(params, cfg, dataclasses.replace(ctx, obs=None),
                           cuda_graphs=False)
        with torch.no_grad():
            mono, _ = vit.forward(params, cfg, ctx, {"images": frames[:2]})
        chain_bitwise = bool(torch.equal(eng.logits(frames[:2]), mono))
        print(f"[{backend} {arch}] {cfg.chips}-chip chain vs monolithic "
              f"forward: bitwise {chain_bitwise}", flush=True)
        if not chain_bitwise:
            raise AssertionError(f"[{backend} {arch}] the chip chain is not "
                                 "the monolithic forward")
    check_s = time.perf_counter() - t1
    prof = profile_frames(cfg, params, ctx, arch)
    fws = summary["fws"]
    cap = prof["captured"]
    line = {"model": cfg.name, "backend": backend, "chips": cfg.chips,
            "layers": cfg.n_layers, "tokens_each": cfg.seq_len,
            "frames": summary["frames"], "fps_host": summary["fps_host"],
            "frame_ms_p50": summary["frame_ms_p50"],
            "profiled_frame_wall_ms": cap["wall_ms_per_step"],
            "device_ms_a_frame": cap["device_ms_per_step"],
            "device_busy_share": cap["device_busy_share"],
            "route_ms_a_frame": cap["route_ms_per_step"],
            "timer": cap["timer"], "frame": _step_pair(prof),
            "launches": launches,
            "routes": routes, "peak_mem_gib": peak / 2**30,
            "model_build_s": build_s, "logits_sqnr_db": sq,
            "chain_bitwise": chain_bitwise, "logits_check_s": check_s,
            # the analytical model of the MXFormer chip, not this card
            "fws_model": {k: fws.get(k) for k in (
                "fws_model_fps", "paper_fps", "err_pct", "chips",
                "frame_latency_us")}}
    print("serve vision", json.dumps(line), flush=True)
    if fws.get("err_pct") is None or fws["err_pct"] >= 5.0:
        raise AssertionError(f"[{backend} {arch}] FWS model {fws}")
    return {"launches": launches, "line": line}


def profile_frames(cfg, params, ctx, arch: str) -> dict:
    """``WINDOW_FRAMES`` single-stream frames under ``torch.profiler``,
    eager (``cuda_graphs=False``) and captured (the first frame, outside
    the window, captures the chain): device time, wall time and busy
    share a frame, ``fps_host`` of the window, the capture's seconds and
    the graphs' pool bytes (summed over the chain). The window's logits
    must be bitwise equal between the two."""
    from repro_torch.serving import VisionEngine

    gen = torch.Generator(device=params["pos"].device).manual_seed(22)
    frames = torch.randn((WINDOW_FRAMES, cfg.image_size, cfg.image_size,
                          cfg.in_channels), generator=gen,
                         device=params["pos"].device)
    out, logits = {}, {}
    for mode in ("eager", "captured"):
        eng = VisionEngine(params, cfg, dataclasses.replace(ctx, obs=None),
                           cuda_graphs=mode == "captured")
        eng.classify_frame(frames[0])  # warm (and capture), not profiled
        nxt = itertools.cycle(frames)
        # one window each: every 8-frame window has traced a matmul
        # launch or two fewer than counted, whatever the attempt (scaled,
        # and ``timer`` says so)
        prof = _profiled(f"frame profile {arch} {mode}", ctx, WINDOW_FRAMES,
                         lambda: eng.classify_frame(next(nxt)), attempts=1)
        _unprofiled(prof, WINDOW_FRAMES, lambda: eng.classify_frame(next(nxt)),
                    1)
        if eng.graphs:
            chain = [g for c in eng.graphs.values() for g in c]
            prof["capture_s"] = sum(g.capture_s for g in chain)
            prof["graph_pool_bytes"] = sum(g.pool_bytes for g in chain)
        logits[mode] = torch.stack([eng.logits(f[None])[0] for f in frames])
        out[mode] = prof
        del eng
    if not torch.equal(logits["eager"], logits["captured"]):
        raise AssertionError(f"[{ctx.quant} {arch}] captured frame logits "
                             "are not the eager ones")
    print("frame eager vs captured", json.dumps(
        {"backend": ctx.quant, "model": cfg.name, "frames": WINDOW_FRAMES,
         "logits_bitwise": True} | _step_pair(out)), flush=True)
    return out


def check_dense_kernels(dev) -> dict:
    """Phase 9's kernel rows, each against its plain version as in phase
    3: ``paged_decode_mx`` and ``paged_decode`` at each arch's decode shape
    (page 448, lengths 0, 1, W/2, W), ``flash_attention`` at its [1, 384]
    prefill shape in bf16 (the fma route) and, at head_dim 256, in f32;
    ``cim_linear`` and ``mxfp4_matmul`` at its linear shapes at M = 4 and
    M = 384. Rows by kernel name; each names its arch (``case``)."""
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.layers import backends

    rows: dict = {name: [] for name in _kernel_wrappers()}
    gen = torch.Generator(device=dev).manual_seed(9)
    cfg = cimlib.CIMConfig()
    for arch, (dims, fa, linears) in DENSE_SHAPES.items():
        extra, pages = {"case": arch}, ((DENSE_PAGE, DENSE_LENGTHS),)
        rows["paged_decode_mx"] += check_paged_decode(dev, dims, pages, extra)
        rows["paged_decode"] += check_paged_decode_float(dev, dims, pages,
                                                         extra)
        b, s, h, hkv, d, window = fa
        for dtype in ((torch.bfloat16, torch.float32) if d == 256
                      else (torch.bfloat16,)):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, s, h, d), (b, s, hkv, d),
                                     (b, s, hkv, d)))
            rows["flash_attention"].append(
                extra | _flash_attention_row(q, k, v, window, 0))
            print("flash_attention", json.dumps(rows["flash_attention"][-1]),
                  flush=True)
            if not rows["flash_attention"][-1]["ok"]:
                raise AssertionError(f"flash_attention kernel disagrees at "
                                     f"{rows['flash_attention'][-1]}")
        for kk, n in linears:
            w = mxlib.quantize_w(torch.randn((kk, n), generator=gen,
                                             device=dev) * kk ** -0.5)
            packed = backends._quantize_packed(
                torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5)
            w_bf16 = backends._dequant_packed(packed["codes"], packed["exps"])
            for m in (4, DENSE_PROMPT):
                x = torch.randn((m, kk), generator=gen, device=dev).to(
                    torch.bfloat16)
                rows["cim_linear"].append(_cim_row(
                    x.float(), w, cimlib.calibrate_rowhist([x.float()], w, cfg),
                    cfg, extra))
                rows["mxfp4_matmul"].append(_mxfp4_row(
                    x, packed["codes"], packed["exps"], w_bf16, extra))
            del w, packed, w_bf16
    return rows


def _dense_launches(cfg, backend: str, prefills: int, decodes: int,
                    prefill_len: int, lanes: int, attn_max: int, min_n: int):
    """Launches by kernel and the matmul kernel's launches by route that
    ``prefills`` [1, prefill_len] prefills (the layers' linears at
    prefill_len rows, an untied head at the last row) and ``decodes``
    [lanes, 1] decode steps of ``cfg`` make: a linear is the kernel's where
    the conversion packs it (K % 32 == 0, N >= ``min_n``); one paged decode
    a layer a step, and, under mxfp4 past ``attn_max``, one
    ``flash_attention`` a layer a prefill (under cim the digital SDPA is
    torch ops)."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops

    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    layer = ([(d, cfg.n_heads * hd)] + [(d, cfg.n_kv_heads * hd)] * 2
             + [(cfg.n_heads * hd, d), (d, f)]
             + [(d, f)] * (cfg.ffn_kind in ("swiglu", "geglu")) + [(f, d)])
    head = [] if cfg.tie_embeddings else [(d, cfg.vocab_size)]
    body = layer * cfg.n_layers
    routes: dict = {}
    for m, times, shapes in ((prefill_len, prefills, body), (1, prefills, head),
                             (lanes, decodes, body + head)):
        for k, n in shapes:
            if k % 32 or n < min_n:
                continue
            r = (cim_ops.pick_route(m, k, n) if backend == "cim"
                 else mm_ops.pick_route(m, k, n, torch.bfloat16))
            routes[r] = routes.get(r, 0) + times
    launches = dict.fromkeys(_kernel_wrappers(), 0)
    launches[VISION_KERNEL[backend]] = sum(routes.values())
    launches["paged_decode_mx" if backend == "cim" else "paged_decode"] = (
        decodes * cfg.n_layers)
    fa_routes = dict.fromkeys(fa_ops.ROUTES, 0)
    if backend != "cim" and prefill_len > attn_max:
        launches["flash_attention"] = prefills * cfg.n_layers
        fa_routes[fa_ops.pick_route(prefill_len, prefill_len, hd,
                                    torch.bfloat16)] = prefills * cfg.n_layers
    return launches, routes, fa_routes


@contextlib.contextmanager
def _chunked_ref_decode():
    """``impl="ref"`` with the paged decode's chunked plain versions in
    place of the dense whole-axis ``ragged_paged_decode_ref``: the function
    the kernels (and the Pallas ones) compute. Under the digital SDPA the
    dense function quantizes P over the whole key axis against the final
    max, the chunked one per chunk against the running max: another
    function, about 6 dB apart in the logits of a random-weight model at
    page 448 (on the CPU, plain versions both)."""
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import ref as pref

    dense = pref.ragged_paged_decode_ref

    def chunked(q, rows, lengths, *, kv=None, quant=None, scale: float):
        if kv is not None:
            return pref.paged_flash_decode_ref(
                q, kv, rows, lengths, scale=scale, bk=pops.pick_bk(kv.shape[1]))
        return pref.paged_flash_decode_mx_ref(
            q, quant["kv_codes"], quant["k_exps"], quant["v_exps"], rows,
            lengths, scale=scale, bk=pops.pick_bk(quant["kv_codes"].shape[1]))

    pref.ragged_paged_decode_ref = chunked
    try:
        yield
    finally:
        pref.ragged_paged_decode_ref = dense


def _dense_prefill(cfg, params, ctx, ids):
    """Logits (all rows) and the fused page of a ``DENSE_PROMPT``-token
    prefill."""
    from repro_torch.models import lm

    caches = lm.init_cache(cfg, 1, DENSE_PAGE, fused=True, device=ids.device,
                           mx_digital=ctx.hybrid_digital_sdpa)
    with torch.no_grad():
        lo, caches = lm.forward(params, cfg, ctx,
                                {"ids": ids[:, :DENSE_PROMPT]}, caches=caches)
    return lo.float(), caches


def _dense_decode(cfg, params, ctx, ids, caches) -> list:
    """Logits of ``DENSE_STEPS`` teacher-forced decode steps after
    :func:`_dense_prefill`, on a copy of its page."""
    from repro_torch.models import lm

    caches = [[{k: v.clone() for k, v in layer.items()} for layer in seg]
              for seg in caches]
    out = []
    with torch.no_grad():
        for p in range(DENSE_PROMPT, DENSE_PROMPT + DENSE_STEPS):
            lo, caches = lm.decode_step(params, cfg, ctx, ids[:, p:p + 1], p,
                                        caches)
            out.append(lo.float())
    return out


def serve_dense(arch: str, backend: str) -> dict:
    """Phase 9, one run: ``arch`` at full width, and at full depth unless
    ``DENSE_LAYERS`` cuts it, through the launcher's ``build_model`` and
    ``serve_trace`` (``DENSE_ARGS``), decode captured. The
    launches by kernel and route must be exactly ``_dense_launches``'s for
    the serve's prefills and decode steps. Then logits of a 384-token
    prefill and 4 decode steps against ``impl="ref"`` with the chunked
    plain decode (SQNR >= 30 dB; the dense ``impl="ref"`` figure is
    printed beside it), each request served alone giving its first
    ``SOLO_TOKENS`` staggered tokens bitwise, the tied head's time
    (gemma3-1b), one prefill under the profiler and 8 decode steps under
    it eager and captured (tokens bitwise between the two)."""
    from repro_torch import obs as obs_lib
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import Engine

    from repro_torch import configs as C

    layers = DENSE_LAYERS.get(arch, 0)
    args = serve.build_parser().parse_args(
        ["--arch", arch, "--backend", backend, "--layers", str(layers)]
        + DENSE_ARGS)
    obs = obs_lib.Obs()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, ctx, dev = serve.build_model(args, obs=obs)
    build_s = time.perf_counter() - t0
    resident = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[{backend}] {cfg.name}: full width, {cfg.n_layers} of "
          f"{C.ARCHS[arch].n_layers} layers (d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/"
          f"{cfg.n_kv_heads}, head_dim {cfg.hd}, d_ff {cfg.d_ff} "
          f"{cfg.ffn_kind}, vocab {cfg.vocab_size}, segments "
          f"{[(s.n, s.attn.window) for s in lm.build_segments(cfg)]})",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    summary = serve.serve_trace(args, cfg, params, ctx, obs, dev)
    launches, mm_routes = _read_counts()
    routes = _cim_routes() if backend == "cim" else mm_routes
    fa_routes = dict(fa_ops.flash_attention.route_launches)
    peak = torch.cuda.max_memory_allocated()
    ecfg = summary["ecfg"]
    want, want_routes, want_fa = _dense_launches(
        cfg, backend, len(summary["out"]), summary["decode_steps"],
        ecfg.prefill_len, ecfg.lanes, ctx.dense_attn_max, args.cim_min_n)
    exact = (launches == want and fa_routes == want_fa
             and {r: n for r, n in routes.items() if n} == want_routes)
    for v in summary["out"].values():
        if len(v) != DENSE_TOKENS or not all(0 <= t < cfg.vocab_size
                                              for t in v):
            raise AssertionError(f"[{backend} {arch}] served tokens {v}")
    # logits: kernels vs impl="ref" with the chunked plain decode
    t1 = time.perf_counter()
    ids = torch.randint(0, cfg.vocab_size, (1, DENSE_PROMPT + DENSE_STEPS),
                        device=dev,
                        generator=torch.Generator(device=dev).manual_seed(14))
    kctx = dataclasses.replace(ctx, obs=None)
    rctx = dataclasses.replace(kctx, impl="ref")
    lo, caches = _dense_prefill(cfg, params, kctx, ids)
    got = [lo] + _dense_decode(cfg, params, kctx, ids, caches)
    lo, caches = _dense_prefill(cfg, params, rctx, ids)
    with _chunked_ref_decode():
        ref = [lo] + _dense_decode(cfg, params, rctx, ids, caches)
    dense = [lo] + _dense_decode(cfg, params, rctx, ids, caches)
    del lo, caches
    sq = [_sqnr_db(r, g) for r, g in zip(ref, got)]
    sq_dense = [_sqnr_db(r, g) for r, g in zip(dense, got)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    print(f"[{backend} {arch}] logits of a {DENSE_PROMPT}-token prefill and "
          f"{DENSE_STEPS} decode steps, kernels vs impl=ref (chunked plain "
          f"decode): SQNR {sq} dB; vs impl=ref (dense decode) {sq_dense} dB;"
          f" finite {finite}", flush=True)
    del got, ref, dense
    check_s = time.perf_counter() - t1
    # each request alone, through an engine of the serve's config: its
    # first SOLO_TOKENS greedy tokens, which a longer solo run repeats
    t1 = time.perf_counter()
    solo_diff = []
    for rid, prompt in summary["prompts"].items():
        eng = Engine(params, cfg, kctx, ecfg)
        first = summary["out"][rid][:SOLO_TOKENS]
        eng.add_request(prompt, max_new=len(first))
        if eng.run()[0] != first:
            solo_diff.append(rid)
    solo_s = time.perf_counter() - t1
    head = None
    if cfg.tie_embeddings:  # the tied head at a decode step's 4 rows
        x = torch.randn((4, 1, cfg.d_model), device=dev).to(torch.bfloat16)
        emb = params["embed"]["emb"]
        e32 = emb.float()  # what the float backend keeps resident
        head = {"emb_dtype": str(emb.dtype).split(".")[-1],
                "ms": _device_ms(lambda: lm._head(kctx, cfg, params, x), 20),
                "bound_ms": _bound_ms(emb.numel() * 2 + 4 * cfg.vocab_size * 2,
                                      2.0 * 4 * cfg.d_model * cfg.vocab_size,
                                      "bf16")[0],
                "f32_cast_ms": _device_ms(lambda: e32.to(torch.bfloat16), 5)}
        del e32
    # one profiler window each: in PR 20's runs every decode window traced
    # 3 matmul launches fewer than counted, whatever the attempt
    prof = {"prefill": profile_prefill(cfg, params, ctx, DENSE_PROMPT,
                                       DENSE_PAGE, attempts=1),
            "decode": profile_decode(cfg, params, ctx,
                                     prompt_len=DENSE_PROMPT // 3,
                                     page_len=DENSE_PAGE, attempts=1)}
    line = {"model": cfg.name, "backend": backend, "layers": cfg.n_layers,
            **{k: v for k, v in summary.items()
               if k not in serve.SUMMARY_DATA + ("prefix",)},
            "launches": launches, "routes": routes,
            "flash_attention_routes": fa_routes, "want_launches": want,
            "want_routes": want_routes, "launches_exact": exact,
            "logits_sqnr_db": sq, "logits_sqnr_vs_dense_ref_db": sq_dense,
            "staggered_equals_solo": not solo_diff, "solo_s": solo_s,
            "logits_check_s": check_s,
            "tied_head": head, "peak_mem_gib": peak / 2**30,
            "resident_params_gib": resident / 2**30,
            "model_build_s": build_s,
            "prefill_device_ms": prof["prefill"]["captured"][
                "device_ms_per_step"],
            "prefill_kernel_ms": prof["prefill"]["captured"][
                "kernel_ms_per_step"],
            "prefill": _step_pair(prof["prefill"]),
            "decode_device_ms": prof["decode"]["captured"][
                "device_ms_per_step"],
            "decode_kernel_ms": prof["decode"]["captured"][
                "kernel_ms_per_step"],
            "decode_busy_share": prof["decode"]["captured"][
                "device_busy_share"],
            "decode": _step_pair(prof["decode"])}
    print("serve dense", json.dumps(line), flush=True)
    if not exact:
        raise AssertionError(f"[{backend} {arch}] launches {launches} "
                             f"routes {routes} flash {fa_routes}; want "
                             f"{want} {want_routes} {want_fa}")
    if not finite or min(sq) < 30.0:
        raise AssertionError(f"[{backend} {arch}] logits disagree: {sq}")
    if solo_diff:
        raise AssertionError(f"[{backend} {arch}] requests {solo_diff}: "
                             "staggered tokens are not the solo ones")
    return {"launches": launches, "line": line}


def dense_kernel_entries(dense_rows: dict, runs: dict) -> list:
    """The kernels line's entries of phase 9: the decode and attention
    kernels at each arch's head width, each with its launches in the serve
    that ran it."""
    out = []
    for name, replaces, key, run in (
            ("paged_decode_mx",
             "src/repro/kernels/paged_attention/kernel.py:275", "dh", "cim"),
            ("paged_decode",
             "src/repro/kernels/paged_attention/kernel.py:228", "dh", "mxfp4"),
            ("flash_attention",
             "src/repro/kernels/flash_attention/kernel.py:90", "d", "mxfp4")):
        for arch, (dims, _, _) in DENSE_SHAPES.items():
            width = dims[3]
            row = next(r for r in dense_rows[name] if r[key] == width
                       and r["case"] == arch
                       and r.get("dtype", "bf16") == "bf16")
            shape = (f"L={row['lanes']} Hkv={row['hkv']} G={row['g']} "
                     f"Dh={width} W={row['w']} lengths {row['lengths']}"
                     if key == "dh" else
                     f"B={row['b']} S={row['sq']} H={row['h']} Hkv="
                     f"{row['hkv']} D={width} bf16 causal window "
                     f"{row['window']}")
            out.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": runs[f"dense {arch} {run}"]["launches"][name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms"),
                "call_ms": row["call_ms"], "kernel_route": row.get("route"),
                "shape": f"{shape} ({arch})"})
    return out


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


def _engine(params, cfg, ctx, prefill_len: int = M_PREFILL,
            page_len: int = 256, cuda_graphs: bool = True):
    from repro_torch.serving import Engine, EngineConfig

    return Engine(params, cfg, dataclasses.replace(ctx, obs=None),
                  EngineConfig(lanes=4, num_slots=4, page_len=page_len,
                               prefill_len=prefill_len,
                               cuda_graphs=cuda_graphs))


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


def _profiled(label: str, ctx, steps: int, step, prepare=None,
              attempts: int = PROFILE_ATTEMPTS) -> dict:
    """Run ``step`` ``steps`` times under ``torch.profiler``: device time by
    kernel (device events only) against the window's wall clock, and the
    launch counts of the window. A window whose trace holds another count
    of some wrapper's main kernel than the wrapper's counter says is run
    again (``prepare``, if given, readies each window outside it); after
    ``attempts`` such windows the last one's times of the short
    kernels are scaled to the counted launches, ``timer`` says so and a
    ``profile timer:`` line names them."""
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    for _ in range(attempts):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        _zero_counts()
        # the device's activity only: events of every CPU op add host time
        # to each eager step and to the processing of the trace
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        traced: dict = {}
        for ev in events:
            if any(_kernel_name(ev.key) in MAIN_KERNELS[w] for w in short):
                route = KERNEL_ROUTES.get(_kernel_name(ev.key), ev.key[:60])
                traced[route] = traced.get(route, 0) + ev.count
        print(f"profile timer: {label} [{ctx.quant}]: {attempts} "
              f"traces with other launch counts than the wrappers' "
              f"(traced, counted) {short}; traced by route {traced}, "
              f"counted {routes} (mxfp4_matmul) {_cim_routes()} "
              f"(cim_linear); the last one's times of those kernels "
              f"scaled to the counted launches", flush=True)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    by_wrapper: dict = {}
    for key, ms in by_name.items():
        wrapper = next((w for w, names in MAIN_KERNELS.items()
                        if _kernel_name(key) in names), None)
        if wrapper is not None:
            by_wrapper[wrapper] = by_wrapper.get(wrapper, 0.0) + ms
    by_route: dict = {}
    for key, ms in by_name.items():
        route = KERNEL_ROUTES.get(_kernel_name(key))
        if route is not None:
            by_route[route] = by_route.get(route, 0.0) + ms / steps
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": device_ms / steps if device_ms else None,
           "device_busy_share": device_ms / wall_ms if device_ms else None,
           "timer": timer,
           "top_kernels_ms_per_step": {k: v / steps for k, v in top},
           "kernel_ms_per_step": {k: v / steps for k, v in by_wrapper.items()},
           "route_ms_per_step": by_route,
           "launches": {k: v for k, v in launches.items() if v},
           "mxfp4_matmul_routes": routes,
           "profile_s": time.perf_counter() - t_start}
    print(label, json.dumps({"backend": ctx.quant} | out), flush=True)
    return out


def profile_prefill(cfg, params, ctx, prompt_len: int = M_PREFILL,
                    page_len: int = 256,
                    attempts: int = PROFILE_ATTEMPTS) -> dict:
    """One ``prompt_len``-token prefill through the engine (the request's
    first step) under ``torch.profiler``, run twice on the same prompt:
    eager (``cuda_graphs=False``) and captured (the default; a warm
    prefill outside the window captures the graph). Under ``mxfp4`` its
    linears must take the tensor-core route, under ``cim`` ``wgmma`` must
    run. The window's id must be bitwise equal between the two, and its
    launches by kernel and route the same. Each mode also times
    ``PREFILL_WALLS`` prefills without the profiler (``wall_ms``, the
    median; ``busy_share``). Returns ``{"eager": profile, "captured":
    profile + capture_s and graph_pool_bytes}`` and prints a ``prefill
    eager vs captured`` line."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    out, ids = {}, {}
    for mode in ("eager", "captured"):
        eng = _engine(params, cfg, ctx, prompt_len, page_len,
                      cuda_graphs=mode == "captured")
        rng = np.random.default_rng(9)
        eng.add_request(
            rng.integers(0, cfg.vocab_size, prompt_len // 3).tolist(),
            max_new=2)
        eng.step()  # a warm prefill outside the window (the capture)
        prompt = rng.integers(0, cfg.vocab_size, prompt_len).tolist()
        rids = []

        def prepare():  # finish what runs, then queue the window's prompt
            while eng.sched.running or eng.sched.waiting:
                eng.step()
            rids.append(eng.add_request(prompt, max_new=2))

        prof = _profiled(f"prefill profile {mode}", ctx, 1, eng.step,
                         prepare, attempts)
        prof["routes"] = {
            "mxfp4_matmul": prof["mxfp4_matmul_routes"],
            "cim_linear": _cim_routes(),
            "flash_attention": dict(fa_ops.flash_attention.route_launches)}
        if (ctx.quant == "mxfp4_wonly"
                and not prof["mxfp4_matmul_routes"]["wgmma"]):
            raise AssertionError("[mxfp4] the prefill did not take the wgmma "
                                 f"route: {prof['mxfp4_matmul_routes']}")
        if ctx.quant == "cim" and not _cim_routes()["wgmma"]:
            raise AssertionError("[cim] the prefill did not take the wgmma "
                                 f"route: {_cim_routes()}")
        ids[mode] = eng.requests[rids[-1]].out[0]
        walls = []
        for _ in range(PREFILL_WALLS):
            prepare()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()  # ends in the host read of the id
            walls.append(time.perf_counter() - t0)
        if any(eng.requests[r].out[0] != ids[mode] for r in rids):
            raise AssertionError(f"[{ctx.quant}] {mode} prefills of one "
                                 "prompt gave other ids")
        prof["wall_ms"] = float(np.median(walls)) * 1e3
        prof["busy_share"] = (prof["device_ms_per_step"] / prof["wall_ms"]
                              if prof["device_ms_per_step"] else None)
        graph = eng.graphs.get("prefill")
        if graph is not None:
            prof["capture_s"] = graph.capture_s
            prof["graph_pool_bytes"] = graph.pool_bytes
        out[mode] = prof
        del eng
    if ids["eager"] != ids["captured"]:
        raise AssertionError(f"[{ctx.quant}] prefill id eager {ids['eager']}"
                             f", captured {ids['captured']}")
    for key in ("launches", "routes"):
        if out["eager"][key] != out["captured"][key]:
            raise AssertionError(f"[{ctx.quant}] prefill {key}: eager "
                                 f"{out['eager'][key]}, captured "
                                 f"{out['captured'][key]}")
    print("prefill eager vs captured", json.dumps(
        {"backend": ctx.quant, "prompt_len": prompt_len, "id": ids["eager"],
         "id_bitwise": True, "launches": out["captured"]["launches"],
         "routes": out["captured"]["routes"]} | {
            mode: {"wall_ms": out[mode]["wall_ms"],
                   "device_ms": out[mode]["device_ms_per_step"],
                   "busy_share": out[mode]["busy_share"],
                   "capture_s": out[mode].get("capture_s"),
                   "pool_mib": (out[mode]["graph_pool_bytes"] / 2**20
                                if "graph_pool_bytes" in out[mode] else None),
                   "timer": out[mode]["timer"]}
            for mode in ("eager", "captured")}), flush=True)
    return out


def profile_decode(cfg, params, ctx, steps: int = 8, prompt_len: int = 128,
                   page_len: int = 256,
                   attempts: int = PROFILE_ATTEMPTS) -> dict:
    """A steady window of ``steps`` decode steps (4 live lanes, prompts of
    ``prompt_len`` tokens) under ``torch.profiler``, run twice on the same
    requests: eager (``cuda_graphs=False``) and captured (the default;
    the first decode step, outside the window, captures the graph). The
    requests outlast every window it may take. The tokens must be bitwise
    equal between the two, and the launch counts of each window the same
    (a replay counts what the captured step launches). Under ``mxfp4``
    the linears (M = 4) must take the mma route only. Returns ``{"eager":
    profile, "captured": profile + capture_s and graph_pool_bytes}``;
    each profile also times ``steps`` steps unprofiled (:func:`_unprofiled`:
    ``wall_ms``, ``busy_share``, ``tok_s``)."""
    out, tokens = {}, {}
    for mode in ("eager", "captured"):
        eng = _engine(params, cfg, ctx, max(M_PREFILL, prompt_len), page_len,
                      cuda_graphs=mode == "captured")
        rng = np.random.default_rng(5)
        for _ in range(4):
            eng.add_request(
                rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                max_new=(attempts + 1) * steps + 4)
        while len(eng.sched.running) < 4:  # the four prefills
            eng.step()
        eng.step()  # one decode step outside the window
        prof = _profiled(f"decode profile {mode}", ctx, steps, eng.step,
                         attempts=attempts)
        _unprofiled(prof, steps, eng.step, 4)
        routes = prof["mxfp4_matmul_routes"]
        if ctx.quant == "mxfp4_wonly" and (routes["wgmma"] or routes["fma"]
                                           or not routes["mma"]):
            raise AssertionError(f"[mxfp4] decode took the routes {routes}")
        cim_routes = _cim_routes()
        if ctx.quant == "cim" and (cim_routes["wgmma"]
                                   or not cim_routes["splitk"]):
            raise AssertionError(f"[cim] decode took the routes {cim_routes}")
        prof["launches_a_step"] = {k: v / steps
                                   for k, v in prof["launches"].items()}
        graph = eng.graphs.get("decode")
        if graph is not None:
            prof["capture_s"] = graph.capture_s
            prof["graph_pool_bytes"] = graph.pool_bytes
        tokens[mode] = [list(r.out) for r in eng.requests.values()]
        out[mode] = prof
        del eng
    n = min(len(t) for ts in tokens.values() for t in ts)
    if [t[:n] for t in tokens["eager"]] != [t[:n] for t in tokens["captured"]]:
        raise AssertionError(f"[{ctx.quant}] captured decode tokens are not "
                             "the eager ones")
    if out["eager"]["launches_a_step"] != out["captured"]["launches_a_step"]:
        raise AssertionError(f"[{ctx.quant}] launches a step: eager "
                             f"{out['eager']['launches_a_step']}, captured "
                             f"{out['captured']['launches_a_step']}")
    print("decode eager vs captured", json.dumps(
        {"backend": ctx.quant, "tokens_compared": n * len(tokens["eager"]),
         "tokens_bitwise": True} | _step_pair(out)), flush=True)
    return out


# the eager and captured figures a serve line carries
STEP_FIELDS = ("wall_ms", "device_ms_per_step", "busy_share", "tok_s",
               "fps_host", "wall_ms_per_step", "device_busy_share",
               "capture_s", "graph_pool_bytes", "timer")


def _unprofiled(prof: dict, steps: int, step, per_step: int) -> None:
    """Time ``steps`` more steps without the profiler (each ends in a host
    read): ``wall_ms`` a step, ``busy_share`` (the profiled window's
    device ms over it) and the rate, ``per_step`` tokens or frames a step
    (``tok_s`` for 4 lanes, ``fps_host`` for one frame). The profiler's
    own cost per traced kernel makes the profiled wall read high."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    prof["wall_ms"] = wall
    prof["busy_share"] = (prof["device_ms_per_step"] / wall
                          if prof["device_ms_per_step"] else None)
    prof["tok_s" if per_step > 1 else "fps_host"] = per_step * 1e3 / wall


def _step_pair(prof: dict) -> dict:
    """``{"eager": {...}, "captured": {...}}`` of a profile pair, each cut
    to ``STEP_FIELDS``."""
    return {mode: {k: prof[mode][k] for k in STEP_FIELDS if k in prof[mode]}
            for mode in ("eager", "captured")}


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
        gc.collect()  # the phase's engines, their graphs and pools
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
    vit_cim, vit_mm = phase("vit linears", check_vit_linears, dev)
    rows["cim_linear"] += vit_cim
    rows["mxfp4_matmul"] += vit_mm
    for backend in ("cim", "mxfp4"):
        phase(f"tiny {backend}", check_tiny_agreement, dev, backend)
        phase(f"tiny_vit {backend}", check_tiny_vit_agreement, dev, backend)
    # one backend's model at a time, served by the launcher (phases 4, 5)
    # and then chunked with the prefix cache and under load (cim, phase 7)
    # or with long prompts (mxfp4, phase 6); freed before the next
    runs = {}
    for backend, agains in (("cim", (("chunked", serve_chunked_prefix),
                                      ("load", serve_load_replay))),
                            ("mxfp4", (("long", serve_long),))):
        runs[backend], model = phase(f"serve {backend}", serve_full_width,
                                     backend)
        for name, again in agains:
            runs[name] = phase(f"serve {name} [{backend}]", again, *model)
        del model
    for arch, backend in VISION_RUNS:  # phase 8
        runs[f"vision {arch} {backend}"] = phase(
            f"serve vision {arch} [{backend}]", serve_vision_full, arch,
            backend)
    dense_rows = phase("dense kernels", check_dense_kernels, dev)  # phase 9
    for arch, backend in DENSE_RUNS:
        runs[f"dense {arch} {backend}"] = phase(
            f"serve {arch} [{backend}]", serve_dense, arch, backend)
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
    kernels += dense_kernel_entries(dense_rows, runs)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
